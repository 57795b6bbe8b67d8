// K3/K4 votes_routing: ClassCaps votes + every routing iteration, one CTA
// per sample, u_hat never written to global memory.
//
// Replaces src/repro/kernels/votes_routing.py: _resident_kernel (K3, with
// _votes_block and _routing_iterations) and _streamed_kernel (K4), both
// dispatched through _vr_apply.  One source holds both schedules; the
// plan's mode picks one (see routing.cuh for the schedule itself).
//
// On the TPU the whole batch shares one sequential grid.  On Hopper
// routing is independent per sample, so a CTA takes one sample: u
// (I*C floats), the logits (I*J), s and v (J*D each) stay in its shared
// memory.  Per MNIST sample that is 36,864 + 46,080 + 1,280 B; the votes
// of one sample (1152 x 160 fp32 = 737,280 B) do not fit a CTA, so the
// plan picks `streamed` at full width and W_cc (5,898,240 B) is read
// iters + 1 = 4 times per sample -- from the 50 MB L2 after the first
// CTA, not from HBM.  What bounds it: W traffic from L2 and the votes'
// fp32 FMAs (2.9 M per sample per pass), with only B CTAs in flight
// (8 of 132 SMs at serving batch 8).  `resident` (smoke widths) keeps
// the votes on chip and reads W once.  Splitting i over a thread-block
// cluster that reduces s through distributed shared memory, so that
// `resident` fits at full width and a sample uses several SMs, is later
// work.

#include "routing.cuh"

namespace repro {

__global__ void __launch_bounds__(kThreads)
votes_routing_kernel(const float* __restrict__ u, const float* __restrict__ W,
                     float* __restrict__ out, int I, int C, int J, int D,
                     int iters, int resident, int block_i) {
  extern __shared__ float smem[];
  const int jd = J * D;
  float* u_s = smem;                                   // [I][C]
  const float* ub = u + (size_t)blockIdx.x * I * C;
  for (int e = threadIdx.x; e < I * C; e += blockDim.x) u_s[e] = ub[e];
  RouteScratch sc = carve_route(u_s + I * C, I, J, jd);
  __syncthreads();
  route_sample(u_s, W, I, C, J, D, iters, resident != 0, block_i, sc,
               out + (size_t)blockIdx.x * jd);
}

}  // namespace repro

// u [B, I, C], W [I, J*D, C] -> v [B, J*D].  smem_bytes is the plan's
// footprint (execplan.votes_routing_smem).
REPRO_EXPORT int votes_routing_f32(const float* u, const float* W, float* out,
                                   int B, int I, int C, int J, int D,
                                   int iters, int resident, int block_i,
                                   int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      repro::votes_routing_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  repro::votes_routing_kernel<<<B, repro::kThreads, smem_bytes,
                                (cudaStream_t)stream>>>(
      u, W, out, I, C, J, D, iters, resident, block_i);
  return cudaGetLastError();
}
