// K3/K4 votes_routing: ClassCaps votes + every routing iteration, one CTA
// per sample, u_hat never written to global memory; and K13, the unfused
// streamed schedule that is the fused pass's oracle.
//
// Replaces src/repro/kernels/votes_routing.py: _resident_kernel (K3, with
// _votes_block and _routing_iterations), _streamed_kernel (K4) and
// _streamed_2pass_kernel (K13), all dispatched through _vr_apply, each
// with the optional residual-add epilogue (r [B, J*D] added to the output
// just before the store: one coupling half of a ResCapsBlock).  One
// source holds every schedule; the plan's mode picks one (see routing.cuh
// for the schedule itself).
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
// (8 of 132 SMs at serving batch 8).  `resident` (smoke widths, and the
// SVHN ResCaps halves and ClassCaps) keeps the votes on chip and reads W
// once.  Where even the logits do not fit -- the SVHN bottleneck, 2048
// capsules routed to 64, 524 KB of logits per sample -- the plan's
// `streamed-global` mode keeps them in a per-sample slab of a global
// scratch (4.2 MB at batch 8, L2-resident) and runs the streamed
// schedule unchanged on it; there W (33.5 MB) is read 4 times per sample.
// Splitting i over a thread-block cluster that reduces s through
// distributed shared memory, so that a sample uses several SMs, is later
// work.

#include "routing.cuh"

namespace repro {

__global__ void __launch_bounds__(kThreads)
votes_routing_kernel(const float* __restrict__ u, const float* __restrict__ W,
                     const float* __restrict__ r, float* logits,
                     float* __restrict__ out, int I, int C, int J, int D,
                     int iters, int schedule, int block_i) {
  extern __shared__ float smem[];
  const int jd = J * D;
  float* u_s = smem;                                   // [I][C]
  const float* ub = u + (size_t)blockIdx.x * I * C;
  for (int e = threadIdx.x; e < I * C; e += blockDim.x) u_s[e] = ub[e];
  RouteScratch sc = carve_route(
      u_s + I * C, I, J, jd,
      logits ? logits + (size_t)blockIdx.x * I * J : nullptr);
  __syncthreads();
  route_sample(u_s, W, I, C, J, D, iters, schedule, block_i, sc,
               r ? r + (size_t)blockIdx.x * jd : nullptr,
               out + (size_t)blockIdx.x * jd);
}

cudaError_t launch_votes_routing(const float* u, const float* W,
                                 const float* r, float* logits, float* out,
                                 int B, int I, int C, int J, int D, int iters,
                                 int schedule, int block_i, int smem_bytes,
                                 cudaStream_t stream) {
  if (B < 1 || I < 1 || iters < 1 || block_i < 1 || block_i > I)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      votes_routing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  votes_routing_kernel<<<B, kThreads, smem_bytes, stream>>>(
      u, W, r, logits, out, I, C, J, D, iters, schedule, block_i);
  return cudaGetLastError();
}

}  // namespace repro

// u [B, I, C], W [I, J*D, C] -> out [B, J*D] = v (+ r [B, J*D] when r is
// not null).  smem_bytes is the plan's footprint
// (execplan.votes_routing_smem).
//
// K3 (resident != 0) / K4, the logits in shared memory.
REPRO_EXPORT int votes_routing_f32(const float* u, const float* W,
                                   const float* r, float* out, int B, int I,
                                   int C, int J, int D, int iters,
                                   int resident, int block_i, int smem_bytes,
                                   void* stream) {
  return repro::launch_votes_routing(
      u, W, r, nullptr, out, B, I, C, J, D, iters,
      resident ? repro::kResident : repro::kStreamed, block_i, smem_bytes,
      (cudaStream_t)stream);
}

// K4 in the plan's "streamed-global" mode: logits [B, I, J] is the scratch
// in global memory (written and read only by the kernel).
REPRO_EXPORT int votes_routing_global_f32(const float* u, const float* W,
                                          const float* r, float* logits,
                                          float* out, int B, int I, int C,
                                          int J, int D, int iters,
                                          int block_i, int smem_bytes,
                                          void* stream) {
  return repro::launch_votes_routing(u, W, r, logits, out, B, I, C, J, D,
                                     iters, repro::kStreamed, block_i,
                                     smem_bytes, (cudaStream_t)stream);
}

// K13, the unfused oracle: logits [B, I, J] in global memory, or null to
// keep them in shared memory (the placement of the schedule it checks).
REPRO_EXPORT int votes_routing_2pass_f32(const float* u, const float* W,
                                         const float* r, float* logits,
                                         float* out, int B, int I, int C,
                                         int J, int D, int iters, int block_i,
                                         int smem_bytes, void* stream) {
  return repro::launch_votes_routing(u, W, r, logits, out, B, I, C, J, D,
                                     iters, repro::kTwoPass, block_i,
                                     smem_bytes, (cudaStream_t)stream);
}
