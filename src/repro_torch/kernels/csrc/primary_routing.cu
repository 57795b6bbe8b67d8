// K5 primary_routing: the PrimaryCaps conv (im2col GEMM + bias + squash)
// and the votes + routing of the next layer in ONE kernel, one CTA per
// sample, with the inter-layer activation u kept in shared memory.
//
// Replaces src/repro/kernels/primary_routing.py: _produce_u with
// _pipe_resident_kernel / _pipe_streamed_kernel, dispatched through
// _pr_apply.
//
// Produce: the CTA computes its sample's P x N PrimaryCaps output
// (36 x 256 at MNIST) over K = KH*KW*Cin (20,736) in block_k slices of
// the sample's patches (written by K1) and of W_pc, both staged in shared
// memory.  Its 256 threads form 4 row lanes x 64 column lanes; each
// accumulates up to 16 rows x 4 columns in registers, so the producer
// takes P <= 64 and N <= 256 (execplan.PIPE_MAX_*).  Bias is added as u
// is written to shared memory ([P][N] row-major is exactly the capsule
// layout [I][C] with i = p*groups + g), then every capsule row is
// squashed in place.
// Consume: the votes + routing schedule of routing.cuh (resident or
// streamed, the plan's mode) reads u from shared memory, so neither u nor
// u_hat ever goes to global memory.  The producer's tiles and the
// consumer's votes rows share one region of shared memory.
//
// What bounds it on the H100: the producer does 2*36*20,736*256 = 382 M
// fp32 operations per sample (Conv1 is 16.6 M, the votes 2.9 M per
// pass), all on one SM, and each CTA reads all of W_pc (21,233,664 B)
// -- from L2 once the first CTA has pulled it in.  So this simple design
// is bound by one SM's fp32 rate per sample, with B of 132 SMs busy.
// Splitting the producer's K or N across a cluster of CTAs (and feeding
// it with TMA) is the lever of a later change.

#include "routing.cuh"

namespace repro {

constexpr int kRowLanes = 4;       // threads / kColLanes
constexpr int kColLanes = 64;
constexpr int kMaxRows = 16;       // rows per thread  -> P <= 64
constexpr int kMaxCols = 4;        // cols per thread  -> N <= 256

__global__ void __launch_bounds__(kThreads)
primary_routing_kernel(const float* __restrict__ patches,
                       const float* __restrict__ wpc,
                       const float* __restrict__ bias,
                       const float* __restrict__ W, float* __restrict__ out,
                       int P, int K, int N, int C, int J, int D, int iters,
                       int resident, int block_i, int block_k) {
  extern __shared__ float smem[];
  const int I = P * N / C;
  const int jd = J * D;
  float* u_s = smem;                                   // [P][N] == [I][C]
  RouteScratch sc = carve_route(u_s + I * C, I, J, jd);
  float* pt = sc.uh;                                   // [P][block_k]
  float* wt = pt + P * block_k;                        // [block_k][N]
  const int tn = threadIdx.x % kColLanes;
  const int tp = threadIdx.x / kColLanes;
  const float* pb = patches + (size_t)blockIdx.x * P * K;

  float acc[kMaxRows][kMaxCols];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
    for (int q = 0; q < kMaxCols; ++q) acc[r][q] = 0.f;

  for (int k0 = 0; k0 < K; k0 += block_k) {
    const int kb = min(block_k, K - k0);
    for (int e = threadIdx.x; e < P * block_k; e += blockDim.x) {
      const int p = e / block_k, kk = e % block_k;
      pt[e] = kk < kb ? pb[(size_t)p * K + k0 + kk] : 0.f;
    }
    for (int e = threadIdx.x; e < block_k * N; e += blockDim.x) {
      const int kk = e / N, n = e % N;
      wt[e] = kk < kb ? wpc[(size_t)(k0 + kk) * N + n] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kb; ++kk) {
      float w[kMaxCols];
#pragma unroll
      for (int q = 0; q < kMaxCols; ++q) {
        const int n = tn + kColLanes * q;
        w[q] = n < N ? wt[kk * N + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        const int p = tp + kRowLanes * r;
        if (p < P) {
          const float a = pt[p * block_k + kk];
#pragma unroll
          for (int q = 0; q < kMaxCols; ++q) acc[r][q] = fmaf(a, w[q], acc[r][q]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    const int p = tp + kRowLanes * r;
#pragma unroll
    for (int q = 0; q < kMaxCols; ++q) {
      const int n = tn + kColLanes * q;
      if (p < P && n < N) u_s[p * N + n] = acc[r][q] + bias[n];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < I; i += blockDim.x)
    squash_into(u_s + i * C, u_s + i * C, C);
  __syncthreads();
  route_sample(u_s, W, I, C, J, D, iters, resident ? kResident : kStreamed,
               block_i, sc, nullptr, out + (size_t)blockIdx.x * jd);
}

}  // namespace repro

// patches [B, P, K], W_pc [K, N], bias [N], W [I, J*D, C] -> v [B, J*D].
// smem_bytes is the plan's footprint (execplan.primary_routing_smem).
REPRO_EXPORT int primary_routing_f32(const float* patches, const float* wpc,
                                     const float* bias, const float* W,
                                     float* out, int B, int P, int K, int N,
                                     int C, int J, int D, int iters,
                                     int resident, int block_i, int block_k,
                                     int smem_bytes, void* stream) {
  if (P > repro::kRowLanes * repro::kMaxRows ||
      N > repro::kColLanes * repro::kMaxCols || N % C)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      repro::primary_routing_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  repro::primary_routing_kernel<<<B, repro::kThreads, smem_bytes,
                                  (cudaStream_t)stream>>>(
      patches, wpc, bias, W, out, P, K, N, C, J, D, iters, resident, block_i,
      block_k);
  return cudaGetLastError();
}
