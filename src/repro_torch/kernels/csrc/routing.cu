// K14b routing: every routing-by-agreement iteration over a u_hat that
// caps_votes.cu (K14a) wrote to device memory -- the split path's
// Sum+Squash and Update+Sum, u_hat [B, I, J*D] -> v [B, J*D].
//
// Replaces src/repro/kernels/routing.py: _routing_kernel, one grid step
// per sample, the sample's whole u_hat in VMEM (~0.8 MiB at MNIST width).
// Inference only: the reference applies no stop-gradient here, and the
// forward values do not depend on one.
//
// On Hopper one CTA takes one sample, as votes_routing.cu does, and runs
// the same fused s+b schedule (routing.cuh: iters + 1 passes, pass t
// folds the logits update of iteration t into the accumulation of s_t).
// One sample's u_hat (1152 x 160 fp32 = 737,280 B) is over the 232,448 B
// a CTA may hold, so the logits [I, J] (46,080 B), s and v stay in shared
// memory and u_hat streams from device memory on every pass, in tiles of
// block_i rows (execplan.plan_routing_split) copied with batches of
// float4 reads into rows padded to J*D + 1 floats.  The first pass reads
// u_hat from HBM (or from L2, where K14a just wrote it); the later passes
// from L2.
// What bounds it: with one CTA per sample only B SMs work (8 of 132 at
// serving batch 8), each limited by its own L2 bandwidth and by the
// per-row logits update; the function itself needs u_hat once (5.9 MB at
// batch 8).  Splitting i over a thread-block cluster is later work.

#include <stdint.h>

#include "routing.cuh"

namespace repro {

constexpr int kLoadBatch = 8;   // float4 loads a thread has in flight

// Copy `rows` rows of jd floats (contiguous at src) into dst, row pitch ld.
// Each thread starts kLoadBatch loads before it stores any: one L2 round
// trip per batch instead of one per float4.
__device__ inline void load_rows(const float* __restrict__ src, int rows,
                                 int jd, float* dst, int ld) {
  const int total = rows * jd;
  if (jd % 4 == 0 && (uintptr_t)src % 16 == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int total4 = total / 4;
    for (int f0 = threadIdx.x; f0 < total4; f0 += kLoadBatch * blockDim.x) {
      float4 v[kLoadBatch];
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int f = f0 + k * blockDim.x;
        if (f < total4) v[k] = __ldg(src4 + f);
      }
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int f = f0 + k * blockDim.x;
        if (f < total4) {
          const int r = 4 * f / jd, n = 4 * f - r * jd;  // never straddles
          float* d = dst + r * ld + n;
          d[0] = v[k].x;
          d[1] = v[k].y;
          d[2] = v[k].z;
          d[3] = v[k].w;
        }
      }
    }
  } else {
    for (int f = threadIdx.x; f < total; f += blockDim.x) {
      const int r = f / jd;
      dst[r * ld + (f - r * jd)] = __ldg(src + f);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
routing_kernel(const float* __restrict__ u_hat, float* __restrict__ out,
               int I, int J, int D, int iters, int block_i) {
  extern __shared__ float smem[];
  const int jd = J * D, ld = jd + 1;
  RouteScratch sc = carve_route(smem, I, J, jd);
  sc.c = sc.uh + block_i * ld;
  const float* uh = u_hat + (size_t)blockIdx.x * I * jd;
  for (int e = threadIdx.x; e < I * J; e += blockDim.x) sc.b[e] = 0.f;
  for (int t = 0; t <= iters; ++t) {
    for (int n = threadIdx.x; n < jd; n += blockDim.x) sc.s[n] = 0.f;
    for (int i0 = 0; i0 < I; i0 += block_i) {
      const int rows = min(block_i, I - i0);
      load_rows(uh + (size_t)i0 * jd, rows, jd, sc.uh, ld);
      __syncthreads();
      route_rows(sc.uh, ld, rows, sc.b + i0 * J, sc.c, sc.s, sc.v, t > 0, J,
                 D);                             // ends with __syncthreads
    }
    for (int j = threadIdx.x; j < J; j += blockDim.x)
      squash_into(sc.s + j * D, sc.v + j * D, D);
    __syncthreads();
  }
  for (int n = threadIdx.x; n < jd; n += blockDim.x)
    out[(size_t)blockIdx.x * jd + n] = sc.v[n];
}

}  // namespace repro

// u_hat [B, I, J*D] -> v [B, J*D].  smem_bytes is the plan's footprint
// (execplan.routing_split_smem).
REPRO_EXPORT int routing_f32(const float* u_hat, float* out, int B, int I,
                             int J, int D, int iters, int block_i,
                             int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      repro::routing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  repro::routing_kernel<<<B, repro::kThreads, smem_bytes,
                          (cudaStream_t)stream>>>(u_hat, out, I, J, D, iters,
                                                  block_i);
  return cudaGetLastError();
}
