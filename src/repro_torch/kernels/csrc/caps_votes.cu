// K14a caps_votes: the split path's ClassCaps-FC, u_hat written to device
// memory.  u_hat[b, i, n] = sum_c W[i, n, c] * u[b, i, c].
//
// Replaces src/repro/kernels/caps_votes.py: _votes_kernel, one grid step
// per i-block of the sequential TPU grid.  It is the paper's baseline:
// the fused votes_routing (K3/K4) never writes u_hat, this kernel writes
// all of it (B * I * J*D floats) for routing.cu (K14b) to read back.
//
// What bounds it: bytes.  W (I * N * C floats, 5.9 MB at MNIST width) is
// reuse-free across CTAs -- each element serves only the batch -- and
// u_hat (B * I * N floats, 5.9 MB at batch 8) is written once: ~12 MB
// against 2 * B * C flops per u_hat element.  So the design spreads the
// I rows, not the batch, over the SMs (execplan.plan_caps_votes: about
// two CTAs per SM), and each CTA
//   1. stages its i-block's W rows [rows, N, C] into shared memory, each
//      (i, n) row padded to C + 1 floats, with batches of float4 reads of
//      global memory where they are aligned, and its u rows [B, rows, C];
//   2. gives each thread (i, n) pairs, consecutive n on neighbouring
//      threads: the padded W row is read without bank conflicts and the
//      u row is a broadcast; for every sample the thread writes
//      u_hat[b, i, n], so a warp writes 32 consecutive floats.
// The ragged last i-block is masked.  Forward only, as in the reference.

#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kLoadBatch = 8;   // float4 loads a thread has in flight

__global__ void __launch_bounds__(kThreads)
caps_votes_kernel(const float* __restrict__ u, const float* __restrict__ W,
                  float* __restrict__ out, int B, int I, int C, int N,
                  int block_i) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * block_i;
  const int rows = min(block_i, I - i0);
  const int ldw = C + 1;
  float* w_s = smem;                                  // [rows * N][C + 1]
  float* u_s = w_s + (size_t)block_i * N * ldw;       // [B][rows][C]

  // 1. Stage W rows (contiguous in global memory) and u rows.
  const float* wb = W + (size_t)i0 * N * C;
  const int total = rows * N * C;
  if (((N * C) % 4 == 0) && ((uintptr_t)W % 16 == 0)) {
    // kLoadBatch float4 loads in flight per thread before any store.
    const float4* w4 = reinterpret_cast<const float4*>(wb);
    const int total4 = total / 4;
    for (int f0 = threadIdx.x; f0 < total4; f0 += kLoadBatch * blockDim.x) {
      float4 v[kLoadBatch];
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int f = f0 + k * blockDim.x;
        if (f < total4) v[k] = __ldg(w4 + f);
      }
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int e = 4 * (f0 + k * blockDim.x);
        if (e < total) {
          // element e of row e / C lands at e + e / C (padded pitch C + 1)
          w_s[e + e / C] = v[k].x;
          w_s[e + 1 + (e + 1) / C] = v[k].y;
          w_s[e + 2 + (e + 2) / C] = v[k].z;
          w_s[e + 3 + (e + 3) / C] = v[k].w;
        }
      }
    }
  } else {
    for (int f = threadIdx.x; f < total; f += blockDim.x)
      w_s[f + f / C] = __ldg(wb + f);
  }
  const int urow = rows * C;                   // one sample's u rows
  for (int e = threadIdx.x; e < B * urow; e += blockDim.x) {
    const int b = e / urow, k = e - b * urow;
    u_s[e] = __ldg(u + ((size_t)b * I + i0) * C + k);
  }
  __syncthreads();

  // 2. One (i, n) pair per thread at a time, all samples.
  for (int e = threadIdx.x; e < rows * N; e += blockDim.x) {
    const int r = e / N, n = e - r * N;
    const float* wr = w_s + (size_t)e * ldw;
    float* o = out + ((size_t)(i0 + r)) * N + n;
    for (int b = 0; b < B; ++b) {
      const float* ur = u_s + (b * rows + r) * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc = fmaf(wr[c], ur[c], acc);
      o[(size_t)b * I * N] = acc;
    }
  }
}

}  // namespace repro

// u [B, I, C], W [I, N, C] -> u_hat [B, I, N].  smem_bytes is the plan's
// footprint (execplan.caps_votes_smem).
REPRO_EXPORT int caps_votes_f32(const float* u, const float* W, float* out,
                                int B, int I, int C, int N, int block_i,
                                int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      repro::caps_votes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  const int grid = (I + block_i - 1) / block_i;
  repro::caps_votes_kernel<<<grid, repro::kThreads, smem_bytes,
                             (cudaStream_t)stream>>>(u, W, out, B, I, C, N,
                                                     block_i);
  return cudaGetLastError();
}
