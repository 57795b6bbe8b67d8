// K6 matmul_at_b and K7 col2im_patches: the convolution backward's dW and dx.
//
// Replaces src/repro/kernels/conv_im2col.py: _at_b_kernel (K6, through
// matmul_at_b) and _col2im_kernel / _col2im_block_kernel (K7, through
// col2im_patches), both called by _conv_core_bwd and by
// primary_routing.py's _pr_grad.
//
// K6 computes out[K, N] = A[M, K]^T B[M, N] with M the reduction, reading A
// row by row so no transpose of the patch matrix is ever stored.  A CTA of
// 256 threads owns a 64 x 64 output tile, each thread a 4 x 4 micro-tile in
// registers (IEEE fp32 FMA, no tensor cores); the reduction walks 16 rows of
// A and B at a time through shared memory, each row loaded with coalesced
// 256-byte reads.  It is bound by fp32 operations: at PrimaryCaps, batch 16,
// 2 * 576 * 20,736 * 256 = 6.1 GFLOP, 0.091 ms at 67 TFLOP/s.  There the
// output alone gives 324 x 4 CTAs.  At Conv1 the output is only [81, 256]
// (8 CTAs) over a 6400-long reduction, so the wrapper splits M across CTAs
// (planner.at_b_splits, about two CTAs per SM); each split writes its
// partial tile, and a second pass sums the partials in split order.  That
// keeps the result deterministic, which atomics would not.
//
// K7 is the exact transpose of K1: dx[b, y, x, c] sums dp over every window
// tap (i, j) whose strided window covers (y, x).  The TPU's version
// scatter-adds tap slabs and relies on its sequential grid for the
// read-modify-write; here it is a gather, one thread per dx element, so no
// two threads write one address and no atomics are needed.  Taps are summed
// in (i, j) order, as the plain twin adds them.  Consecutive threads take
// consecutive channels, so both the dp reads (C contiguous floats per tap)
// and the dx writes are coalesced.  It is bound by bytes: at PrimaryCaps,
// batch 16, 47.8 MB of dp read and 6.6 MB of dx written, 0.016 ms at
// 3.35 TB/s.

#include "common.cuh"

namespace repro {

constexpr int kAtbTile = 64;   // planner.AT_B_TILE
constexpr int kAtbStep = 16;   // planner.AT_B_STEP

__global__ void __launch_bounds__(kThreads)
at_b_kernel(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ part, int M, int K, int N, int rows) {
  __shared__ float As[kAtbStep][kAtbTile];   // [m][k]
  __shared__ float Bs[kAtbStep][kAtbTile];   // [m][n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * kAtbTile;
  const int k0 = blockIdx.y * kAtbTile;
  const int m_begin = blockIdx.z * rows;
  const int m_end = min(M, m_begin + rows);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += kAtbStep) {
    for (int e = threadIdx.x; e < kAtbStep * kAtbTile; e += kThreads) {
      const int r = e / kAtbTile, col = e % kAtbTile;
      const int m = m0 + r;
      const bool in = m < m_end;
      As[r][col] = (in && k0 + col < K) ? A[(size_t)m * K + k0 + col] : 0.f;
      Bs[r][col] = (in && n0 + col < N) ? B[(size_t)m * N + n0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kAtbStep; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.z * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (k < K && n < N) out[(size_t)k * N + n] = acc[i][j];
    }
  }
}

// out[e] = sum over splits z, in order, of part[z][e].
__global__ void __launch_bounds__(kThreads)
at_b_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                   long long kn, int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < kn; e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * kn + e];
    out[e] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
col2im_kernel(const float* __restrict__ dp, float* __restrict__ dx, int B,
              int H, int W, int C, int KH, int KW, int stride, int OH,
              int OW) {
  const long long total = (long long)B * H * W * C;
  const long long kc = (long long)KH * KW * C;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(e % C);
    const int x = (int)((e / C) % W);
    const int y = (int)((e / ((long long)C * W)) % H);
    const long long b = e / ((long long)C * W * H);
    float acc = 0.f;
    for (int i = 0; i < KH; ++i) {
      const int dy = y - i;
      if (dy < 0) break;
      if (dy % stride) continue;
      const int oy = dy / stride;
      if (oy >= OH) continue;
      for (int j = 0; j < KW; ++j) {
        const int dxp = x - j;
        if (dxp < 0) break;
        if (dxp % stride) continue;
        const int ox = dxp / stride;
        if (ox >= OW) continue;
        acc += dp[((b * OH + oy) * OW + ox) * kc + (i * KW + j) * C + c];
      }
    }
    dx[e] = acc;
  }
}

inline unsigned grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;     // grid-stride beyond
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace repro

// A [M, K], B [M, N] -> out [K, N] = A^T B.  With splits > 1 each split
// takes `rows` consecutive rows of M and writes part[split] ([splits, K,
// N] scratch); a second kernel sums them into out.  With splits == 1 the
// only split writes out directly.
REPRO_EXPORT int matmul_at_b_f32(const float* A, const float* B, float* out,
                                 float* part, int M, int K, int N,
                                 int splits, int rows, void* stream) {
  if (M < 1 || splits < 1 || (long long)splits * rows < M)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((N + repro::kAtbTile - 1) / repro::kAtbTile,
                  (K + repro::kAtbTile - 1) / repro::kAtbTile, splits);
  repro::at_b_kernel<<<grid, repro::kThreads, 0, s>>>(
      A, B, splits > 1 ? part : out, M, K, N, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long kn = (long long)K * N;
  repro::at_b_reduce_kernel<<<repro::grid_for(kn), repro::kThreads, 0, s>>>(
      part, out, kn, splits);
  return cudaGetLastError();
}

// dp [B, OH*OW, KH*KW*C] -> dx [B, H, W, C]
REPRO_EXPORT int col2im_patches_f32(const float* dp, float* dx, int B, int H,
                                    int W, int C, int KH, int KW, int stride,
                                    void* stream) {
  const int OH = (H - KH) / stride + 1, OW = (W - KW) / stride + 1;
  const long long total = (long long)B * H * W * C;
  repro::col2im_kernel<<<repro::grid_for(total), repro::kThreads, 0,
                         (cudaStream_t)stream>>>(dp, dx, B, H, W, C, KH, KW,
                                                 stride, OH, OW);
  return cudaGetLastError();
}
