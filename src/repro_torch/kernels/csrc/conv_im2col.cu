// K1 im2col_patches and K2 matmul_bias_act: the convolutions as im2col GEMMs.
//
// Replaces src/repro/kernels/conv_im2col.py: _patches_kernel and
// _patches_block_kernel (K1, through im2col_patches), and _matmul_kernel
// (K2, through matmul_bias_act).
//
// K1 is a pure gather: it reads the image and writes the patch matrix
// [B, OH*OW, KH*KW*C] with (kh, kw, c)-major columns, so it is bound by
// the bytes it writes (the patches are KH*KW/stride^2 times the image).
// One thread per output element, consecutive threads on consecutive
// columns: the writes are coalesced and the reads walk C contiguous
// channels.  The TPU's block_p row blocking existed to bound VMEM and is
// dropped: nothing is staged on chip.
//
// K2 is a shared-memory tiled SIMT GEMM in IEEE fp32 with FMA (no TF32,
// no tensor cores): a BM x BN output tile per CTA of 256 threads, each
// thread a TM x TN micro-tile (BM = 16 TM, BN = 16 TN; TM, TN in {2, 4, 8},
// picked by the plan), K walked in block_k slices staged in shared memory.
// On the H100 it is bound by fp32 operations: Conv1 does 2*M*81*256 flops
// on 81-deep dot products, PrimaryCaps 2*M*20736*256 with only
// ceil(M/BM) x ceil(N/BN) CTAs in flight (a handful at serving batch),
// so it runs far from the 67 TFLOP/s fp32 peak; splitting K across CTAs
// or tensor cores are the levers of a later change.  Ragged M/N/K edges
// are masked (zeros are loaded, nothing is stored), which matches the
// reference's K zero-padding.  The epilogue adds the bias and applies
// none / ReLU / per-capsule squash; the squash stages the tile in shared
// memory so a capsule group of squash_dim columns is squashed by one
// thread (the plan keeps every group inside one tile).

#include "common.cuh"

namespace repro {

__global__ void __launch_bounds__(kThreads)
im2col_kernel(const float* __restrict__ x, float* __restrict__ out, int B,
              int H, int W, int C, int KH, int KW, int stride, int OH,
              int OW) {
  const long long K = (long long)KH * KW * C;
  const long long P = (long long)OH * OW;
  const long long total = (long long)B * P * K;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long col = e % K;
    const long long row = (e / K) % P;
    const long long b = e / (K * P);
    const int kh = (int)(col / (KW * C));
    const int rem = (int)(col % (KW * C));
    const int kw = rem / C;
    const int c = rem % C;
    const int oy = (int)(row / OW);
    const int ox = (int)(row % OW);
    out[e] = x[((b * H + oy * stride + kh) * W + ox * stride + kw) * C + c];
  }
}

enum Epilogue { kNone = 0, kRelu = 1, kSquash = 2 };

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
matmul_bias_act_kernel(const float* __restrict__ A,
                       const float* __restrict__ Bw,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int M, int N, int K,
                       int tile_n, int block_k, int epilogue,
                       int squash_dim) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  extern __shared__ float smem[];
  float* As = smem;                        // [block_k][BM + 1], A transposed
  float* Bs = smem + block_k * (BM + 1);   // [block_k][BN]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * tile_n;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += block_k) {
    for (int e = threadIdx.x; e < BM * block_k; e += kThreads) {
      const int r = e / block_k, kk = e % block_k;
      const int m = m0 + r, k = k0 + kk;
      As[kk * (BM + 1) + r] = (m < M && k < K) ? A[(size_t)m * K + k] : 0.f;
    }
    for (int e = threadIdx.x; e < BN * block_k; e += kThreads) {
      const int kk = e / BN, c = e % BN;
      const int n = n0 + c, k = k0 + kk;
      Bs[kk * BN + c] =
          (c < tile_n && n < N && k < K) ? Bw[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < block_k; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk * (BM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (epilogue != kSquash) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + 16 * j, n = n0 + c;
        if (m < M && c < tile_n && n < N) {
          float v = acc[i][j] + bias[n];
          if (epilogue == kRelu) v = fmaxf(v, 0.f);
          out[(size_t)m * N + n] = v;
        }
      }
    }
    return;
  }
  // Squash: stage acc + bias in the tile region (free after the K loop's
  // last barrier), then one thread squashes one capsule group of a row.
  float* Cs = smem;                        // [BM][BN + 1]
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + 16 * j, n = n0 + c;
      Cs[(ty + 16 * i) * (BN + 1) + c] =
          acc[i][j] + ((c < tile_n && n < N) ? bias[n] : 0.f);
    }
  __syncthreads();
  const int groups = tile_n / squash_dim;
  for (int e = threadIdx.x; e < BM * groups; e += kThreads) {
    const int r = e / groups, g = e % groups;
    const int m = m0 + r, nb = n0 + g * squash_dim;
    if (m >= M || nb >= N) continue;
    squash_into(Cs + r * (BN + 1) + g * squash_dim,
                out + (size_t)m * N + nb, squash_dim);
  }
}

template <int TM, int TN>
cudaError_t launch_gemm(const float* A, const float* Bw, const float* bias,
                        float* out, int M, int N, int K, int tile_n,
                        int block_k, int epilogue, int squash_dim,
                        cudaStream_t stream) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  size_t tiles = (size_t)block_k * (BM + 1) + (size_t)block_k * BN;
  if (epilogue == kSquash && tiles < (size_t)BM * (BN + 1))
    tiles = (size_t)BM * (BN + 1);
  const int smem = (int)(tiles * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      matmul_bias_act_kernel<TM, TN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + tile_n - 1) / tile_n);
  matmul_bias_act_kernel<TM, TN><<<grid, kThreads, smem, stream>>>(
      A, Bw, bias, out, M, N, K, tile_n, block_k, epilogue, squash_dim);
  return cudaGetLastError();
}

}  // namespace repro

// x [B, H, W, C] -> patches [B, OH*OW, KH*KW*C]
REPRO_EXPORT int im2col_patches_f32(const float* x, float* out, int B, int H,
                                    int W, int C, int KH, int KW, int stride,
                                    void* stream) {
  const int OH = (H - KH) / stride + 1, OW = (W - KW) / stride + 1;
  const long long total = (long long)B * OH * OW * KH * KW * C;
  long long blocks = (total + repro::kThreads - 1) / repro::kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;     // grid-stride beyond
  if (blocks < 1) blocks = 1;
  repro::im2col_kernel<<<(unsigned)blocks, repro::kThreads, 0,
                         (cudaStream_t)stream>>>(x, out, B, H, W, C, KH, KW,
                                                 stride, OH, OW);
  return cudaGetLastError();
}

// epilogue(A [M, K] @ Bw [K, N] + bias [N]) -> out [M, N].  block_m and
// tile_bn (16 * TM, 16 * TN) select the build; tile_n <= tile_bn is the
// plan's output-tile width.
REPRO_EXPORT int matmul_bias_act_f32(const float* A, const float* Bw,
                                     const float* bias, float* out, int M,
                                     int N, int K, int block_m, int tile_bn,
                                     int tile_n, int block_k, int epilogue,
                                     int squash_dim, void* stream) {
  if (epilogue == repro::kSquash &&
      (squash_dim < 1 || tile_n % squash_dim || N % squash_dim))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_GEMM(TM, TN)                                                  \
  if (block_m == 16 * TM && tile_bn == 16 * TN)                             \
    return repro::launch_gemm<TM, TN>(A, Bw, bias, out, M, N, K, tile_n,    \
                                      block_k, epilogue, squash_dim, s);
  REPRO_GEMM(2, 2) REPRO_GEMM(2, 4) REPRO_GEMM(2, 8)
  REPRO_GEMM(4, 2) REPRO_GEMM(4, 4) REPRO_GEMM(4, 8)
  REPRO_GEMM(8, 2) REPRO_GEMM(8, 4) REPRO_GEMM(8, 8)
#undef REPRO_GEMM
  return cudaErrorInvalidValue;
}
