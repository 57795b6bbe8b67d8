// K1 im2col_patches and K2 matmul_bias_act: the convolutions as im2col GEMMs.
//
// Replaces src/repro/kernels/conv_im2col.py: _patches_kernel and
// _patches_block_kernel (K1, through im2col_patches), and conv_im2col.py:150
// _matmul_kernel (K2, through matmul_bias_act).
//
// K1 is a pure gather: it reads the image and writes the patch matrix
// [B, OH*OW, KH*KW*C] with (kh, kw, c)-major columns, so it is bound by
// the bytes it writes (the patches are KH*KW/stride^2 times the image).
// One thread per output element, consecutive threads on consecutive
// columns: the writes are coalesced and the reads walk C contiguous
// channels.  The TPU's block_p row blocking existed to bound VMEM and is
// dropped: nothing is staged on chip.
//
// K2 is bound by fp32 operations on the H100 (67 TFLOP/s outside the
// tensor cores): PrimaryCaps does 2 M 20,736 256 flops, 0.046 ms at MNIST
// batch 8.  The TPU kernel walks the whole K = 20,736 in one grid cell
// per output tile, which here would leave 6-10 CTAs on 132 SMs.  K2 runs
// on the shared core of gemm_sm90.cuh:
// 128 x 128 (or 64-wide) tiles fed by a 3-stage cp.async ring and read
// as float4, and a split of K across CTAs that the planner
// (planner.plan_matmul, split_k) picks so the grid fills the card:
// PrimaryCaps runs 6 tiles x 22 splits = 132 CTAs at MNIST batch 8, 8 x 33
// at SVHN's.  The splits write [split_k, M, N] partials that a second pass
// sums in split order before the bias and the epilogue (deterministic, no
// atomics; a last-arriving CTA would serialise 22 partial tiles on 6
// SMs).  With one split (Conv1's K = 81, the dpatches GEMM's K = 256,
// whose tile grids fill the card or whose K is short) the GEMM applies the
// epilogue itself.  The epilogues are none, ReLU and the per-capsule
// squash, which with one split stages the tile in shared memory so a
// capsule group of squash_dim columns is squashed by one thread (the plan
// keeps every group inside one tile), and with several takes a group per
// thread in the reduction pass.  Conv1's rows (K = 81 or 243 floats) are
// not 16-byte aligned and load through 4-byte copies.  Registers and
// shared memory of each build: the note of gemm_sm90.cuh.

#include "gemm_sm90.cuh"

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
// tile_bn (16 * TM, 16 * TN) and block_k select the build; tile_n <= tile_bn
// is the plan's output-tile width.  K is cut into split_k slabs of `slab`
// (a multiple of block_k, none empty); with split_k > 1, part is a
// [split_k, M, N] scratch for the partial tiles.
REPRO_EXPORT int matmul_bias_act_f32(const float* A, const float* Bw,
                                     const float* bias, float* out,
                                     float* part, int M, int N, int K,
                                     int block_m, int tile_bn, int tile_n,
                                     int block_k, int split_k, int slab,
                                     int epilogue, int squash_dim,
                                     void* stream) {
  namespace g = repro::gemm;
  if (M < 1 || N < 1 || K < 1 || tile_n < 1 || tile_n > tile_bn ||
      split_k < 1 || slab < 1 || slab % block_k ||
      (long long)(split_k - 1) * slab >= K || (long long)split_k * slab < K)
    return cudaErrorInvalidValue;
  if (epilogue == g::kSquash &&
      (squash_dim < 1 || tile_n % squash_dim || N % squash_dim))
    return cudaErrorInvalidValue;
  const g::Problem p{A, Bw, M, N, K, K, tile_n, slab,
                     K % 4 == 0 && g::aligned16(A),
                     N % 4 == 0 && tile_n % 4 == 0 && g::aligned16(Bw)};
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_GEMM(TM, TN, BK)                                              \
  if (block_m == 16 * TM && tile_bn == 16 * TN && block_k == BK)            \
    return g::launch<TM, TN, BK, g::kAKMem>(p, bias, out, part, split_k,    \
                                            epilogue, squash_dim, s);
  REPRO_GEMM(4, 4, 16) REPRO_GEMM(4, 8, 16) REPRO_GEMM(8, 4, 16)
  REPRO_GEMM(8, 8, 16)
#undef REPRO_GEMM
  return cudaErrorInvalidValue;
}

// Dynamic shared memory one matmul_bias_act CTA asks for at launch
// (planner.gemm_smem_bytes models it; a test holds the two equal).
REPRO_EXPORT int matmul_bias_act_smem_bytes(int block_m, int tile_bn,
                                            int block_k, int stage_output) {
#define REPRO_GEMM(TM, TN, BK)                                              \
  if (block_m == 16 * TM && tile_bn == 16 * TN && block_k == BK)            \
    return repro::gemm::Tile<TM, TN, BK,                                    \
                             repro::gemm::kAKMem>::smem_bytes(stage_output);
  REPRO_GEMM(4, 4, 16) REPRO_GEMM(4, 8, 16) REPRO_GEMM(8, 4, 16)
  REPRO_GEMM(8, 8, 16)
#undef REPRO_GEMM
  return -1;
}
