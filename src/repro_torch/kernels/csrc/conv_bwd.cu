// K6 matmul_at_b and K7 col2im_patches: the convolution backward's dW and dx.
//
// Replaces src/repro/kernels/conv_im2col.py: _at_b_kernel (K6, through
// matmul_at_b) and _col2im_kernel / _col2im_block_kernel (K7, through
// col2im_patches), both called by _conv_core_bwd and by
// primary_routing.py's _pr_grad.
//
// K6 computes out[K, N] = A[M, K]^T B[M, N], the reduction over M.  It is
// bound by fp32 operations: at PrimaryCaps, batch 16, 2 * 576 * 20,736 *
// 256 = 6.1 GFLOP, 0.091 ms at 67 TFLOP/s.  The TPU kernel
// (conv_im2col.py:226 _at_b_kernel) walks M in blocks per output tile,
// adding each block's product to the tile.  K6 runs on the shared core of
// gemm_sm90.cuh, where 128 x 128 tiles and float4 shared-memory reads
// take 4 loads per 64 FMAs: A's and B's row slabs [m][k] and [m][n] are
// already the outer-product layout (A "M-major" there), so both stream
// through the 3-stage cp.async ring as float4 and no transpose is ever
// stored.  Each 16-row stage is summed apart and added to the tile, the
// TPU kernel's order, so kernel, twin and reference agree; the stage
// sums cost one add per 16 FMAs and 64 registers a thread, which hold the
// 128 x 128 tile to one CTA an SM.  The PrimaryCaps
// dW's 162 x 2 tiles of 128 x 128 make 2.45 waves of 132 CTAs, so
// planner.at_b_plan runs the rows of tiles that fill whole waves on
// 128 x 128 tiles and the rest on 128 x 64 tiles, half the work each, in
// a second launch: 2.5 waves' time instead of 3, with no partials.
// Where the output alone cannot fill the card (Conv1: [81, 256], 2 tiles,
// over a 6400-row reduction) the M axis is cut into splits of `rows`
// rows instead (a multiple of the 16-row step, none empty); each split
// writes its partial tile and a second pass sums the partials in split
// order, so the result is deterministic, which atomics would not make it.
// Conv1's rows (K = 81 floats) are not 16-byte aligned and load through
// 4-byte copies.

// K7 is the exact transpose of K1: dx[b, y, x, c] sums dp over every window
// tap (i, j) whose strided window covers (y, x).  The TPU's version
// scatter-adds tap slabs and relies on its sequential grid for the
// read-modify-write; here it is a gather, one thread per (b, y, x, c4) --
// four channels as a float4 where C is a multiple of 4 and both tensors
// are 16-byte aligned, else one channel as a float (a scalar instance of
// the same kernel) -- so every dp element is read once, no two threads
// write one address, and no atomics are needed.  A thread visits only the
// taps that cover its pixel: i = y - oy*s over oy from min(OH-1, y/s)
// down to the first window that still reaches y, likewise j over ox, with
// the dp address stepped by adds; its divisions are 32-bit, a few per
// element and none per tap, and the stride is a template argument for
// the configs' 1 and 2 (a runtime instance takes the others).  Taps are
// summed from 0.f in (i, j) ascending order, the plain twin's order, so
// kernel and twin agree bit for bit.  The grid is (x*c4 blocks, y, b):
// consecutive threads take consecutive channels, so each tap's dp reads
// and the dx writes are coalesced.  It is bound by bytes: at PrimaryCaps,
// batch 16, 47.8 MB of dp read and 6.6 MB of dx written, 0.016 ms at
// 3.35 TB/s.

#include <climits>

#include "gemm_sm90.cuh"

namespace repro {

// K6's tiles: 128 x 128 (planner.AT_B_TILE_K x AT_B_TILE_N), and
// 128 x 64 (AT_B_NARROW_N) for the rows past the plan's wide_rows.
constexpr int kAtbStep = 16;            // planner.AT_B_STEP
using AtbWide = gemm::Tile<8, 8, kAtbStep, gemm::kAMMajor>;
using AtbNarrow = gemm::Tile<8, 4, kAtbStep, gemm::kAMMajor>;

__device__ inline void add_to(float& acc, float v) { acc += v; }
__device__ inline void add_to(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// S is the stride where it is known at compile time, 0 where it is read
// from `stride`.  C counts V's.
template <int S, typename V>
__global__ void __launch_bounds__(kThreads)
col2im_kernel(const V* __restrict__ dp, V* __restrict__ dx, int H, int W,
              int C, int KH, int KW, int stride, int OH, int OW) {
  const int s = S > 0 ? S : stride;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * C) return;
  const int y = blockIdx.y, b = blockIdx.z;
  const int x = t / C, c = t - x * C;
  // The windows that cover (y, x): oy in [oy_lo, oy_hi], ox likewise.
  const int oy_hi = min(OH - 1, y / s), ox_hi = min(OW - 1, x / s);
  const int oy_lo = y < KH ? 0 : (y - KH) / s + 1;
  const int ox_lo = x < KW ? 0 : (x - KW) / s + 1;
  const int kv = KH * KW * C;               // a patch row
  const int tap_step = s * C - kv;          // ox - 1, j + s
  const V* row = dp + (size_t)b * OH * OW * kv + c +
                 (oy_hi * OW + ox_hi) * kv +
                 ((y - oy_hi * s) * KW + x - ox_hi * s) * C;
  V acc{};
  for (int oy = oy_hi; oy >= oy_lo; --oy) {  // i ascending
    const V* p = row;
#pragma unroll 4
    for (int ox = ox_hi; ox >= ox_lo; --ox) {  // j ascending
      add_to(acc, *p);
      p += tap_step;
    }
    row += s * KW * C - OW * kv;            // oy - 1, i + s
  }
  dx[((size_t)b * H + y) * W * C + t] = acc;
}

}  // namespace repro

// A [M, K], B [M, N] -> out [K, N] = A^T B.  With splits > 1 every
// 128 x 128 tile takes `splits` CTAs of `rows` consecutive rows of M (a
// multiple of the 16-row step, none empty) that write part ([splits, K,
// N]), which a second kernel sums into out in split order.  With one
// split the rows [0, wide_rows) of out (a multiple of 128) run on 128 x
// 128 tiles and the rest on 128 x 64 tiles, a second launch whose CTAs,
// half as long, even out the first one's last wave.
REPRO_EXPORT int matmul_at_b_f32(const float* A, const float* B, float* out,
                                 float* part, int M, int K, int N,
                                 int splits, int rows, int wide_rows,
                                 void* stream) {
  namespace g = repro::gemm;
  using repro::AtbNarrow;
  using repro::AtbWide;
  if (M < 1 || K < 1 || N < 1 || splits < 1 || rows < 1 ||
      rows % repro::kAtbStep || (long long)(splits - 1) * rows >= M ||
      (long long)splits * rows < M || wide_rows < 0 || wide_rows > K ||
      (wide_rows % AtbWide::BM && wide_rows != K) ||
      (splits > 1 && wide_rows != K))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec_b = N % 4 == 0 && g::aligned16(B);
  // The GEMM's (M, N, K) are (K, N, M): A is M-major with a row of K.
  cudaError_t err = cudaSuccess;
  if (wide_rows > 0) {
    const g::Problem p{A, B, wide_rows, N, M, K, AtbWide::BN, rows,
                       K % 4 == 0 && g::aligned16(A), vec_b};
    err = g::launch<8, 8, repro::kAtbStep, g::kAMMajor>(
        p, nullptr, out, part, splits, g::kNone, 0, s);
  }
  if (err != cudaSuccess || wide_rows == K) return err;
  const float* An = A + wide_rows;
  const g::Problem p{An, B, K - wide_rows, N, M, K, AtbNarrow::BN, rows,
                     K % 4 == 0 && g::aligned16(An), vec_b};
  return g::launch<8, 4, repro::kAtbStep, g::kAMMajor>(
      p, nullptr, out + (size_t)wide_rows * N, nullptr, 1, g::kNone, 0, s);
}

// Dynamic shared memory of the larger K6 CTA (planner.AT_B_SMEM_BYTES).
REPRO_EXPORT int matmul_at_b_smem_bytes() {
  return repro::AtbWide::smem_bytes(false);
}

// dp [B, OH*OW, KH*KW*C] -> dx [B, H, W, C]
REPRO_EXPORT int col2im_patches_f32(const float* dp, float* dx, int B, int H,
                                    int W, int C, int KH, int KW, int stride,
                                    void* stream) {
  if (B < 1 || C < 1 || KH < 1 || KW < 1 || stride < 1 || H < KH || W < KW)
    return cudaErrorInvalidValue;
  const int OH = (H - KH) / stride + 1, OW = (W - KW) / stride + 1;
  // Indices are 32-bit inside a sample; the grid's y and z hold H and B.
  if ((long long)OH * OW * KH * KW * C > INT_MAX ||
      (long long)H * W * C > INT_MAX || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = C % 4 == 0 && repro::gemm::aligned16(dp) &&
                   repro::gemm::aligned16(dx);
  const int cv = vec ? C / 4 : C;
  const dim3 grid((W * cv + repro::kThreads - 1) / repro::kThreads, H, B);
#define REPRO_COL2IM(S, V)                                                  \
  repro::col2im_kernel<S, V><<<grid, repro::kThreads, 0, st>>>(             \
      reinterpret_cast<const V*>(dp), reinterpret_cast<V*>(dx), H, W, cv,   \
      KH, KW, stride, OH, OW)
  if (vec) {
    if (stride == 1) REPRO_COL2IM(1, float4);
    else if (stride == 2) REPRO_COL2IM(2, float4);
    else REPRO_COL2IM(0, float4);
  } else {
    if (stride == 1) REPRO_COL2IM(1, float);
    else if (stride == 2) REPRO_COL2IM(2, float);
    else REPRO_COL2IM(0, float);
  }
#undef REPRO_COL2IM
  return cudaGetLastError();
}
