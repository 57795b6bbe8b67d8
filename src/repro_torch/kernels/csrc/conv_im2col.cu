// K1 im2col_patches and K2 matmul_bias_act: the convolutions as im2col GEMMs.
//
// Replaces src/repro/kernels/conv_im2col.py: _patches_kernel and
// _patches_block_kernel (K1, through im2col_patches), and conv_im2col.py:150
// _matmul_kernel (K2, through matmul_bias_act).
//
// K1 is a pure copy, bound by the bytes it moves: it reads the image and
// writes the patch matrix [B, OH*OW, KH*KW*C] with (kh, kw, c)-major
// columns, KH*KW/stride^2 times the image.  In NHWC a patch row (b, oy, ox)
// is KH contiguous segments of KW*C floats at both ends: (ox*s + kw, c)
// runs contiguously in the image.  The grid is (kh blocks, oy, b): no
// division finds a CTA's work.  A CTA copies the OW segments of each of
// its kh rows, each segment from stride*C floats further along the image
// row to one patch row further down; its threads walk the elements as
// (ox, kh, offset) triples advanced by adds with carries, so no element
// pays a division, and every index inside a CTA is 32-bit (the CTA's base
// pointers are 64-bit).  A CTA takes one kh row where that gives each
// thread a full round of loads (PrimaryCaps: 2304-float segments) and
// several where segments are short (Conv1's 9 floats: all 9 rows, so each
// patch row is written as one run).  Each thread issues its next 4 (or 8)
// loads before their stores, and the copy moves float4s where C is a
// multiple of 4 and both tensors are 16-byte aligned (then every segment
// offset is); otherwise a scalar instance of the same kernel moves floats
// (Conv1's C = 1 or 3, a view that starts off alignment).  The stores are
// plain write-back: K2 or K5 reads the patches straight back.  At MNIST
// PrimaryCaps, batch 8: 432 CTAs of 6 segments of 2304 floats, 3.28 MB
// read and 23.9 MB written, 0.0081 ms at 3.35 TB/s.  The TPU's block_p
// row blocking existed to bound VMEM and is dropped: nothing is staged on
// chip.
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

#include <climits>

#include "gemm_sm90.cuh"

namespace repro {

__host__ __device__ constexpr int copy_unroll(int vec_bytes) {
  return vec_bytes == 16 ? 4 : 8;
}

// One CTA copies the segments of kh rows [kh0, kh0 + nkh) of one (oy, b):
// element (o, k, q) -- ox, kh0 + k, offset -- moves from the image row
// oy*s + kh0 + k to patch row o.  With k inside o, a CTA that holds every
// kh writes each patch row as one contiguous run.  Each thread copies its
// elements U at a time: U loads in flight, then their stores.  C (and so
// every length below) counts V's.
template <typename V>
__global__ void __launch_bounds__(kThreads)
im2col_kernel(const V* __restrict__ x, V* __restrict__ out, int H, int W,
              int C, int KH, int KW, int stride, int OH, int OW,
              int kh_per_cta) {
  constexpr int U = copy_unroll(sizeof(V));
  const int kh0 = blockIdx.x * kh_per_cta, oy = blockIdx.y, b = blockIdx.z;
  const int nkh = min(kh_per_cta, KH - kh0);
  const int seg = KW * C;             // a segment: the row of one kh
  const int src_row = W * C;          // from one kh to the next, in the image
  const int src_step = stride * C;    // from one ox to the next
  const int dst_step = KH * seg;      // a patch row
  const V* src = x + ((size_t)b * H + oy * stride + kh0) * src_row;
  V* dst = out + ((size_t)b * OH + oy) * OW * dst_step + kh0 * seg;
  // The thread's first element and its stride, each as (o, k, q).
  int q = threadIdx.x % seg, k = threadIdx.x / seg, o = k / nkh;
  k -= o * nkh;
  const int step_q = blockDim.x % seg, step_k = blockDim.x / seg % nkh,
            step_o = blockDim.x / seg / nkh;
  while (o < OW) {
    V v[U];
    int d[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      d[u] = -1;
      if (o < OW) {
        v[u] = src[k * src_row + o * src_step + q];
        d[u] = o * dst_step + k * seg + q;
      }
      q += step_q;
      k += step_k;
      o += step_o;
      if (q >= seg) {
        q -= seg;
        ++k;
      }
      if (k >= nkh) {
        k -= nkh;
        ++o;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (d[u] >= 0) dst[d[u]] = v[u];
  }
}

}  // namespace repro

// x [B, H, W, C] -> patches [B, OH*OW, KH*KW*C]
REPRO_EXPORT int im2col_patches_f32(const float* x, float* out, int B, int H,
                                    int W, int C, int KH, int KW, int stride,
                                    void* stream) {
  if (B < 1 || C < 1 || KH < 1 || KW < 1 || stride < 1 || H < KH || W < KW)
    return cudaErrorInvalidValue;
  const int OH = (H - KH) / stride + 1, OW = (W - KW) / stride + 1;
  // Indices inside a CTA are 32-bit: a sample's image and one image row's
  // patch rows must fit them.  The grid's y and z hold OH and B.
  if ((long long)H * W * C > INT_MAX ||
      (long long)OW * KH * KW * C > INT_MAX || OH > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && repro::gemm::aligned16(x) &&
                   repro::gemm::aligned16(out);
  const int cv = vec ? C / 4 : C;
  // A CTA takes as many kh rows as give each thread one round of U
  // elements (short segments: Conv1), spread evenly over the CTAs.
  const int want = repro::kThreads * repro::copy_unroll(vec ? 16 : 4);
  const int per_kh = OW * KW * cv;             // V's of one kh row
  const int kh_want = (want + per_kh - 1) / per_kh;
  const int spread = kh_want >= KH ? 1 : (KH + kh_want - 1) / kh_want;
  const int kh_per_cta = (KH + spread - 1) / spread;
  const int ctas = (KH + kh_per_cta - 1) / kh_per_cta;   // none empty
  const dim3 grid(ctas, OH, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    repro::im2col_kernel<float4><<<grid, repro::kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
        H, W, cv, KH, KW, stride, OH, OW, kh_per_cta);
  else
    repro::im2col_kernel<float><<<grid, repro::kThreads, 0, s>>>(
        x, out, H, W, cv, KH, KW, stride, OH, OW, kh_per_cta);
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
