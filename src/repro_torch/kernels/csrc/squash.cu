// K10 squash: the standalone capsule squash over the last axis, and its VJP.
//
// Replaces src/repro/kernels/squash.py: _squash_kernel (forward) and
// _squash_bwd_kernel (the custom VJP's backward), both row-blocked over
// x [R, D] through _squash_call.
//
//   forward   v = q / (1 + q) * x * rsqrt(q + eps),  q = ||x||^2
//   backward  dx = f g + 2 f'(q) <g, x> x,  f = q / (1 + q) * rsqrt(q + eps)
//             (kernels/ref.py squash_vjp writes the formula out)
//
// A pure row reduction: each input byte is read once and each output
// byte written once, a few flops per float, so the bound is bytes
// (0.59 MB at the PrimaryCaps shape [8*1152, 8]: ~0.2 us at 3.35 TB/s).
// At that shape the launch itself, not the bytes, is the floor: an empty
// launch takes ~0.8 us.  An earlier design gave D <= 32 a thread a row
// and 256 rows a CTA -- 36 CTAs on 132 SMs -- and read each row twice.
// What this design does:
//   - `lanes` threads share a row (execplan.squash_lanes: a lane per four
//     floats, a power of two, at most a warp: 2 at D = 8, 32 at D = 160
//     and 256), each holding up to kMaxChunks chunks of four floats
//     (chunk lane + k * lanes) in registers: x (and g) is read once, as
//     float4 where D % 4 == 0 and every pointer is 16-byte aligned, else
//     as scalars; a warp reads one contiguous stretch of rows;
//   - q (and <g, x>) is summed in each lane's chunk order, then over the
//     row's lanes by an xor shuffle tree;
//   - a CTA takes `block_rows` rows (execplan.squash_block_rows: the most
//     rows, at most 256 threads, whose grid still gives every SM a CTA),
//     in passes of threads / lanes rows.
// Rows wider than lanes * kMaxChunks * 4 floats (past 1024 at a warp a
// row) take a loop that reads the row twice, the second time from L1.
// Ragged rows (past R) and any D are masked.

#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kWarp = 32;
constexpr int kMaxChunks = 8;   // chunks of four floats a lane holds

// Sum of v over the `lanes` lanes of a row (an aligned group of the warp).
template <int L>
__device__ inline float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This lane's K chunks of the row at p (D floats; D = 0 for a masked row)
// into registers, zeros past D.
template <int L, int K, bool kVec>
__device__ inline void load_chunks(const float* p, int D, int lane,
                                   float (&v)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = 4 * (lane + k * L);
    if constexpr (kVec) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d < D) t = __ldg(reinterpret_cast<const float4*>(p + d));
      v[k][0] = t.x;
      v[k][1] = t.y;
      v[k][2] = t.z;
      v[k][3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k][j] = d + j < D ? __ldg(p + d + j) : 0.f;
    }
  }
}

template <int L, int K, bool kVec>
__device__ inline void store_chunks(float* p, int D, int lane,
                                    const float (&v)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = 4 * (lane + k * L);
    if constexpr (kVec) {
      if (d < D)
        *reinterpret_cast<float4*>(p + d) =
            make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (d + j < D) p[d + j] = v[k][j];
    }
  }
}

// sum a * b over this lane's chunks, chunk by chunk.
template <int K>
__device__ inline float lane_dot(const float (&a)[K][4],
                                 const float (&b)[K][4]) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc = fmaf(a[k][j], b[k][j], acc);
  return acc;
}

// The CTA's rows [r0, r1) in passes of blockDim.x / lanes rows.  Every
// thread runs the same passes, so each shuffle sees its whole warp.
struct Rows {
  long long r0, r1;
  int per_pass;
};

__device__ inline Rows cta_rows(long long R, int block_rows, int lanes) {
  Rows w;
  w.r0 = (long long)blockIdx.x * block_rows;
  w.r1 = min(R, w.r0 + block_rows);
  w.per_pass = blockDim.x / lanes;
  return w;
}

template <int L, int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
squash_kernel(const float* __restrict__ x, float* __restrict__ out,
              long long R, int D, int block_rows) {
  const Rows w = cta_rows(R, block_rows, L);
  const int lane = threadIdx.x % L;
  for (int p = 0; p < block_rows; p += w.per_pass) {
    const long long r = w.r0 + p + threadIdx.x / L;
    const int dr = r < w.r1 ? D : 0;
    float v[K][4];
    load_chunks<L, K, kVec>(x + r * D, dr, lane, v);
    const float q = group_sum<L>(lane_dot<K>(v, v));
    const float a = q / (1.f + q);
    const float rs = rsqrtf(q + kSquashEps);
    // (a * x) * r, the reference's order of the two products.
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k][j] = a * v[k][j] * rs;
    store_chunks<L, K, kVec>(out + r * D, dr, lane, v);
  }
}

template <int L, int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
squash_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ dx, long long R, int D,
                  int block_rows) {
  const Rows w = cta_rows(R, block_rows, L);
  const int lane = threadIdx.x % L;
  for (int p = 0; p < block_rows; p += w.per_pass) {
    const long long r = w.r0 + p + threadIdx.x / L;
    const int dr = r < w.r1 ? D : 0;
    float xv[K][4], gv[K][4];
    load_chunks<L, K, kVec>(x + r * D, dr, lane, xv);
    load_chunks<L, K, kVec>(g + r * D, dr, lane, gv);
    const float q = group_sum<L>(lane_dot<K>(xv, xv));
    const float gs = group_sum<L>(lane_dot<K>(gv, xv));
    const float a = q / (1.f + q);
    const float rs = rsqrtf(q + kSquashEps);
    const float fq = a * rs;
    const float dfq = rs / ((1.f + q) * (1.f + q)) - 0.5f * a * rs * rs * rs;
    // dx = fq * g + (2 dfq gs) * x
    const float alpha = 2.f * dfq * gs;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        gv[k][j] = fmaf(alpha, xv[k][j], fq * gv[k][j]);
    store_chunks<L, K, kVec>(dx + r * D, dr, lane, gv);
  }
}

// Rows too wide for the registers: the same lanes and passes, each lane's
// share of the row summed in a loop and read again for the output.
__device__ inline float loop_dot(const float* a, const float* b, int D,
                                 int lane, int lanes) {
  float acc = 0.f;
  for (int d = lane; d < D; d += lanes) acc = fmaf(__ldg(a + d), __ldg(b + d),
                                                   acc);
  return acc;
}

__device__ inline float loop_group_sum(float v, int lanes) {
  for (int o = lanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
squash_loop_kernel(const float* __restrict__ x, float* __restrict__ out,
                   long long R, int D, int block_rows, int lanes) {
  const Rows w = cta_rows(R, block_rows, lanes);
  const int lane = threadIdx.x % lanes;
  for (int p = 0; p < block_rows; p += w.per_pass) {
    const long long r = w.r0 + p + threadIdx.x / lanes;
    const int dr = r < w.r1 ? D : 0;
    const float* xr = x + r * D;
    const float q = loop_group_sum(loop_dot(xr, xr, dr, lane, lanes), lanes);
    const float a = q / (1.f + q);
    const float rs = rsqrtf(q + kSquashEps);
    for (int d = lane; d < dr; d += lanes) out[r * D + d] = a * __ldg(xr + d)
                                                            * rs;
  }
}

__global__ void __launch_bounds__(kThreads)
squash_bwd_loop_kernel(const float* __restrict__ x,
                       const float* __restrict__ g, float* __restrict__ dx,
                       long long R, int D, int block_rows, int lanes) {
  const Rows w = cta_rows(R, block_rows, lanes);
  const int lane = threadIdx.x % lanes;
  for (int p = 0; p < block_rows; p += w.per_pass) {
    const long long r = w.r0 + p + threadIdx.x / lanes;
    const int dr = r < w.r1 ? D : 0;
    const float* xr = x + r * D;
    const float* gr = g + r * D;
    const float q = loop_group_sum(loop_dot(xr, xr, dr, lane, lanes), lanes);
    const float gs = loop_group_sum(loop_dot(gr, xr, dr, lane, lanes),
                                    lanes);
    const float a = q / (1.f + q);
    const float rs = rsqrtf(q + kSquashEps);
    const float fq = a * rs;
    const float dfq = rs / ((1.f + q) * (1.f + q)) - 0.5f * a * rs * rs * rs;
    const float alpha = 2.f * dfq * gs;
    for (int d = lane; d < dr; d += lanes)
      dx[r * D + d] = fmaf(alpha, __ldg(xr + d), fq * __ldg(gr + d));
  }
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Chunks of four floats each of `lanes` lanes holds for a row of D, rounded
// up to a power of two; 0 where the row needs more than kMaxChunks.
inline int chunks_per_lane(int D, int lanes) {
  const int need = ((D + 3) / 4 + lanes - 1) / lanes;
  for (int k = 1; k <= kMaxChunks; k *= 2)
    if (need <= k) return k;
  return 0;
}

// One launch of the register kernel F<L, K, kVec> (forward or backward) or,
// past kMaxChunks, of the loop kernel.
template <bool kBwd>
int launch(const float* x, const float* g, float* y, long long R, int D,
           int block_rows, int lanes, int threads, cudaStream_t s) {
  if (lanes < 1 || lanes > kWarp || (lanes & (lanes - 1)) ||
      threads % lanes || threads > kThreads)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((R + block_rows - 1) / block_rows);
  const bool vec = D % 4 == 0 && aligned16(x) && aligned16(y) &&
                   (!kBwd || aligned16(g));
  const int K = chunks_per_lane(D, lanes);
#define REPRO_SQUASH(L_, K_, V_)                                           \
  if (lanes == L_ && K == K_ && vec == V_) {                               \
    if constexpr (kBwd)                                                    \
      squash_bwd_kernel<L_, K_, V_><<<grid, threads, 0, s>>>(x, g, y, R, D, \
                                                             block_rows);  \
    else                                                                   \
      squash_kernel<L_, K_, V_><<<grid, threads, 0, s>>>(x, y, R, D,       \
                                                         block_rows);      \
    return (int)cudaGetLastError();                                        \
  }
#define REPRO_SQUASH_K(L_)                                                 \
  REPRO_SQUASH(L_, 1, true) REPRO_SQUASH(L_, 1, false)                     \
  REPRO_SQUASH(L_, 2, true) REPRO_SQUASH(L_, 2, false)                     \
  REPRO_SQUASH(L_, 4, true) REPRO_SQUASH(L_, 4, false)                     \
  REPRO_SQUASH(L_, 8, true) REPRO_SQUASH(L_, 8, false)
  REPRO_SQUASH_K(1) REPRO_SQUASH_K(2) REPRO_SQUASH_K(4)
  REPRO_SQUASH_K(8) REPRO_SQUASH_K(16) REPRO_SQUASH_K(32)
#undef REPRO_SQUASH_K
#undef REPRO_SQUASH
  if constexpr (kBwd)
    squash_bwd_loop_kernel<<<grid, threads, 0, s>>>(x, g, y, R, D,
                                                    block_rows, lanes);
  else
    squash_loop_kernel<<<grid, threads, 0, s>>>(x, y, R, D, block_rows,
                                                lanes);
  return (int)cudaGetLastError();
}

}  // namespace repro

// x [R, D] -> out [R, D]: ceil(R / block_rows) CTAs of `threads` threads,
// `lanes` a row (execplan.squash_grid).
REPRO_EXPORT int squash_f32(const float* x, float* out, long long R, int D,
                            int block_rows, int lanes, int threads,
                            void* stream) {
  return repro::launch<false>(x, nullptr, out, R, D, block_rows, lanes,
                              threads, (cudaStream_t)stream);
}

// x, g [R, D] -> dx [R, D], the VJP of squash at x for cotangent g.
REPRO_EXPORT int squash_bwd_f32(const float* x, const float* g, float* dx,
                                long long R, int D, int block_rows,
                                int lanes, int threads, void* stream) {
  return repro::launch<true>(x, g, dx, R, D, block_rows, lanes, threads,
                             (cudaStream_t)stream);
}
