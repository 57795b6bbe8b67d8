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
// What the design does about it: the rows spread over the SMs, and
// neighbouring threads read neighbouring addresses.  A CTA takes
// `block_rows` consecutive rows (execplan.squash_block_rows: 256 or 8);
//   D <= 32  one row per thread, read as float4 where the row allows it:
//            a warp reads 32 consecutive rows, one contiguous stretch;
//   D >  32  one row per warp, lanes strided over D (float4 where the
//            row allows it) and a shuffle reduction of q (and <g, x>).
// The row is read twice, the second time from L1.  Ragged rows (past R)
// and any D are masked.

#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kWarp = 32;
constexpr int kThreadRowDim = 32;   // execplan.SQUASH_THREAD_ROW_DIM

__device__ inline bool vec4_row(const float* p, int D) {
  return (D % 4 == 0) && ((uintptr_t)p % 16 == 0);
}

// sum_d a[d] * b[d] over the lanes' share of one row (lane, lane + step..).
__device__ inline float row_dot(const float* a, const float* b, int D,
                                int lane, int step, bool vec) {
  float acc = 0.f;
  if (vec) {
    for (int d = 4 * lane; d < D; d += 4 * step) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(a + d));
      const float4 y = __ldg(reinterpret_cast<const float4*>(b + d));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  } else {
    for (int d = lane; d < D; d += step)
      acc = fmaf(__ldg(a + d), __ldg(b + d), acc);
  }
  return acc;
}

__device__ inline float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[d] = alpha * a[d] + beta * b[d] over the lanes' share of one row.
__device__ inline void row_axpby(float* out, float alpha, const float* a,
                                 float beta, const float* b, int D, int lane,
                                 int step, bool vec) {
  if (vec) {
    for (int d = 4 * lane; d < D; d += 4 * step) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(a + d));
      const float4 y = __ldg(reinterpret_cast<const float4*>(b + d));
      *reinterpret_cast<float4*>(out + d) = make_float4(
          fmaf(alpha, x.x, beta * y.x), fmaf(alpha, x.y, beta * y.y),
          fmaf(alpha, x.z, beta * y.z), fmaf(alpha, x.w, beta * y.w));
    }
  } else {
    for (int d = lane; d < D; d += step)
      out[d] = fmaf(alpha, __ldg(a + d), beta * __ldg(b + d));
  }
}

// The rows this thread (or this thread's warp) handles, and its lane.
struct RowWalk {
  long long first, stop, step;
  int lane, lanes;
};

__device__ inline RowWalk row_walk(long long R, int D, int block_rows) {
  RowWalk w;
  const long long r0 = (long long)blockIdx.x * block_rows;
  const long long r1 = min(R, r0 + block_rows);
  if (D <= kThreadRowDim) {
    w.first = r0 + threadIdx.x;
    w.step = blockDim.x;
    w.lane = 0;
    w.lanes = 1;
  } else {
    w.first = r0 + threadIdx.x / kWarp;
    w.step = blockDim.x / kWarp;
    w.lane = threadIdx.x % kWarp;
    w.lanes = kWarp;
  }
  w.stop = r1;
  return w;
}

__global__ void __launch_bounds__(kThreads)
squash_kernel(const float* __restrict__ x, float* __restrict__ out,
              long long R, int D, int block_rows) {
  const RowWalk w = row_walk(R, D, block_rows);
  // The warp-per-row loop runs the same trip count on every lane of a
  // warp, so the shuffles below see all 32 lanes.
  for (long long r = w.first; r < w.stop; r += w.step) {
    const float* xr = x + r * D;
    const bool vec = vec4_row(xr, D) && vec4_row(out + r * D, D);
    float q = row_dot(xr, xr, D, w.lane, w.lanes, vec);
    if (w.lanes > 1) q = warp_sum(q);
    const float a = q / (1.f + q);
    const float rs = rsqrtf(q + kSquashEps);
    // (a * x) * r, the reference's order of the two products.
    if (vec) {
      for (int d = 4 * w.lane; d < D; d += 4 * w.lanes) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xr + d));
        *reinterpret_cast<float4*>(out + r * D + d) =
            make_float4(a * v.x * rs, a * v.y * rs, a * v.z * rs,
                        a * v.w * rs);
      }
    } else {
      for (int d = w.lane; d < D; d += w.lanes)
        out[r * D + d] = a * __ldg(xr + d) * rs;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
squash_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ dx, long long R, int D, int block_rows) {
  const RowWalk w = row_walk(R, D, block_rows);
  for (long long r = w.first; r < w.stop; r += w.step) {
    const float* xr = x + r * D;
    const float* gr = g + r * D;
    const bool vec =
        vec4_row(xr, D) && vec4_row(gr, D) && vec4_row(dx + r * D, D);
    float q = row_dot(xr, xr, D, w.lane, w.lanes, vec);
    float gs = row_dot(gr, xr, D, w.lane, w.lanes, vec);
    if (w.lanes > 1) {
      q = warp_sum(q);
      gs = warp_sum(gs);
    }
    const float a = q / (1.f + q);
    const float rs = rsqrtf(q + kSquashEps);
    const float fq = a * rs;
    const float dfq = rs / ((1.f + q) * (1.f + q)) - 0.5f * a * rs * rs * rs;
    // dx = fq * g + (2 dfq gs) * x
    row_axpby(dx + r * D, 2.f * dfq * gs, xr, fq, gr, D, w.lane, w.lanes,
              vec);
  }
}

}  // namespace repro

// x [R, D] -> out [R, D]; block_rows rows per CTA.
REPRO_EXPORT int squash_f32(const float* x, float* out, long long R, int D,
                            int block_rows, void* stream) {
  const long long grid = (R + block_rows - 1) / block_rows;
  repro::squash_kernel<<<(unsigned)grid, repro::kThreads, 0,
                         (cudaStream_t)stream>>>(x, out, R, D, block_rows);
  return cudaGetLastError();
}

// x, g [R, D] -> dx [R, D], the VJP of squash at x for cotangent g.
REPRO_EXPORT int squash_bwd_f32(const float* x, const float* g, float* dx,
                                long long R, int D, int block_rows,
                                void* stream) {
  const long long grid = (R + block_rows - 1) / block_rows;
  repro::squash_bwd_kernel<<<(unsigned)grid, repro::kThreads, 0,
                             (cudaStream_t)stream>>>(x, g, dx, R, D,
                                                     block_rows);
  return cudaGetLastError();
}
