// K16 RMSNorm: y = x * rsqrt(mean(x^2) + eps) * (1 + w), fp32 statistics,
// the output in x's type (fp32 or bf16); w is read as fp32.
//
// Replaces src/repro/kernels/rmsnorm.py: _rmsnorm_kernel, row-blocked over
// x [R, D] by the pallas_call of rmsnorm().  The reference halves its
// block_rows until it divides R, a TPU tiling device; here every row is
// independent and a ragged last CTA is masked instead.
//
// A pure row reduction: each byte of x is read once, each byte of y written
// once, w is read by every row (from L1/L2), and a few flops per element,
// so the bound is bytes (gemma2-9b's [4608, 3584] fp32: 132 MB, ~39 us at
// 3.35 TB/s).  What the design does about it: one pass over x.  A row
// group -- one warp for D <= 1024, the whole 256-thread CTA above -- loads
// its row into registers with 16-byte loads where the row's alignment
// allows (4 fp32 or 8 bf16 a load), sums the squares there, reduces them
// with warp shuffles (and shared memory across the CTA's warps), and
// writes y from the same registers.  Rows past R are masked.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace rms {

constexpr int kWarp = 32;
constexpr int kWarpMaxD = 1024;    // widest row one warp takes
constexpr int kMaxD = 8192;        // widest row the CTA-per-row form takes

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store_f(float* p, float x) { *p = x; }
__device__ inline void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// VEC consecutive elements at p, as one 16-byte load when VEC * sizeof(T)
// is 16, else one element.
template <typename T, int VEC>
__device__ inline void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f(__ldg(p + i));
  }
}

template <typename T, int VEC>
__device__ inline void store_vec(T* p, const float (&in)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) store_f(e + i, in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) store_f(p + i, in[i]);
  }
}

// LANES threads share a row (32: a warp; kThreads: the CTA); each holds up
// to CHUNKS groups of VEC elements, chunk c of lane l at element
// (l + c * LANES) * VEC, so neighbouring lanes read neighbouring addresses.
template <typename T, int LANES, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, long long R, int D, float eps) {
  constexpr int kLimit = LANES == kWarp ? kWarpMaxD : kMaxD;
  constexpr int CHUNKS = kLimit / (LANES * VEC);
  constexpr int kRowsPerCta = kThreads / LANES;
  __shared__ float partial[kThreads / kWarp];

  const long long row =
      (long long)blockIdx.x * kRowsPerCta + threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  // A whole warp (LANES = 32) or the whole CTA (one row) leaves together,
  // so the shuffles and barriers below see every thread they wait for.
  if (row >= R) return;
  const T* xr = x + row * D;
  const int nchunks = D / VEC;

  float v[CHUNKS][VEC];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int idx = lane + c * LANES;
    if (idx < nchunks) {
      load_vec<T, VEC>(xr + idx * VEC, v[c]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(v[c][i], v[c][i], ss);
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (LANES > kWarp) {
    if (lane % kWarp == 0) partial[lane / kWarp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < LANES / kWarp; ++i) ss += partial[i];
  }
  // mean(x^2) as the reference takes it: the sum over D, divided by D.
  const float inv = rsqrtf(ss / (float)D + eps);

  T* yr = y + row * D;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int idx = lane + c * LANES;
    if (idx < nchunks) {
      float wv[VEC], out[VEC];
      load_vec<float, VEC>(w + idx * VEC, wv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = (v[c][i] * inv) * (1.f + wv[i]);
      store_vec<T, VEC>(yr + idx * VEC, out);
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* y, long long R, int D,
           float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* yt = static_cast<T*>(y);
  if (D <= kWarpMaxD) {
    constexpr int rows = kThreads / kWarp;
    const long long grid = (R + rows - 1) / rows;
    rmsnorm_kernel<T, kWarp, VEC>
        <<<(unsigned)grid, kThreads, 0, stream>>>(xt, wt, yt, R, D, eps);
  } else {
    rmsnorm_kernel<T, kThreads, VEC>
        <<<(unsigned)R, kThreads, 0, stream>>>(xt, wt, yt, R, D, eps);
  }
  return cudaGetLastError();
}

}  // namespace rms
}  // namespace repro

// x [R, D] (dtype 0 fp32, 1 bf16), w [D] fp32 -> y [R, D] in x's type.
// vec16 != 0 when x, w, y and D allow 16-byte loads (the wrapper checks the
// alignment); D <= 8192.
REPRO_EXPORT int rmsnorm(int dtype, const void* x, const void* w, void* y,
                         long long R, int D, float eps, int vec16,
                         void* stream) {
  using namespace repro::rms;
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return vec16 ? launch<float, 4>(x, w, y, R, D, eps, s)
                 : launch<float, 1>(x, w, y, R, D, eps, s);
  if (dtype == 1)
    return vec16 ? launch<__nv_bfloat16, 8>(x, w, y, R, D, eps, s)
                 : launch<__nv_bfloat16, 1>(x, w, y, R, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
