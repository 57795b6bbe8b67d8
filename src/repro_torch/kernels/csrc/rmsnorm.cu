// K16 RMSNorm: y = x * rsqrt(mean(x^2) + eps) * (1 + w), fp32 statistics,
// the output in x's type (fp32 or bf16); w is read as fp32.
//
// Replaces src/repro/kernels/rmsnorm.py: _rmsnorm_kernel, row-blocked over
// x [R, D] by the pallas_call of rmsnorm().  The reference halves its
// block_rows until it divides R, a TPU tiling device; here every row is
// independent and a ragged last CTA is masked instead.
//
// A pure row reduction: each byte of x is read once, each byte of y written
// once, w is read by every row (from L1/L2), and a few flops per element.
// Two forms, chosen by the wrapper from D alone:
//
// * A warp a row, for D <= 1024: eight rows a 256-thread CTA; each lane
//   loads its share of the row into registers with 16-byte loads where the
//   row's alignment allows (4 fp32 or 8 bf16 a load), sums the squares
//   there, reduces them with warp shuffles, and writes y from the same
//   registers.  Rows past R are masked.
// * A CTA a row, for D > 1024 at every R (gemma2-9b's D = 3584: decode's
//   [4, 3584], 57 KB, where an empty launch outlasts the bytes twenty
//   times over, and prefill's [4608, 3584] fp32, 132 MB, ~39 us at
//   3.35 TB/s).  The row makes one memory round trip: every thread issues
//   all its loads of x AND w (at most two 16-byte vectors of each on the
//   16-byte path) before the sum, then a shuffle tree a warp, one barrier,
//   and one cross-warp step in which each warp sums the warps' partials
//   with a second shuffle tree.
//
// Sum order (both forms): each thread sums its elements' squares in order
// (fmaf), the warp xor-tree adds lane partials, the CTA adds warps' sums;
// rmsnorm_plain (torch.mean) sums in another order, within 2e-5.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace rms {

constexpr int kWarp = 32;
constexpr int kWarpMaxD = 1024;    // widest row one warp takes
constexpr int kMaxD = 8192;        // widest row a CTA takes

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store_f(float* p, float x) { *p = x; }
__device__ inline void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// VEC consecutive elements at p, as 16-byte loads when VEC * sizeof(T) is
// a multiple of 16 (w's 8 floats beside a bf16 vector: two), else one
// element at a time.
template <typename T, int VEC>
__device__ inline void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < VEC / kPer; ++q) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + q);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[q * kPer + i] = to_f(e[i]);
    }
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

// A warp a row, kThreads / 32 rows a CTA; each lane holds up to CHUNKS
// groups of VEC elements, chunk c of lane l at element (l + c * 32) * VEC,
// so neighbouring lanes read neighbouring addresses.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ y, long long R, int D, float eps) {
  constexpr int CHUNKS = kWarpMaxD / (kWarp * VEC);
  constexpr int kRowsPerCta = kThreads / kWarp;

  const long long row =
      (long long)blockIdx.x * kRowsPerCta + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // A whole warp leaves together, so its shuffles see every lane.
  if (row >= R) return;
  const T* xr = x + row * D;
  const int nchunks = D / VEC;

  float v[CHUNKS][VEC];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int idx = lane + c * kWarp;
    if (idx < nchunks) {
      load_vec<T, VEC>(xr + idx * VEC, v[c]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(v[c][i], v[c][i], ss);
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  // mean(x^2) as the reference takes it: the sum over D, divided by D.
  const float inv = rsqrtf(ss / (float)D + eps);

  T* yr = y + row * D;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int idx = lane + c * kWarp;
    if (idx < nchunks) {
      float wv[VEC], out[VEC];
      load_vec<float, VEC>(w + idx * VEC, wv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = (v[c][i] * inv) * (1.f + wv[i]);
      store_vec<T, VEC>(yr + idx * VEC, out);
    }
  }
}

// A CTA of THREADS threads a row; thread t holds vectors t, t + THREADS,
// ... (CHUNKS of them) of VEC elements.  Every load of x and w is issued
// before the first add: one memory round trip a row.
template <typename T, int VEC, int THREADS, int CHUNKS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_row_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ y, int D, float eps) {
  constexpr int kWarps = THREADS / kWarp;
  __shared__ float partial[kWarps];
  const long long row = blockIdx.x;
  const int nchunks = D / VEC;
  const T* xr = x + row * D;

  float v[CHUNKS][VEC], wv[CHUNKS][VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int idx = threadIdx.x + c * THREADS;
    if (idx < nchunks) {
      load_vec<T, VEC>(xr + idx * VEC, v[c]);
      load_vec<float, VEC>(w + idx * VEC, wv[c]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (threadIdx.x + c * THREADS < nchunks) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(v[c][i], v[c][i], ss);
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (kWarps > 1) {
    const int lane = threadIdx.x % kWarp;
    if (lane == 0) partial[threadIdx.x / kWarp] = ss;
    __syncthreads();
    // The cross-warp step: every warp sums the kWarps partials the same
    // way (lane l takes partial l, then an xor tree), so all agree.
    ss = lane < kWarps ? partial[lane] : 0.f;
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float inv = rsqrtf(ss / (float)D + eps);

  T* yr = y + row * D;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int idx = threadIdx.x + c * THREADS;
    if (idx < nchunks) {
      float out[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        out[i] = (v[c][i] * inv) * (1.f + wv[c][i]);
      store_vec<T, VEC>(yr + idx * VEC, out);
    }
  }
}

// An empty kernel of the CTA-a-row form's launch shape: the floor under it.
__global__ void empty_row_kernel() {}

template <typename T, int VEC>
int launch_warp_rows(const T* x, const float* w, T* y, long long R, int D,
                     float eps, cudaStream_t stream) {
  if (D > kWarpMaxD) return (int)cudaErrorInvalidValue;
  constexpr int rows = kThreads / kWarp;
  const long long grid = (R + rows - 1) / rows;
  rmsnorm_warp_kernel<T, VEC>
      <<<(unsigned)grid, kThreads, 0, stream>>>(x, w, y, R, D, eps);
  return cudaGetLastError();
}

template <typename T, int VEC, int THREADS, int CHUNKS>
int launch_cta_rows(const T* x, const float* w, T* y, long long R, int D,
                    float eps, cudaStream_t stream) {
  rmsnorm_row_kernel<T, VEC, THREADS, CHUNKS>
      <<<(unsigned)R, THREADS, 0, stream>>>(x, w, y, D, eps);
  return cudaGetLastError();
}

// The vectors a thread may hold, as the wrapper's plan allows: two on the
// 16-byte path, eight element by element.
template <int VEC>
constexpr int kMaxChunks = VEC > 1 ? 2 : 8;

// Whether CHUNKS vectors a thread can be needed: within kMaxChunks, and
// fewer must fall short of the widest row (so no instance holds more
// registers than some D needs).
template <int VEC, int THREADS, int CHUNKS>
constexpr bool kNeeded = CHUNKS <= kMaxChunks<VEC> &&
                         (CHUNKS == 1 || THREADS * VEC * (CHUNKS / 2) < kMaxD);

// CHUNKS: the fewest of 1, 2, 4, 8 vectors a thread that cover the row.
template <typename T, int VEC, int THREADS>
int launch_cta_chunks(const T* x, const float* w, T* y, long long R, int D,
                      float eps, cudaStream_t stream) {
  const int per_thread = (D / VEC + THREADS - 1) / THREADS;
  if (per_thread <= 1)
    return launch_cta_rows<T, VEC, THREADS, 1>(x, w, y, R, D, eps, stream);
  if constexpr (kNeeded<VEC, THREADS, 2>)
    if (per_thread <= 2)
      return launch_cta_rows<T, VEC, THREADS, 2>(x, w, y, R, D, eps, stream);
  if constexpr (kNeeded<VEC, THREADS, 4>)
    if (per_thread <= 4)
      return launch_cta_rows<T, VEC, THREADS, 4>(x, w, y, R, D, eps, stream);
  if constexpr (kNeeded<VEC, THREADS, 8>)
    if (per_thread <= 8)
      return launch_cta_rows<T, VEC, THREADS, 8>(x, w, y, R, D, eps, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* y, long long R, int D,
           float eps, int threads, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* yt = static_cast<T*>(y);
  switch (threads) {
    case 0: return launch_warp_rows<T, VEC>(xt, wt, yt, R, D, eps, stream);
    case 512:
      return launch_cta_chunks<T, VEC, 512>(xt, wt, yt, R, D, eps, stream);
    case 1024:
      return launch_cta_chunks<T, VEC, 1024>(xt, wt, yt, R, D, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rms
}  // namespace repro

// x [R, D] (dtype 0 fp32, 1 bf16), w [D] fp32 -> y [R, D] in x's type.
// vec16 != 0 when x, w, y and D allow 16-byte loads (the wrapper checks the
// alignment); D <= 8192.  threads 0 takes a warp a row (D <= 1024); 512 or
// 1024 a CTA of that many threads a row (each thread then holds at most 2
// vectors on the 16-byte path, 8 elements on the other).
REPRO_EXPORT int rmsnorm(int dtype, const void* x, const void* w, void* y,
                         long long R, int D, float eps, int vec16,
                         int threads, void* stream) {
  using namespace repro::rms;
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return vec16 ? launch<float, 4>(x, w, y, R, D, eps, threads, s)
                 : launch<float, 1>(x, w, y, R, D, eps, threads, s);
  if (dtype == 1)
    return vec16 ? launch<__nv_bfloat16, 8>(x, w, y, R, D, eps, threads, s)
                 : launch<__nv_bfloat16, 1>(x, w, y, R, D, eps, threads, s);
  return (int)cudaErrorInvalidValue;
}

// An empty launch of R CTAs of `threads` threads (the CTA-a-row form's shape)
// on `stream`: a measurement aid, on no model path.
REPRO_EXPORT int rmsnorm_empty_launch(long long R, int threads,
                                      void* stream) {
  repro::rms::empty_row_kernel<<<(unsigned)R, threads, 0,
                                 (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
