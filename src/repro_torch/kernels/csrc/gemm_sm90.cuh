// The port's SIMT fp32 GEMM core for Hopper, shared by K2 (matmul_bias_act,
// csrc/conv_im2col.cu) and K6 (matmul_at_b, csrc/conv_bwd.cu).
//
// C[M, N] = sum_k A(m, k) B[k, N] in IEEE fp32 with FMA (no TF32, no tensor
// cores: the port's "fp32 means IEEE fp32" rule).  A CTA of 256 threads
// (16 x 16) owns a BM x BN output tile, BM = 16 TM and BN = 16 TN with
// TM, TN in {4, 8}; a thread's TM x TN accumulators are TM/4 x TN/4 blocks
// of 4 x 4 at a stride of 64 rows / columns, so each block's rows and
// columns are contiguous and come from shared memory as float4.
//
// Loads: a ring of kStages (3) stages of A and B tiles in dynamic shared
// memory, fed by cp.async, so the next K slices load while the current one
// computes.  16-byte copies where every row start is 16-byte aligned (the
// caller checks strides and pointers), 4-byte copies otherwise (Conv1's
// K = 81 and 243); ragged M/N/K edges are zero-filled (cp.async with a
// source size of 0), so the masked products add exact zeros.
//
// A comes in one of two layouts, both read with no transposing store:
//  - K-major (K2: A [M, K] row-major).  The tile is stored as in memory,
//    As[BM][BK], and a thread reads one float4 of 4 consecutive k for each
//    of its rows, then walks those 4 k against B.
//  - M-major (K6: A [K, M] row-major, the reduction axis first).  The tile
//    is As[BK][BM], the outer-product layout, read like B.  Each stage's
//    BK rows are summed apart and added to the tile, as the TPU kernel
//    adds each M block's product: K6 sums in the reference's order.
// B is always [K, N] row-major, tile Bs[BK][BN].  Within a quarter warp the
// reads are one broadcast address (A) or 8 consecutive float4 (B), so
// they do not conflict; the cp.async writes are consecutive 16-byte runs.
// 128 x 128 tiles run one CTA an SM; narrower tiles are held to 128
// registers so that two share one.  ptxas (sm_90a, CUDA 12.8), no spills:
// K-major 168 registers at 128 x 128, 121 at 128 x 64, 128 at 64 x 128,
// 105 at 64 x 64; M-major 209 at 128 x 128, 128 at 128 x 64; the
// reduction 32.  Dynamic shared memory: 3 stages of 16 (BM + BN) floats,
// 48 KB at 128 x 128 (64.5 KB when the squash stages its tile), 36 KB at
// 128 x 64 or 64 x 128, 24 KB at 64 x 64; above 48 KB by opt-in.
//
// Split K: blockIdx.z takes the K slab [z * slab, min(K, (z + 1) * slab))
// (the planner makes the slab a multiple of BK and leaves no split empty).
// With one split the CTA applies the epilogue itself; with more, each
// writes its raw tile to part[z] ([split, M, N]) and splitk_reduce_kernel
// sums the partials in split order, then adds the bias and applies the
// epilogue.  Nothing is added with atomics, so the result is the same bits
// on every launch.

#pragma once

#include "common.cuh"

namespace repro {
namespace gemm {

constexpr int kStages = 3;           // planner.GEMM_STAGES
constexpr int kSumRows = 16;         // planner.AT_B_STEP: K6's M block
constexpr int kMaxSmem = 232448;     // planner.SMEM_BYTES: a CTA's opt-in

enum Epilogue { kNone = 0, kRelu = 1, kSquash = 2 };

// ReLU as torch.relu and jnp.maximum compute it: a NaN stays NaN (fmaxf
// would return 0 and hide a poisoned input), and -0 becomes +0.
__device__ __forceinline__ float relu(float x) {
  return (x > 0.f || x != x) ? x : 0.f;
}
// Layouts of A (see the note): K-major (as in memory) or M-major.
enum ALayout { kAKMem = 0, kAMMajor = 1 };


__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One GEMM launch.  A K-major: A(m, k) = A[m * lda + k]; M-major:
// A(m, k) = A[k * lda + m].  B(k, n) = B[k * N + n]; C(m, n) =
// C[m * N + n].  Output tile y covers columns [y * tile_n, y * tile_n +
// tile_n) (tile_n <= BN; the rest of the tile is masked).  vec_a / vec_b:
// 16-byte copies are legal for A / B.
struct Problem {
  const float* A;
  const float* B;
  int M, N, K, lda, tile_n, slab;
  bool vec_a, vec_b;
};

template <int TM, int TN, int BK, int AL>
struct Tile {
  static constexpr int BM = 16 * TM, BN = 16 * TN;
  // 128 x 128 tiles hold 64 accumulators a thread (and K6's 64 stage
  // sums) and take one CTA an SM; narrower tiles are held to 128
  // registers, so two CTAs share an SM.
  static constexpr int kMinBlocks = TM * TN > 32 ? 1 : 2;
  static constexpr int kStageFloats = BM * BK + BK * BN;
  // The squash epilogue stages the output tile over the ring.
  static constexpr int kOutFloats = BM * (BN + 1);
  static constexpr int smem_bytes(bool stage_output) {
    const int f = kStages * kStageFloats;
    return (stage_output && kOutFloats > f ? kOutFloats : f) *
           (int)sizeof(float);
  }
};

// f(c) for c = threadIdx.x, + kThreads, ... < COUNT, fully unrolled.
template <int COUNT, typename F>
__device__ __forceinline__ void for_each_slot(F&& f) {
#pragma unroll
  for (int it = 0; it < (COUNT + kThreads - 1) / kThreads; ++it) {
    const int c = it * kThreads + (int)threadIdx.x;
    if (COUNT % kThreads == 0 || c < COUNT) f(c);
  }
}

// Copy the K slice [kb, kb + BK) (clipped at k_end) of A and B into stage
// As / Bs.  Every thread issues its copies; the caller commits the group.
template <int TM, int TN, int BK, int AL>
__device__ __forceinline__ void load_stage(const Problem& p, float* As,
                                           float* Bs, int m0, int n0, int kb,
                                           int k_end) {
  using T = Tile<TM, TN, BK, AL>;
  constexpr int BM = T::BM, BN = T::BN;
  if constexpr (AL == kAKMem) {
    if (p.vec_a) {
      for_each_slot<BM * BK / 4>([&](int c) {
        const int r = c / (BK / 4), kk = (c % (BK / 4)) * 4;
        const int m = m0 + r, k = kb + kk;
        const bool in = m < p.M && k < k_end;
        cp_async16(As + r * BK + kk, in ? p.A + (size_t)m * p.lda + k : p.A,
                   in);
      });
    } else {
      for_each_slot<BM * BK>([&](int e) {
        const int r = e / BK, kk = e % BK;
        const int m = m0 + r, k = kb + kk;
        const bool in = m < p.M && k < k_end;
        cp_async4(As + e, in ? p.A + (size_t)m * p.lda + k : p.A, in);
      });
    }
  } else {
    if (p.vec_a) {
      for_each_slot<BK * BM / 4>([&](int c) {
        const int kk = c / (BM / 4), r = (c % (BM / 4)) * 4;
        const int m = m0 + r, k = kb + kk;
        const bool in = k < k_end && m < p.M;
        cp_async16(As + kk * BM + r, in ? p.A + (size_t)k * p.lda + m : p.A,
                   in);
      });
    } else {
      for_each_slot<BK * BM>([&](int e) {
        const int kk = e / BM, r = e % BM;
        const int m = m0 + r, k = kb + kk;
        const bool in = k < k_end && m < p.M;
        cp_async4(As + e, in ? p.A + (size_t)k * p.lda + m : p.A, in);
      });
    }
  }
  if (p.vec_b) {
    for_each_slot<BK * BN / 4>([&](int c) {
      const int kk = c / (BN / 4), cc = (c % (BN / 4)) * 4;
      const int n = n0 + cc, k = kb + kk;
      const bool in = k < k_end && cc < p.tile_n && n < p.N;
      cp_async16(Bs + kk * BN + cc, in ? p.B + (size_t)k * p.N + n : p.B,
                 in);
    });
  } else {
    for_each_slot<BK * BN>([&](int e) {
      const int kk = e / BN, cc = e % BN;
      const int n = n0 + cc, k = kb + kk;
      const bool in = k < k_end && cc < p.tile_n && n < p.N;
      cp_async4(Bs + e, in ? p.B + (size_t)k * p.N + n : p.B, in);
    });
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc += the stage's BK-deep product.  Row i of the thread is
// (i / 4) * 64 + ty * 4 + i % 4, column j likewise with tx.
template <int TM, int TN, int BK, int AL>
__device__ __forceinline__ void compute_stage(const float* As,
                                              const float* Bs,
                                              float (&acc)[TM][TN]) {
  using T = Tile<TM, TN, BK, AL>;
  constexpr int BM = T::BM, BN = T::BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if constexpr (AL == kAKMem) {
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            As + ((i / 4) * 64 + ty * 4 + i % 4) * BK + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              Bs + (k4 + kk) * BN + h * 64 + tx * 4);
          b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z,
                b[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = lane_of(a[i], kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  } else {
    // M-major A (K6) sums each kSumRows rows of the stage apart and adds
    // that to the tile, as the TPU kernel adds each M block's product.
    float sacc[TM][TN];
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk % kSumRows == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) sacc[i][j] = 0.f;
      }
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            As + kk * BM + g * 64 + ty * 4);
        a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z,
              a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            Bs + kk * BN + h * 64 + tx * 4);
        b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z,
              b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          sacc[i][j] = fmaf(a[i], b[j], sacc[i][j]);
      if (kk % kSumRows == kSumRows - 1 || kk == BK - 1) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += sacc[i][j];
      }
    }
  }
}

// One CTA: the (blockIdx.x, blockIdx.y) output tile over split blockIdx.z's
// K slab.  split > 1: the raw tile goes to part[z] ([split, M, N]);
// split == 1: out gets epilogue(acc + bias) (bias may be null: zero).
template <int TM, int TN, int BK, int AL>
__global__ void __launch_bounds__(kThreads, (Tile<TM, TN, BK, AL>::kMinBlocks))
gemm_kernel(Problem p, const float* __restrict__ bias,
            float* __restrict__ out, int split, int epilogue,
            int squash_dim) {
  using T = Tile<TM, TN, BK, AL>;
  constexpr int BM = T::BM, BN = T::BN;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * p.tile_n;
  const int k_begin = blockIdx.z * p.slab;
  const int k_end = min(p.K, k_begin + p.slab);
  const int steps = (k_end - k_begin + BK - 1) / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // Prologue: stages 0 .. kStages-2 in flight.  One commit per slot, empty
  // groups included, so wait_group<kStages-2> always means "stage s done".
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      float* st = smem + s * T::kStageFloats;
      load_stage<TM, TN, BK, AL>(p, st, st + BM * BK, m0, n0,
                                 k_begin + s * BK, k_end);
    }
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();        // stage s landed; stage s-1's readers are done
    const int next = s + kStages - 1;
    if (next < steps) {
      float* st = smem + (next % kStages) * T::kStageFloats;
      load_stage<TM, TN, BK, AL>(p, st, st + BM * BK, m0, n0,
                                 k_begin + next * BK, k_end);
    }
    cp_async_commit();
    const float* st = smem + (s % kStages) * T::kStageFloats;
    compute_stage<TM, TN, BK, AL>(st, st + BM * BK, acc);
  }

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool raw = split > 1;
  float* dst = raw ? out + (size_t)blockIdx.z * p.M * p.N : out;
  if (raw || epilogue != kSquash) {
    // float4 stores where the row is 16-byte aligned and the 4 columns
    // lie inside the tile and the matrix.
    const bool vec_out = (p.N % 4) == 0 && (p.tile_n % 4) == 0 &&
                         (reinterpret_cast<size_t>(dst) % 16) == 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
      if (m >= p.M) continue;
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const int c = h * 64 + tx * 4, n = n0 + c;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = acc[i][4 * h + q];
          if (!raw) {
            if (bias != nullptr && c + q < p.tile_n && n + q < p.N)
              v[q] += bias[n + q];
            if (epilogue == kRelu) v[q] = relu(v[q]);
          }
        }
        if (vec_out && c < p.tile_n && n < p.N) {
          *reinterpret_cast<float4*>(dst + (size_t)m * p.N + n) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c + q < p.tile_n && n + q < p.N)
              dst[(size_t)m * p.N + n + q] = v[q];
        }
      }
    }
    return;
  }
  // Squash with one split: stage acc + bias over the ring (every copy has
  // landed and been read), then one thread squashes one capsule group.
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = smem;                          // [BM][BN + 1]
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = (j / 4) * 64 + tx * 4 + j % 4, n = n0 + c;
      Cs[r * (BN + 1) + c] =
          acc[i][j] + ((c < p.tile_n && n < p.N) ? bias[n] : 0.f);
    }
  }
  __syncthreads();
  const int groups = p.tile_n / squash_dim;
  for (int e = threadIdx.x; e < BM * groups; e += kThreads) {
    const int r = e / groups, g = e % groups;
    const int m = m0 + r, nb = n0 + g * squash_dim;
    if (m >= p.M || nb >= p.N) continue;
    squash_into(Cs + r * (BN + 1) + g * squash_dim,
                dst + (size_t)m * p.N + nb, squash_dim);
  }
}

// out = epilogue(sum over z, in order, of part[z] + bias).  The squash
// takes one capsule group of squash_dim columns per thread, as squash_into
// does (out holds the sums until the group's norm is known).
static __global__ void __launch_bounds__(kThreads)
splitk_reduce_kernel(const float* __restrict__ part,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int M, int N, int split, int epilogue, int squash_dim) {
  const long long mn = (long long)M * N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (epilogue != kSquash) {
    for (long long e = first; e < mn; e += stride) {
      float s = 0.f;
      for (int z = 0; z < split; ++z) s += part[z * mn + e];
      if (bias != nullptr) s += bias[e % N];
      if (epilogue == kRelu) s = relu(s);
      out[e] = s;
    }
    return;
  }
  for (long long g = first; g < mn / squash_dim; g += stride) {
    const long long base = g * squash_dim;
    const int nb = (int)(base % N);
    float sq = 0.f;
    for (int d = 0; d < squash_dim; ++d) {
      float s = 0.f;
      for (int z = 0; z < split; ++z) s += part[z * mn + base + d];
      s += bias[nb + d];
      out[base + d] = s;
      sq = fmaf(s, s, sq);
    }
    const float a = sq / (1.f + sq);
    const float r = rsqrtf(sq + kSquashEps);
    for (int d = 0; d < squash_dim; ++d) out[base + d] = a * out[base + d] * r;
  }
}

inline unsigned reduce_grid(long long items) {
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (1LL << 16)) blocks = 1LL << 16;     // grid-stride beyond
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<size_t>(ptr) % 16) == 0;
}

// Launch the GEMM (and, with split > 1, the ordered reduction of `part`,
// a [split, M, N] scratch).  The opt-in to kMaxSmem of dynamic shared
// memory is made once per instance, at its first launch; `static` keeps
// that flag inside each library (an inline function's static would be
// one symbol across every library loaded).
template <int TM, int TN, int BK, int AL>
static cudaError_t launch(const Problem& p, const float* bias, float* out,
                   float* part, int split, int epilogue, int squash_dim,
                   cudaStream_t stream) {
  using T = Tile<TM, TN, BK, AL>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      gemm_kernel<TM, TN, BK, AL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opted != cudaSuccess) return opted;
  if (split > 1 && part == nullptr) return cudaErrorInvalidValue;
  const int smem = T::smem_bytes(epilogue == kSquash && split == 1);
  const dim3 grid((p.M + T::BM - 1) / T::BM, (p.N + p.tile_n - 1) / p.tile_n,
                  split);
  gemm_kernel<TM, TN, BK, AL><<<grid, kThreads, smem, stream>>>(
      p, bias, split > 1 ? part : out, split, epilogue, squash_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const long long items = (long long)p.M * p.N /
                          (epilogue == kSquash ? squash_dim : 1);
  splitk_reduce_kernel<<<reduce_grid(items), kThreads, 0, stream>>>(
      part, bias, out, p.M, p.N, split, epilogue, squash_dim);
  return cudaGetLastError();
}

// What the card says of a launch() of this build (kernel_attributes): the
// GEMM with the dynamic shared memory that launch() asks for, after the
// same opt-in; with split > 1 the static bytes are the larger of the
// GEMM's and the ordered reduction's.
template <int TM, int TN, int BK, int AL>
static cudaError_t occupancy(bool squash, int split, int* out) {
  const void* kernel = (const void*)gemm_kernel<TM, TN, BK, AL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  err = kernel_attributes(
      kernel, Tile<TM, TN, BK, AL>::smem_bytes(squash && split == 1), out);
  if (err != cudaSuccess || split == 1) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, (const void*)splitk_reduce_kernel);
  if (err == cudaSuccess && (int)fa.sharedSizeBytes > out[1])
    out[1] = (int)fa.sharedSizeBytes;
  return err;
}

}  // namespace gemm
}  // namespace repro
