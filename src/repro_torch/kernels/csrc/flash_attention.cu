// K15 flash attention: blocked online-softmax attention with causal masking,
// a sliding window, logit softcapping, grouped KV heads and a per-row KV
// length, in IEEE fp32 (no tensor cores), as two schedules of one entry.
//
// Replaces src/repro/kernels/flash_attention.py: _flash_kernel, gridded by
// flash_attention()'s pallas_call over (batch*heads, q blocks, kv blocks)
// with the running (m, l, acc) carried in VMEM scratch across the kv axis.
//
//   logits = (q . k) * scale;  softcap: tanh(logits / cap) * cap
//   row t of batch row b sits at position p = kv_len[b] - Tq + t (the
//   reference's decode end-alignment q_offset = Tk - Tq, per row); key c
//   is masked (-1e30, as the reference's NEG_INF) unless c <= p (causal)
//   and c > p - window (window); keys c >= kv_len[b] are not the row's and
//   weigh exactly 0.  A row whose every key is masked gets p = 1 on each,
//   the mean of V over its keys, as the reference's kernel gives.
//   kv_len[b] is clamped to 0..Tk, so no row reads past K or V; a row of
//   no keys (kv_len[b] <= 0) visits no key and writes 0.
//   Query head h reads KV head h / (H / KvH): the reference's GQA grouping
//   (models/attention.py q5), with no expanded copy of K or V.
//
// Operands are strided: q, o [B, T, H, D] and k, v [B, S, KvH, D] in
// elements of (b, t, h), the last dim contiguous, so the model's
// projections and its [B, S, KvH, D] cache go in as they lie, and
// ops.flash_attention's [B, H, T, D] as a permuted view.
//
// Prefill (every call the decode plan does not take).  Bound: the two
// products, 4 * Tq * Tk_visible * D flops per (b, h) (gemma2-9b's T = 4608,
// D = 256: ~0.17 TFLOP a layer, 2.6 ms at the fp32 rate of 67 TFLOP/s).
// One CTA takes one (batch row, query head, 64-row q block); the last q
// blocks, which see the most keys under a causal mask, start first.  The
// Q tile stays in shared memory (fp32, rows padded by 32 B); K/V tiles of
// BK keys stream through a 2-stage ring filled by 16-byte cp.async (raw
// bytes: a bf16 cache is converted where it is read), so tile k + 1 loads
// while tile k computes.  Each tile takes two barriers and two phases:
//  - q.k and softmax: a warp's lanes take 2 row groups x BK/4 key groups x
//    DS shares of D (DS = 2 at BK = 32, 1 at 64), each lane a 4 x 4 block
//    of logits (rows 16 apart, keys BK/4 apart) over every DS-th float4 of
//    D: per 4 d, 4 q and 4 k float4 loads feed 64 FMAs (each value 4), on
//    distinct banks (Q rows padded by 32 B, K rows by 16 B).  Partner lanes
//    then sum their shares by one shuffle, each keeping 4/DS rows, whose
//    running max and sum the BK/4 lanes of a row share by shuffle; P
//    (transposed), alpha and l go to shared memory;
//  - p.v: the 64 x D output tile as TM x TN register blocks, float4 blocks
//    of rows and columns (8 x 8 at D = 256, the GEMM core's layout,
//    csrc/gemm_sm90.cuh): per key, 2 + 2 float4 loads feed 64 FMAs.
// KV blocks that no row of the CTA can see (past the causal diagonal,
// before the window) are skipped -- except in a CTA holding a row with no
// valid key at all, which visits every block so that row's mean of V comes
// out as the reference's.  BK (32 or 64) comes from the shared-memory and
// register budgets (kernels/flash_attention.py plan_tiles): with fp32 K/V
// at D = 256 only BK = 32 fits (208,896 B, one CTA an SM).
//
// Decode (Tq x H/KvH query rows at most 8 at D = 256, 16 below; the plan,
// plan_decode, fixes the split count from host-known shapes only).  Bound:
// the bytes of the visible K/V rows.  One CTA takes one (batch row, KV
// head, key split) and all Tq x group query rows that read that KV head,
// so K and V are read once per KV head.  Its 8 warps take the split's keys
// in turn (a key's D/4-element row over min(32, D/4) lanes, 16 bytes a
// lane in fp32), each lane prefetching its own slice of its next keys
// through a private 4-stage cp.async ring (no barrier: a lane reads only
// what it copied); dot products reduce by shuffle and each warp keeps an
// online softmax per row.  The warps merge in a fixed order through
// shared memory and the CTA writes its partial (m, l, acc[rows][D]).  A
// split that holds none of its rows' visible keys writes an empty partial
// (m = -inf, l = 0).  decode_combine_kernel then merges the partials of
// each row in split order (no atomics: a second launch repeats the bits),
// skipping empty ones; a partial of masked keys only (m = -1e30) weighs 0
// beside one of real keys and 1 where the row has no valid key, so the
// mean-of-V rows and the 0 rows (kv_len = 0) come out as in prefill.
//
// ptxas (sm_90a, CUDA 12.8), registers a thread and spills: prefill fp32
// D = 256 220 (bf16 K/V 204), no spill; D <= 128 held to 128 (two CTAs an
// SM), spilling up to 56 B (the planned tiles: 40 B at D = 128, 8 B at
// D = 64); decode 64 at gemma2's 2 rows, 160 at 8, up to 239 at 16 rows
// (D = 64), no spill; the combine 32.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace flash {

constexpr int kBQ = 64;            // prefill: query rows per CTA
constexpr int kStages = 2;         // prefill: K/V ring stages
constexpr int kDecStages = 4;      // decode: a lane's ring stages
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;   // planner.SMEM_BYTES: a CTA's opt-in
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four consecutive elements from shared memory as floats (a bf16 value is
// the high half of its float).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// cp.async of BYTES (16: L2 only; 8: through L1); src_bytes 0 zero-fills.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_len;               // [B], or null: every row sees Tk keys
  long long sqb, sqt, sqh;         // element strides of (b, t, h)
  long long skb, skt, skh;
  long long svb, svt, svh;
  long long sob, sot, soh;
  int H, KvH, Tq, Tk;
  float scale, softcap;            // softcap <= 0: none
  int causal, window;              // window <= 0: none
};

__device__ __forceinline__ int clamped_len(const Args& a, int b) {
  return a.kv_len != nullptr ? min(max(a.kv_len[b], 0), a.Tk) : a.Tk;
}

// The keys [lo, hi) that rows at positions p0..p1 (all < kv_len) visit:
// every key up to kv_len where a row has no valid key (a causal row before
// the keys' start), else the union of the rows' causal and window ranges.
__device__ __forceinline__ void visible(const Args& a, int kv_len, int p0,
                                        int p1, int& lo, int& hi) {
  lo = 0;
  hi = kv_len;
  if (!(a.causal && p0 < 0)) {
    if (a.causal) hi = min(hi, p1 + 1);
    if (a.window > 0) lo = max(0, p0 - a.window + 1);
  }
}

// The logit of key c for the row at position p (softcapped and masked).
__device__ __forceinline__ float logit(const Args& a, float dot, int c,
                                       int p) {
  float x = dot * a.scale;
  if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
  bool valid = true;
  if (a.causal) valid = valid && c <= p;
  if (a.window > 0) valid = valid && c > p - a.window;
  return valid ? x : kNegInf;
}

// ---------------------------------------------------------------------------
// Prefill
// ---------------------------------------------------------------------------

template <typename TKV, int D, int BK>
struct Prefill {
  static constexpr int kKvB = (int)sizeof(TKV);
  static constexpr int kQStride = D + 8;              // floats
  static constexpr int kKStride = D + 16 / kKvB;      // elements
  static constexpr int kSC = BK / 4;                  // lanes over a row's keys
  static constexpr int kDS = 32 / (2 * kSC);          // lanes over D: 2 or 1
  static constexpr int kRows = 4 / kDS;               // rows a lane's softmax
  static constexpr int kPStride = kBQ + 4;
  static constexpr int kTRO = D == 256 ? 8 : 16;      // p.v thread rows
  static constexpr int kTCO = kThreads / kTRO;
  static constexpr int kTM = kBQ / kTRO;              // 8 or 4 rows a thread
  static constexpr int kTN = D / kTCO;                // 8, 8, 4, 2, 1 columns
  static constexpr int kQBytes = kBQ * kQStride * 4;
  static constexpr int kKBytes = BK * kKStride * kKvB;
  static constexpr int kVBytes = BK * D * kKvB;
  static constexpr int kPBytes = BK * kPStride * 4;
  static constexpr int kSmem = kQBytes + kStages * (kKBytes + kVBytes) +
                               kPBytes + 2 * kBQ * 4;
  static constexpr int kMinBlocks = D == 256 ? 1 : 2;
  static_assert(2 * kSC * kDS == 32, "q.k lanes: 2 rows x keys x D shares");
  static_assert(kTM % 4 == 0 && kTN * kTCO == D, "p.v thread grid");
  static_assert(D % (4 * kDS) == 0, "q.k share of D");
};

// Issue the copies of K/V tile [c0, c0 + BK) into one stage: 16-byte
// cp.async where rows are aligned (zero-filled past kv_len), else plain
// element copies (visible after the next barrier).
template <typename TKV, int D, int BK>
__device__ __forceinline__ void load_kv_tile(const TKV* k, const TKV* v,
                                             long long skt, long long svt,
                                             TKV* Ks, TKV* Vs, int c0,
                                             int kv_len, bool vec) {
  using P = Prefill<TKV, D, BK>;
  constexpr int kPer = 16 / P::kKvB;                  // elements a copy
  constexpr int kChunks = D / kPer;                   // copies a row
  if (vec) {
#pragma unroll 4
    for (int e = threadIdx.x; e < BK * kChunks; e += kThreads) {
      const int c = e / kChunks, d = (e % kChunks) * kPer;
      const bool in = c0 + c < kv_len;
      const long long t = in ? c0 + c : 0;
      cp_async<16>(Ks + c * P::kKStride + d, k + t * skt + d, in);
      cp_async<16>(Vs + c * D + d, v + t * svt + d, in);
    }
  } else {
    const TKV zero = TKV(0.f);
    for (int e = threadIdx.x; e < BK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const bool in = c0 + c < kv_len;
      const long long t = c0 + c;
      Ks[c * P::kKStride + d] = in ? k[t * skt + d] : zero;
      Vs[c * D + d] = in ? v[t * svt + d] : zero;
    }
  }
}

template <typename TQ, typename TKV, int D, int BK>
__global__ void __launch_bounds__(kThreads,
                                  (Prefill<TKV, D, BK>::kMinBlocks))
prefill_kernel(const Args a, bool vec) {
  using P = Prefill<TKV, D, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);                 // [64][D+8]
  unsigned char* ring = smem + P::kQBytes;
  float* Pt = reinterpret_cast<float*>(
      ring + kStages * (P::kKBytes + P::kVBytes));            // [BK][64+4]
  float* alpha_s = Pt + BK * P::kPStride;                     // [64]
  float* l_s = alpha_s + kBQ;                                 // [64]
  auto Ks = [&](int st) {
    return reinterpret_cast<TKV*>(ring + st * (P::kKBytes + P::kVBytes));
  };
  auto Vs = [&](int st) {
    return reinterpret_cast<TKV*>(ring + st * (P::kKBytes + P::kVBytes) +
                                  P::kKBytes);
  };

  const int tid = threadIdx.x;
  const int qb = gridDim.x - 1 - blockIdx.x;  // the most keys first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KvH);
  const int kv_len = clamped_len(a, b);
  const int t0 = qb * kBQ;
  const int rows = min(kBQ, a.Tq - t0);
  const int p0 = kv_len - a.Tq + t0;          // position of the CTA's row 0
  int lo, hi;
  visible(a, kv_len, p0, p0 + rows - 1, lo, hi);
  const int kb0 = lo / BK, kb1 = (hi + BK - 1) / BK;

  const TQ* q = static_cast<const TQ*>(a.q) + b * a.sqb + h * a.sqh;
  const TKV* k = static_cast<const TKV*>(a.k) + b * a.skb + kvh * a.skh;
  const TKV* v = static_cast<const TKV*>(a.v) + b * a.svb + kvh * a.svh;

  // Prologue: the first K/V tiles in flight, then Q (fp32) and l = 0.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (kb0 + s < kb1)
      load_kv_tile<TKV, D, BK>(k, v, a.skt, a.svt, Ks(s), Vs(s),
                               (kb0 + s) * BK, kv_len, vec);
    cp_async_commit();
  }
#pragma unroll 8
  for (int it = 0; it < kBQ * D / kThreads; ++it) {
    const int e = it * kThreads + tid, r = e / D, d = e % D;
    Qs[r * P::kQStride + d] =
        r < rows ? to_f(q[(long long)(t0 + r) * a.sqt + d]) : 0.f;
  }
  if (tid < kBQ) l_s[tid] = 0.f;

  // q.k and softmax: warp w's lanes take rows sr + 16 i (sr = 2 w + srl),
  // keys sc + SC j, and every DS-th float4 of D from ds on; partner lanes
  // (ds 0 / 1) then sum their partial logits, each keeping kRows rows
  // (rows sr + 16 (ds kRows + ii)), whose running max and sum the SC lanes
  // of the row share by shuffle.
  const int lane = tid % 32;
  const int sc = lane % P::kSC, ds = (lane / P::kSC) % P::kDS;
  const int sr = (tid / 32) * 2 + lane / (P::kSC * P::kDS);
  float m_run[P::kRows], l_run[P::kRows];
#pragma unroll
  for (int ii = 0; ii < P::kRows; ++ii) m_run[ii] = kNegInf, l_run[ii] = 0.f;
  // p.v: rows a*4*TRO + tro*4 + e, columns (TN >= 4) b*4*TCO + tco*4 + e
  // or (TN < 4) tco*TN + e.
  const int tro = tid / P::kTCO, tco = tid % P::kTCO;
  constexpr int TM = P::kTM, TN = P::kTN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kb = kb0; kb < kb1; ++kb) {
    const int it = kb - kb0, c0 = kb * BK;
    cp_async_wait<kStages - 2>();
    __syncthreads();      // tile kb landed; tile kb-1's readers are done
    if (kb + kStages - 1 < kb1)
      load_kv_tile<TKV, D, BK>(k, v, a.skt, a.svt,
                               Ks((it + kStages - 1) % kStages),
                               Vs((it + kStages - 1) % kStages),
                               (kb + kStages - 1) * BK, kv_len, vec);
    cp_async_commit();
    const TKV* Kt = Ks(it % kStages);
    const TKV* Vt = Vs(it % kStages);

    // q.k over this lane's share of D, then the softmax of its rows.
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      const float* qr = Qs + sr * P::kQStride + ds * 4;
      const TKV* kr = Kt + sc * P::kKStride + ds * 4;
#pragma unroll
      for (int d = 0; d < D; d += 4 * P::kDS) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = load4(qr + i * 16 * P::kQStride + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = load4(kr + j * P::kSC * P::kKStride + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
      float x[P::kRows][4];
#pragma unroll
      for (int ii = 0; ii < P::kRows; ++ii)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (P::kDS == 2) {
            const float give = ds == 0 ? s[ii + 2][j] : s[ii][j];
            const float keep = ds == 0 ? s[ii][j] : s[ii + 2][j];
            x[ii][j] = keep + __shfl_xor_sync(0xffffffffu, give, P::kSC);
          } else {
            x[ii][j] = s[ii][j];
          }
        }
#pragma unroll
      for (int ii = 0; ii < P::kRows; ++ii) {
        const int r = sr + 16 * (ds * P::kRows + ii);
        const int p = p0 + r;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + sc + P::kSC * j;
          float xv = logit(a, x[ii][j], c, p);
          if (c >= kv_len) xv = -INFINITY;     // not one of the row's keys
          x[ii][j] = xv;
          mx = fmaxf(mx, xv);
        }
        // The row's lanes reduce from the widest offset down.  Keep the
        // order: with a bf16 cache, a one-ulp change here can flip the
        // rounding of a later layer's K/V and move a model's logits by far
        // more than an ulp.
#pragma unroll
        for (int o = P::kSC / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        // Every visited tile holds at least one of the row's keys, so the
        // new max is finite (>= -1e30) and exp never sees inf - inf.
        const float m_new = fmaxf(m_run[ii], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = expf(x[ii][j] - m_new);
          sum += e;
          Pt[(sc + P::kSC * j) * P::kPStride + r] = e;
        }
#pragma unroll
        for (int o = P::kSC / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float alpha = expf(m_run[ii] - m_new);
        l_run[ii] = l_run[ii] * alpha + sum;
        m_run[ii] = m_new;
        if (sc == 0) {
          alpha_s[r] = alpha;
          l_s[r] = l_run[ii];
        }
      }
    }
    __syncthreads();

    // p.v: rescale the output block, then add this tile's P V.
    {
#pragma unroll
      for (int ga = 0; ga < TM / 4; ++ga) {
        const float4 al = load4(alpha_s + ga * 4 * P::kTRO + tro * 4);
        const float alv[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[ga * 4 + e][j] *= alv[e];
      }
      const float* pr = Pt + tro * 4;
      const TKV* vr = Vt + (TN >= 4 ? tco * 4 : tco * TN);
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        float pv[TM], vv[TN];
#pragma unroll
        for (int ga = 0; ga < TM / 4; ++ga) {
          const float4 t = load4(pr + c * P::kPStride + ga * 4 * P::kTRO);
          pv[ga * 4] = t.x, pv[ga * 4 + 1] = t.y, pv[ga * 4 + 2] = t.z,
                  pv[ga * 4 + 3] = t.w;
        }
        if constexpr (TN >= 4) {
#pragma unroll
          for (int gb = 0; gb < TN / 4; ++gb) {
            const float4 t = load4(vr + c * D + gb * 4 * P::kTCO);
            vv[gb * 4] = t.x, vv[gb * 4 + 1] = t.y, vv[gb * 4 + 2] = t.z,
                    vv[gb * 4 + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) vv[j] = to_f(vr[c * D + j]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(pv[i], vv[j],
                                                        acc[i][j]);
      }
    }
  }
  __syncthreads();        // l_s is final (also where no tile was visited)

  TQ* o = static_cast<TQ*>(a.o) + b * a.sob + h * a.soh;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = (i / 4) * 4 * P::kTRO + tro * 4 + i % 4;
    if (r >= rows) continue;
    const float l = l_s[r];
    const float lsum = l == 0.f ? 1.f : l;
    TQ* orow = o + (long long)(t0 + r) * a.sot;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = TN >= 4 ? (j / 4) * 4 * P::kTCO + tco * 4 + j % 4
                              : tco * TN + j;
      store_f(orow + col, acc[i][j] / lsum);
    }
  }
}

// ---------------------------------------------------------------------------
// Decode: split-KV partials, then their combine
// ---------------------------------------------------------------------------

template <typename TKV, int D, int RB>
struct Decode {
  static constexpr int kKvB = (int)sizeof(TKV);
  static constexpr int kLPK = D / 4 < 32 ? D / 4 : 32;  // lanes a key
  static constexpr int kKPW = 32 / kLPK;                // keys a warp step
  static constexpr int kNC = D / (4 * kLPK);            // 4-element chunks
  static constexpr int kE = 4 * kNC;                    // elements a lane
  static constexpr int kStreams = kWarps * kKPW;
  // A lane's ring: kDecStages x (K, V) x kNC chunks of 4 elements,
  // stored chunk-major over the CTA's threads (consecutive lanes,
  // consecutive 4-element slots: no bank conflict).
  static constexpr int kRingBytes =
      kDecStages * 2 * kNC * kThreads * 4 * kKvB;
  static constexpr int kMergeBytes = kWarps * RB * D * 4;
  static constexpr int kQBytes = RB * D * 4;
  static constexpr int kSmem =
      kQBytes + (kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes) +
      kWarps * RB * 2 * 4;
  static_assert(kE * RB <= 64, "decode accumulators a lane");
};

// ws_acc [B, KvH, S, R, D], ws_ml [B, KvH, S, R, 2] (fp32).
template <typename TQ, typename TKV, int D, int RB>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const Args a, int chunk, bool vec, float* __restrict__ ws_acc,
              float* __restrict__ ws_ml) {
  using P = Decode<TKV, D, RB>;
  constexpr int E = P::kE, NC = P::kNC, LPK = P::kLPK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qd = reinterpret_cast<float*>(smem);                  // [RB][D]
  unsigned char* ring = smem + P::kQBytes;
  float* merge = reinterpret_cast<float*>(ring);               // [8][RB][D]
  float* ml = reinterpret_cast<float*>(
      ring + (P::kRingBytes > P::kMergeBytes ? P::kRingBytes
                                             : P::kMergeBytes));  // [8][RB][2]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x;
  const int group = a.H / a.KvH;
  const int R = a.Tq * group;
  const int kv_len = clamped_len(a, b);
  int lo, hi;
  visible(a, kv_len, kv_len - a.Tq, kv_len - 1, lo, hi);
  const int k0 = max(lo, split * chunk);
  const int k1 = min(hi, min(a.Tk, (split + 1) * chunk));
  const long long part = ((long long)b * a.KvH + kvh) * S + split;
  float* out_ml = ws_ml + part * R * 2;
  if (k0 >= k1) {         // none of the rows' visible keys: empty partial
    for (int r = tid; r < R; r += kThreads) {
      out_ml[2 * r] = -INFINITY;
      out_ml[2 * r + 1] = 0.f;
    }
    return;
  }

  const TKV* k = static_cast<const TKV*>(a.k) + b * a.skb + kvh * a.skh;
  const TKV* v = static_cast<const TKV*>(a.v) + b * a.svb + kvh * a.svh;
  const int seg = lane / LPK, sl = lane % LPK;
  const int sid = warp * P::kKPW + seg;
  const int steps = (k1 - k0 + P::kStreams - 1) / P::kStreams;
  // Stage st, tensor kv (0: K, 1: V), chunk j of this lane.
  auto slot = [&](int st, int kv, int j) {
    return reinterpret_cast<TKV*>(ring) +
           (((st * 2 + kv) * NC + j) * kThreads + tid) * 4;
  };
  auto issue = [&](int step) {
    const int st = step % kDecStages;
    const int c = k0 + sid + P::kStreams * step;
    const bool in = c < k1;
    const long long t = in ? c : k0;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = j * 4 * LPK + sl * 4;
      if (vec) {
        cp_async<4 * P::kKvB>(slot(st, 0, j), k + t * a.skt + d, in);
        cp_async<4 * P::kKvB>(slot(st, 1, j), v + t * a.svt + d, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          slot(st, 0, j)[e] = in ? k[t * a.skt + d + e] : TKV(0.f);
          slot(st, 1, j)[e] = in ? v[t * a.svt + d + e] : TKV(0.f);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  // The rows' q (fp32); row r = t * group + g reads query head
  // kvh * group + g at step t; padding rows are 0.
  const TQ* q = static_cast<const TQ*>(a.q) + b * a.sqb;
  for (int e = tid; e < RB * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r < R)
      x = to_f(q[(long long)(r / group) * a.sqt +
                 (long long)(kvh * group + r % group) * a.sqh + d]);
    Qd[e] = x;
  }
  __syncthreads();

  int pos[RB];
  float m[RB], l[RB], acc[RB][E];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    pos[r] = kv_len - a.Tq + min(r, R - 1) / group;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kDecStages - 2>();        // this lane's copies of `step`
    if (step + kDecStages - 1 < steps) issue(step + kDecStages - 1);
    cp_async_commit();
    const int st = step % kDecStages;
    const int c = k0 + sid + P::kStreams * step;
    float kf[E], vf[E];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float4 kk = load4(slot(st, 0, j));
      const float4 vv = load4(slot(st, 1, j));
      kf[4 * j] = kk.x, kf[4 * j + 1] = kk.y, kf[4 * j + 2] = kk.z,
             kf[4 * j + 3] = kk.w;
      vf[4 * j] = vv.x, vf[4 * j + 1] = vv.y, vf[4 * j + 2] = vv.z,
             vf[4 * j + 3] = vv.w;
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 qq = load4(Qd + r * D + j * 4 * LPK + sl * 4);
        dot = fmaf(qq.x, kf[4 * j], dot);
        dot = fmaf(qq.y, kf[4 * j + 1], dot);
        dot = fmaf(qq.z, kf[4 * j + 2], dot);
        dot = fmaf(qq.w, kf[4 * j + 3], dot);
      }
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (c < k1) {
        const float x = logit(a, dot, c, pos[r]);
        const float mn = fmaxf(m[r], x);
        const float alpha = expf(m[r] - mn);
        const float p = expf(x - mn);
        l[r] = l[r] * alpha + p;
        m[r] = mn;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][e] = fmaf(p, vf[e], acc[r][e] * alpha);
      }
    }
  }

  // The warp's segments (keys side by side) merge, lowest first.
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float om = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float ol = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], om);
      const float m1 = up ? om : m[r], m2 = up ? m[r] : om;
      const float l1 = up ? ol : l[r], l2 = up ? l[r] : ol;
      const float w1 = mn == -INFINITY ? 0.f : expf(m1 - mn);
      const float w2 = mn == -INFINITY ? 0.f : expf(m2 - mn);
      l[r] = l1 * w1 + l2 * w2;
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float oa = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        const float a1 = up ? oa : acc[r][e], a2 = up ? acc[r][e] : oa;
        acc[r][e] = a1 * w1 + a2 * w2;
      }
    }
  }

  // Then the warps, in order, through shared memory (over the ring).
  cp_async_wait<0>();
  __syncthreads();
  if (lane < LPK) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          merge[(warp * RB + r) * D + j * 4 * LPK + sl * 4 + e] =
              acc[r][4 * j + e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      ml[(warp * RB + r) * 2] = m[r];
      ml[(warp * RB + r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  float* out_acc = ws_acc + part * R * D;
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml[(w * RB + r) * 2]);
    float sum_l = 0.f, sum_a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = ml[(w * RB + r) * 2];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - mx);
      sum_l += ml[(w * RB + r) * 2 + 1] * wt;
      sum_a += merge[(w * RB + r) * D + d] * wt;
    }
    out_acc[r * D + d] = sum_a;
    if (d == 0) {
      out_ml[2 * r] = mx;
      out_ml[2 * r + 1] = sum_l;
    }
  }
}

// One CTA a query row (b, kvh, r), one thread an output element: the S
// partials merged in split order (each thread reads every split's (m, l)
// and its own element of each split's acc; the loads are independent).
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const Args a, int S, int D,
                      const float* __restrict__ ws_acc,
                      const float* __restrict__ ws_ml) {
  const int group = a.H / a.KvH, R = a.Tq * group;
  const int d = threadIdx.x;
  if (d >= D) return;
  const long long row = blockIdx.x;
  const int r = (int)(row % R);
  const int kvh = (int)((row / R) % a.KvH);
  const int b = (int)(row / ((long long)R * a.KvH));
  const long long base = ((long long)b * a.KvH + kvh) * S;
  float mx = -INFINITY;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, ws_ml[((base + s) * R + r) * 2]);
  float sum_l = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float ms = ws_ml[((base + s) * R + r) * 2];
    if (ms != -INFINITY) {
      const float w = expf(ms - mx);
      sum_l += ws_ml[((base + s) * R + r) * 2 + 1] * w;
      acc += ws_acc[((base + s) * R + r) * D + d] * w;
    }
  }
  TQ* o = static_cast<TQ*>(a.o) + b * a.sob +
          (long long)(r / group) * a.sot +
          (long long)(kvh * group + r % group) * a.soh;
  store_f(o + d, sum_l == 0.f ? 0.f : acc / sum_l);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Rows of p at strides (s0, s1, s2) start on `bytes` boundaries: the
// pointer is so aligned and every stride is a multiple of `elems`.
inline bool aligned(const void* p, long long s0, long long s1, long long s2,
                    int bytes, int elems) {
  return (reinterpret_cast<size_t>(p) % bytes) == 0 && s0 % elems == 0 &&
         s1 % elems == 0 && s2 % elems == 0;
}

// The opt-in to the kernel's dynamic shared memory, made once per
// instance at its first launch (`static` keeps the flag in this library).
template <typename TQ, typename TKV, int D, int BK>
static int launch_prefill(const Args& a, int B, bool vec,
                          cudaStream_t stream) {
  using P = Prefill<TKV, D, BK>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      prefill_kernel<TQ, TKV, D, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (opted != cudaSuccess) return (int)opted;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.H, B);
  prefill_kernel<TQ, TKV, D, BK><<<grid, kThreads, P::kSmem, stream>>>(a,
                                                                       vec);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int D, int RB>
static int launch_decode(const Args& a, int B, int splits, int chunk,
                         bool vec, float* ws, cudaStream_t stream) {
  using P = Decode<TKV, D, RB>;
  static const cudaError_t opted = cudaFuncSetAttribute(
      decode_kernel<TQ, TKV, D, RB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (opted != cudaSuccess) return (int)opted;
  const long long rows = (long long)B * a.KvH * a.Tq * (a.H / a.KvH);
  float* ws_acc = ws;
  float* ws_ml = ws + rows * splits * D;
  decode_kernel<TQ, TKV, D, RB>
      <<<dim3(splits, a.KvH, B), kThreads, P::kSmem, stream>>>(
          a, chunk, vec, ws_acc, ws_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<TQ><<<(unsigned)rows, D < 32 ? 32 : D, 0, stream>>>(
      a, splits, D, ws_acc, ws_ml);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
int launch_d(const Args& a, int B, int bk, int splits, int chunk,
             float* ws, cudaStream_t stream) {
  constexpr int kvb = (int)sizeof(TKV);
  if (splits > 0) {
    // A lane copies 4 elements at a time.
    const bool vec = aligned(a.k, a.skb, a.skt, a.skh, 4 * kvb, 4) &&
                     aligned(a.v, a.svb, a.svt, a.svh, 4 * kvb, 4);
    const int rows = a.Tq * (a.H / a.KvH);
    if (ws == nullptr || chunk < 1) return (int)cudaErrorInvalidValue;
    if (rows <= 2) return launch_decode<TQ, TKV, D, 2>(a, B, splits, chunk,
                                                       vec, ws, stream);
    if (rows <= 4) return launch_decode<TQ, TKV, D, 4>(a, B, splits, chunk,
                                                       vec, ws, stream);
    if (rows <= 8) return launch_decode<TQ, TKV, D, 8>(a, B, splits, chunk,
                                                       vec, ws, stream);
    if constexpr (D <= 128) {
      if (rows <= 16)
        return launch_decode<TQ, TKV, D, 16>(a, B, splits, chunk, vec, ws,
                                             stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = aligned(a.k, a.skb, a.skt, a.skh, 16, 16 / kvb) &&
                   aligned(a.v, a.svb, a.svt, a.svh, 16, 16 / kvb);
  if (bk == 32) return launch_prefill<TQ, TKV, D, 32>(a, B, vec, stream);
  if constexpr (Prefill<TKV, D, 64>::kSmem <= kMaxSmem) {  // not fp32 D 256
    if (bk == 64) return launch_prefill<TQ, TKV, D, 64>(a, B, vec, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
int launch_pair(const Args& a, int B, int D, int bk, int splits, int chunk,
                float* ws, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<TQ, TKV, 16>(a, B, bk, splits, chunk, ws, stream);
    case 32: return launch_d<TQ, TKV, 32>(a, B, bk, splits, chunk, ws, stream);
    case 64: return launch_d<TQ, TKV, 64>(a, B, bk, splits, chunk, ws, stream);
    case 128:
      return launch_d<TQ, TKV, 128>(a, B, bk, splits, chunk, ws, stream);
    case 256:
      return launch_d<TQ, TKV, 256>(a, B, bk, splits, chunk, ws, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TKV, int D>
int prefill_smem(int bk) {
  if (bk == 32) return Prefill<TKV, D, 32>::kSmem;
  if (bk == 64) return Prefill<TKV, D, 64>::kSmem;
  return -1;
}

template <typename TKV, int D>
int decode_smem(int rb) {
  switch (rb) {
    case 2: return Decode<TKV, D, 2>::kSmem;
    case 4: return Decode<TKV, D, 4>::kSmem;
    case 8: return Decode<TKV, D, 8>::kSmem;
    default: break;
  }
  if constexpr (D <= 128) {
    if (rb == 16) return Decode<TKV, D, 16>::kSmem;
  }
  return -1;
}

template <typename TKV>
int smem_of(int D, int n, bool decode) {
  switch (D) {
    case 16: return decode ? decode_smem<TKV, 16>(n) : prefill_smem<TKV, 16>(n);
    case 32: return decode ? decode_smem<TKV, 32>(n) : prefill_smem<TKV, 32>(n);
    case 64: return decode ? decode_smem<TKV, 64>(n) : prefill_smem<TKV, 64>(n);
    case 128:
      return decode ? decode_smem<TKV, 128>(n) : prefill_smem<TKV, 128>(n);
    case 256:
      return decode ? decode_smem<TKV, 256>(n) : prefill_smem<TKV, 256>(n);
    default: return -1;
  }
}

}  // namespace flash
}  // namespace repro

// Bytes of dynamic shared memory a prefill CTA takes at head dim D, KV
// tile bk and K/V element size kv_bytes (a test holds
// kernels/flash_attention.py smem_bytes, the planner's model, to it).
REPRO_EXPORT int flash_attention_smem_bytes(int D, int bk, int kv_bytes) {
  using namespace repro::flash;
  return kv_bytes == 2 ? smem_of<__nv_bfloat16>(D, bk, false)
                       : smem_of<float>(D, bk, false);
}

// Bytes of dynamic shared memory a decode CTA takes at head dim D for rb
// query rows (2, 4, 8 or 16) (held to decode_smem_bytes likewise).
REPRO_EXPORT int flash_decode_smem_bytes(int D, int rb, int kv_bytes) {
  using namespace repro::flash;
  return kv_bytes == 2 ? smem_of<__nv_bfloat16>(D, rb, true)
                       : smem_of<float>(D, rb, true);
}

// q, o [B, Tq, H, D] and k, v [B, Tk, KvH, D], each with (b, t, h) element
// strides and a contiguous last dim.  qo_dtype / kv_dtype: 0 fp32, 1 bf16
// (fp32 q with bf16 K/V reads a bf16 cache in place); kv_len [B] int32 or
// null; D in {16, 32, 64, 128, 256}.  splits > 0: the decode schedule, S
// splits of `chunk` keys over a workspace ws of B * H * Tq * S * (D + 2)
// floats (the partials, then their (m, l)), both kernels launched here;
// else prefill on KV tiles of bk keys (32, or 64 below D = 256).
REPRO_EXPORT int flash_attention(
    int qo_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    void* o, const int* kv_len, long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh, long long svb,
    long long svt, long long svh, long long sob, long long sot,
    long long soh, int B, int H, int KvH, int Tq, int Tk, int D,
    float scale, float softcap, int causal, int window, int bk, int splits,
    int chunk, void* ws, void* stream) {
  using namespace repro::flash;
  if (B < 1 || H < 1 || KvH < 1 || H % KvH != 0 || Tq < 1 || Tk < 1 ||
      splits < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   o,   kv_len, sqb, sqt,    sqh,
               skb, skt, skh, svb, svt,    svh, sob,    sot,
               soh, H,   KvH, Tq,  Tk,     scale, softcap, causal,
               window};
  cudaStream_t s = (cudaStream_t)stream;
  float* w = static_cast<float*>(ws);
  if (qo_dtype == 0 && kv_dtype == 0)
    return launch_pair<float, float>(a, B, D, bk, splits, chunk, w, s);
  if (qo_dtype == 0 && kv_dtype == 1)
    return launch_pair<float, __nv_bfloat16>(a, B, D, bk, splits, chunk, w,
                                             s);
  if (qo_dtype == 1 && kv_dtype == 1)
    return launch_pair<__nv_bfloat16, __nv_bfloat16>(a, B, D, bk, splits,
                                                     chunk, w, s);
  return (int)cudaErrorInvalidValue;
}
