// K15 flash attention: blocked online-softmax attention with causal masking,
// a sliding window, logit softcapping, grouped KV heads and a per-row KV
// length, in IEEE fp32 (no tensor cores).
//
// Replaces src/repro/kernels/flash_attention.py: _flash_kernel, gridded by
// flash_attention()'s pallas_call over (batch*heads, q blocks, kv blocks)
// with the running (m, l, acc) carried in VMEM scratch across the kv axis.
// Here one CTA takes one (batch row, query head, q block) and loops over the
// KV blocks itself, the running state in registers.
//
//   logits = (q . k) * scale;  softcap: tanh(logits / cap) * cap
//   row t of batch row b sits at position p = kv_len[b] - Tq + t (the
//   reference's decode end-alignment q_offset = Tk - Tq, per row); key c
//   is masked (-1e30, as the reference's NEG_INF) unless c <= p (causal)
//   and c > p - window (window); keys c >= kv_len[b] are not the row's and
//   weigh exactly 0.  A row whose every key is masked gets p = 1 on each,
//   the mean of V over its keys, as the reference's kernel gives.
//   kv_len[b] is clamped to 0..Tk, so no row reads past K or V; a row of
//   no keys (kv_len[b] <= 0) visits no block and writes 0.
//   Query head h reads KV head h / (H / KvH): the reference's GQA grouping
//   (models/attention.py q5), with no expanded copy of K or V.
//
// Operands are strided: q, o [B, T, H, D] and k, v [B, S, KvH, D] in
// elements of (b, t, h), the last dim contiguous, so the model's
// projections and its [B, S, KvH, D] cache go in as they lie, and
// ops.flash_attention's [B, H, T, D] as a permuted view.
//
// What bounds it: at prefill the two products, 4 * Tq * Tk_visible * D
// flops per (b, h) (at gemma2-9b's T = 4608, D = 256: ~0.17 TFLOP per
// layer, 2.6 ms at the fp32 rate of 67 TFLOP/s); at decode (Tq = 1) the
// bytes of the K/V cache.  What the design does: the Q tile (64 rows)
// stays in shared memory while K/V tiles of BK keys stream through once,
// stored transposed (K) or row-major (V) so that the 16 x 16 thread grid
// reads them without bank conflicts; each thread keeps a 4 x (BK/16) tile
// of logits and a 4 x (D/16) tile of the output in registers, and owns the
// same 4 rows in both, so the row statistics never leave the registers
// (a 16-lane shuffle reduces them).  BK comes from the shared-memory
// budget and the SM's occupancy (kernels/flash_attention.py plan_tiles:
// 32 keys at D = 128, where two CTAs then share an SM, else 64).  KV
// blocks that no row of the CTA can see (past the causal diagonal, before
// the window) are skipped -- except in a CTA holding a row with no valid
// key at all, which visits every block so that row's mean of V comes out
// as the reference's.
// Decode runs one useful row of 64 per CTA: slow against its bound, the
// work of a split-KV redesign.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace flash {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kTR = 16;            // thread rows of the 16 x 16 grid
constexpr int kTC = 16;            // thread columns
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store_f(float* p, float x) { *p = x; }
__device__ inline void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

template <int D, int BK>
constexpr int smem_floats() {
  return D * (kBQ + 1) + D * (BK + 1) + BK * D + kBQ * (BK + 1);
}

// Reduce over the 16 lanes of a thread row (lanes 0-15 or 16-31).
__device__ inline float row_max(float x) {
#pragma unroll
  for (int o = kTC / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float row_sum(float x) {
#pragma unroll
  for (int o = kTC / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TQ, typename TKV, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  constexpr int RI = kBQ / kTR;    // rows of a thread
  constexpr int CJ = BK / kTC;     // logit columns of a thread
  constexpr int DJ = D / kTC;      // output columns of a thread
  extern __shared__ float smem[];
  float* Qt = smem;                        // [D][kBQ + 1], q transposed
  float* Kt = Qt + D * (kBQ + 1);          // [D][BK + 1], k transposed
  float* Vs = Kt + D * (BK + 1);           // [BK][D]
  float* Ps = Vs + BK * D;                 // [kBQ][BK + 1], probabilities

  const int tid = threadIdx.x;
  const int tr = tid / kTC, tc = tid % kTC;
  // The last q blocks see the most keys under a causal mask: start them
  // first.
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KvH);
  const int kv_len =
      a.kv_len != nullptr ? min(max(a.kv_len[b], 0), a.Tk) : a.Tk;
  const int t0 = qb * kBQ;
  const int rows = min(kBQ, a.Tq - t0);
  const int p0 = kv_len - a.Tq + t0;       // position of the CTA's row 0
  const int p1 = p0 + rows - 1;

  int lo = 0, hi = kv_len;                 // keys the CTA visits
  if (!(a.causal && p0 < 0)) {             // every row has a valid key
    if (a.causal) hi = min(hi, p1 + 1);
    if (a.window > 0) lo = max(0, p0 - a.window + 1);
  }
  const int kb0 = lo / BK, kb1 = (hi + BK - 1) / BK;

  const TQ* q = static_cast<const TQ*>(a.q) + b * a.sqb + h * a.sqh;
  const TKV* k = static_cast<const TKV*>(a.k) + b * a.skb + kvh * a.skh;
  const TKV* v = static_cast<const TKV*>(a.v) + b * a.svb + kvh * a.svh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    Qt[d * (kBQ + 1) + r] =
        r < rows ? to_f(q[(long long)(t0 + r) * a.sqt + d]) : 0.f;
  }

  float acc[RI][DJ];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kb = kb0; kb < kb1; ++kb) {
    const int c0 = kb * BK;
    __syncthreads();           // the last block's readers of Kt/Vs/Ps are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const bool in = c0 + c < kv_len;
      const long long t = c0 + c;
      Kt[d * (BK + 1) + c] = in ? to_f(k[t * a.skt + d]) : 0.f;
      Vs[c * D + d] = in ? to_f(v[t * a.svt + d]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qt[d * (kBQ + 1) + tr + kTR * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Kt[d * (BK + 1) + tc + kTC * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int p = p0 + tr + kTR * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = c0 + tc + kTC * j;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        bool valid = true;
        if (a.causal) valid = valid && c <= p;
        if (a.window > 0) valid = valid && c > p - a.window;
        x = valid ? x : kNegInf;
        if (c >= kv_len) x = -INFINITY;    // not one of the row's keys
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // Every visited block holds at least one of the row's keys, so the
      // new max is finite (>= -1e30) and exp never sees inf - inf.
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        Ps[(tr + kTR * i) * (BK + 1) + tc + kTC * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(tr + kTR * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tc + kTC * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  TQ* o = static_cast<TQ*>(a.o) + b * a.sob + h * a.soh;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = tr + kTR * i;
    if (r < rows) {
      const float lsum = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        store_f(o + (long long)(t0 + r) * a.sot + tc + kTC * j,
                acc[i][j] / lsum);
    }
  }
}

template <typename TQ, typename TKV, int D, int BK>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto kernel = flash_kernel<TQ, TKV, D, BK>;
  const int bytes = smem_floats<D, BK>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
int launch_bk(const Args& a, int B, int bk, cudaStream_t stream) {
  if (bk == 64) return launch<TQ, TKV, D, 64>(a, B, stream);
  if (bk == 32) return launch<TQ, TKV, D, 32>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
int launch_d(const Args& a, int B, int D, int bk, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_bk<TQ, TKV, 16>(a, B, bk, stream);
    case 32: return launch_bk<TQ, TKV, 32>(a, B, bk, stream);
    case 64: return launch_bk<TQ, TKV, 64>(a, B, bk, stream);
    case 128: return launch_bk<TQ, TKV, 128>(a, B, bk, stream);
    case 256: return launch_bk<TQ, TKV, 256>(a, B, bk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace repro

// Bytes of dynamic shared memory a CTA takes at head dim D and KV tile bk
// (a test holds kernels/flash_attention.py smem_bytes, the planner's
// model, to it).
REPRO_EXPORT int flash_attention_smem_bytes(int D, int bk) {
  using namespace repro::flash;
  return (D * (kBQ + 1) + D * (bk + 1) + bk * D + kBQ * (bk + 1)) *
         (int)sizeof(float);
}

// q, o [B, Tq, H, D] and k, v [B, Tk, KvH, D], each with (b, t, h) element
// strides and a contiguous last dim.  qo_dtype / kv_dtype: 0 fp32, 1 bf16
// (fp32 q with bf16 K/V reads a bf16 cache in place); kv_len [B] int32 or
// null; D in {16, 32, 64, 128, 256}; bk in {32, 64}.
REPRO_EXPORT int flash_attention(
    int qo_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    void* o, const int* kv_len, long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh, long long svb,
    long long svt, long long svh, long long sob, long long sot,
    long long soh, int B, int H, int KvH, int Tq, int Tk, int D,
    float scale, float softcap, int causal, int window, int bk,
    void* stream) {
  using namespace repro::flash;
  if (B < 1 || H < 1 || KvH < 1 || H % KvH != 0 || Tq < 1 || Tk < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   o,   kv_len, sqb, sqt,    sqh,
               skb, skt, skh, svb, svt,    svh, sob,    sot,
               soh, H,   KvH, Tq,  Tk,     scale, softcap, causal,
               window};
  cudaStream_t s = (cudaStream_t)stream;
  if (qo_dtype == 0 && kv_dtype == 0)
    return launch_d<float, float>(a, B, D, bk, s);
  if (qo_dtype == 0 && kv_dtype == 1)
    return launch_d<float, __nv_bfloat16>(a, B, D, bk, s);
  if (qo_dtype == 1 && kv_dtype == 1)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(a, B, D, bk, s);
  return (int)cudaErrorInvalidValue;
}
