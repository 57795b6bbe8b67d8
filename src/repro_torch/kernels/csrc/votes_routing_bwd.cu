// K8 / K9 routing backward: (du, dW) of votes + routing-by-agreement, with
// neither the votes u_hat nor their cotangent d u_hat in global memory.
//
// Replaces src/repro/kernels/votes_routing.py: _resident_bwd_kernel (K8) and
// _streamed_bwd_kernel with _streamed_bwd_tail (K9), dispatched through
// _vr_grad.  Both compute the reference's stop-gradient VJP by one explicit
// formula (T = iters, c_t = softmax_j(b_t)):
//
//   ds_T     = squash_vjp(s_T, g)
//   db_T     = softmax_vjp(c_T, <u_hat, ds_T>)
//   ds_{T-1} = squash_vjp(s_{T-1}, sum_i u_hat . db_T)
//   d u_hat  = c_T (x) ds_T + c_{T-1} (x) ds_{T-1}
//   du = d u_hat . W,   dW[i] = sum_b d u_hat_b[i] (x) u_b[i]
//
// On the TPU one sequential grid carries the whole batch, so dW's sum over
// the batch accumulates in place.  On Hopper routing runs one CTA per
// sample (as in K3/K4), and dW[i] crosses samples, so the backward is two
// launches:
//
//   replay  one CTA per sample.  It replays the forward's iters + 1 fused
//           s+b passes (routing.cuh's schedule) on ONE logits slab in
//           shared memory; in pass T each row's b_{T-1} goes to global
//           memory just before the update overwrites it, and b_T right
//           after.  Then ONE pass merges the seed and the reverse step:
//           per votes block, db_T of its rows is formed and used at once
//           for dv_{T-1}, so no db_T slab is held.  It writes only the
//           logits b_{T-1}, b_T ([B, I, J] each) and ds_{T-1}, ds_T.
//           K8 (resident) computes the sample's votes once into shared
//           memory; K9 (streamed) recomputes each votes block from W on
//           every pass (iters + 2 passes), keeping u, the logits and s.
//   emit    one CTA per capsule i, all samples: it rebuilds the couplings
//           c_T, c_{T-1} from the logits and d u_hat[b, i, :] in shared
//           memory, chunk by chunk of samples, then writes du[b, i, :] and
//           dW[i], summing the batch inside the CTA in sample order
//           (deterministic, no atomics).  d u_hat needs no votes at all.
//
// What bounds it: at MNIST width (u [16, 1152, 8], W [1152, 160, 8]) the
// function needs the votes once plus the routing and emit arithmetic,
// about 0.22 GFLOP, against 13 MB that it must move (u, W and g read, du
// and dW written), so its bound is the bytes: ~0.004 ms at 3.35 TB/s.
// K9's schedule does 5 votes computations per sample (about 0.40 GFLOP,
// ~0.006 ms of fp32 at 67 TFLOP/s), the price of not holding the votes.
// One CTA per sample keeps only 16 SMs busy in the replay at batch 16, as
// in K4; the emit spreads over 1152 CTAs.

#include "routing.cuh"

namespace repro {

constexpr int kEmitChunk = 16;   // execplan.EMIT_CHUNK

// ds = squash_vjp(s, g) over one capsule of D floats (ref.squash_vjp):
// ds = f g + 2 f'(q) <g, s> s,  q = ||s||^2.
__device__ inline void squash_vjp_into(const float* s, const float* g,
                                       float* ds, int D) {
  float q = 0.f, gs = 0.f;
  for (int d = 0; d < D; ++d) {
    q = fmaf(s[d], s[d], q);
    gs = fmaf(g[d], s[d], gs);
  }
  const float opq = 1.f + q;
  const float a = q / opq;
  const float r = rsqrtf(q + kSquashEps);
  const float f = a * r;
  const float df = r / (opq * opq) - 0.5f * a * r * r * r;
  const float k = 2.f * df * gs;
  for (int d = 0; d < D; ++d) ds[d] = f * g[d] + k * s[d];
}

__device__ inline void softmax_row(const float* b, float* c, int J) {
  float m = -INFINITY;
  for (int j = 0; j < J; ++j) m = fmaxf(m, b[j]);
  float sum = 0.f;
  for (int j = 0; j < J; ++j) {
    const float e = expf(b[j] - m);
    c[j] = e;
    sum += e;
  }
  for (int j = 0; j < J; ++j) c[j] = c[j] / sum;
}

__global__ void __launch_bounds__(kThreads)
routing_bwd_replay_kernel(const float* __restrict__ u,
                          const float* __restrict__ W,
                          const float* __restrict__ g,
                          float* __restrict__ b_prev_out,
                          float* __restrict__ b_last_out,
                          float* __restrict__ ds_out, int B, int I, int C,
                          int J, int D, int iters, int resident,
                          int block_i) {
  extern __shared__ float smem[];
  const int jd = J * D, ld = jd + 1;
  const int smp = blockIdx.x;
  const int step = resident ? I : block_i;
  float* u_s = smem;               // [I][C]
  float* b = u_s + I * C;          // [I][J] logits, one slab
  float* s = b + I * J;            // [J*D] s_t accumulator
  float* v = s + jd;               // [J*D] squash(s_t)
  float* s_prev = v + jd;          // [J*D] s_{T-1}
  float* ds = s_prev + jd;         // [J*D] ds_T
  float* dv = ds + jd;             // [J*D] dv_{T-1} accumulator
  float* uh = dv + jd;             // [step][J*D + 1] votes rows
  float* c = uh + step * ld;       // [step][J] couplings, then db_T

  const float* ub = u + (size_t)smp * I * C;
  for (int e = threadIdx.x; e < I * C; e += blockDim.x) u_s[e] = ub[e];
  for (int e = threadIdx.x; e < I * J; e += blockDim.x) b[e] = 0.f;
  __syncthreads();
  if (resident) {
    for (int i0 = 0; i0 < I; i0 += block_i)
      votes_rows(u_s + i0 * C, W + (size_t)i0 * jd * C, min(block_i, I - i0),
                 jd, C, uh + i0 * ld, ld);
    __syncthreads();
  }
  float* bp = b_prev_out + (size_t)smp * I * J;
  float* bl = b_last_out + (size_t)smp * I * J;

  // Replay: passes t = 0 .. T, the forward's fused s+b schedule.
  for (int t = 0; t <= iters; ++t) {
    for (int n = threadIdx.x; n < jd; n += blockDim.x) s[n] = 0.f;
    __syncthreads();
    for (int i0 = 0; i0 < I; i0 += step) {
      const int rows = min(step, I - i0);
      if (!resident) {
        votes_rows(u_s + i0 * C, W + (size_t)i0 * jd * C, rows, jd, C, uh,
                   ld);
        __syncthreads();
      }
      const float* vb = resident ? uh + i0 * ld : uh;
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        const float* ur = vb + r * ld;
        float* br = b + (i0 + r) * J;
        if (t > 0) {
          if (t == iters)
            for (int j = 0; j < J; ++j) bp[(i0 + r) * J + j] = br[j];
          for (int j = 0; j < J; ++j) {
            float a = 0.f;
            for (int d = 0; d < D; ++d)
              a = fmaf(ur[j * D + d], v[j * D + d], a);
            br[j] += a;
          }
        }
        if (t == iters)
          for (int j = 0; j < J; ++j) bl[(i0 + r) * J + j] = br[j];
        softmax_row(br, c + r * J, J);
      }
      __syncthreads();
      for (int n = threadIdx.x; n < jd; n += blockDim.x) {
        const int j = n / D;
        float a = s[n];
        for (int r = 0; r < rows; ++r) a = fmaf(c[r * J + j], vb[r * ld + n], a);
        s[n] = a;
      }
      __syncthreads();
    }
    for (int n = threadIdx.x; n < jd; n += blockDim.x)
      if (t == iters - 1) s_prev[n] = s[n];
    for (int j = threadIdx.x; j < J; j += blockDim.x)
      squash_into(s + j * D, v + j * D, D);
    __syncthreads();
  }

  // Seed: ds_T from the output cotangent (s now holds s_T).
  const float* gb = g + (size_t)smp * jd;
  for (int j = threadIdx.x; j < J; j += blockDim.x)
    squash_vjp_into(s + j * D, gb + j * D, ds + j * D, D);
  for (int n = threadIdx.x; n < jd; n += blockDim.x) dv[n] = 0.f;
  __syncthreads();
  float* ds_last = ds_out + ((size_t)B + smp) * jd;
  float* ds_prev = ds_out + (size_t)smp * jd;
  for (int n = threadIdx.x; n < jd; n += blockDim.x) ds_last[n] = ds[n];

  // Seed + reverse in one pass: db_T of each block's rows, used at once.
  for (int i0 = 0; i0 < I; i0 += step) {
    const int rows = min(step, I - i0);
    if (!resident) {
      votes_rows(u_s + i0 * C, W + (size_t)i0 * jd * C, rows, jd, C, uh, ld);
      __syncthreads();
    }
    const float* vb = resident ? uh + i0 * ld : uh;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* ur = vb + r * ld;
      float* cr = c + r * J;
      softmax_row(b + (i0 + r) * J, cr, J);
      // db_j = c_j (dc_j - sum_k c_k dc_k),  dc_j = <u_hat[r, j], ds_T[j]>;
      // dc is formed twice rather than held in a second slab.
      float cdc = 0.f;
      for (int j = 0; j < J; ++j) {
        float dc = 0.f;
        for (int d = 0; d < D; ++d) dc = fmaf(ur[j * D + d], ds[j * D + d], dc);
        cdc = fmaf(cr[j], dc, cdc);
      }
      for (int j = 0; j < J; ++j) {
        float dc = 0.f;
        for (int d = 0; d < D; ++d) dc = fmaf(ur[j * D + d], ds[j * D + d], dc);
        cr[j] = cr[j] * (dc - cdc);
      }
    }
    __syncthreads();
    for (int n = threadIdx.x; n < jd; n += blockDim.x) {
      const int j = n / D;
      float a = dv[n];
      for (int r = 0; r < rows; ++r) a = fmaf(vb[r * ld + n], c[r * J + j], a);
      dv[n] = a;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < J; j += blockDim.x)
    squash_vjp_into(s_prev + j * D, dv + j * D, ds_prev + j * D, D);
}

// One CTA per capsule i: d u_hat[b, i, :] = c_T (x) ds_T + c_{T-1} (x)
// ds_{T-1} for every sample b (kEmitChunk samples at a time), then
// du[b, i, :] = d u_hat . W[i] and dW[i] = sum_b d u_hat (x) u[b, i].
__global__ void __launch_bounds__(kThreads)
routing_bwd_emit_kernel(const float* __restrict__ u,
                        const float* __restrict__ W,
                        const float* __restrict__ b_prev,
                        const float* __restrict__ b_last,
                        const float* __restrict__ ds_all,
                        float* __restrict__ du, float* __restrict__ dW, int B,
                        int I, int C, int J, int D) {
  extern __shared__ float smem[];
  const int jd = J * D, i = blockIdx.x;
  float* w_s = smem;                     // [J*D][C] W[i]
  float* dw_s = w_s + jd * C;            // [J*D][C] dW[i] accumulator
  float* u_c = dw_s + jd * C;            // [chunk][C]
  float* c_c = u_c + kEmitChunk * C;     // [chunk][2][J]: c_T, c_{T-1}
  float* duh = c_c + kEmitChunk * 2 * J; // [chunk][J*D]
  const float* Wi = W + (size_t)i * jd * C;
  for (int e = threadIdx.x; e < jd * C; e += blockDim.x) {
    w_s[e] = Wi[e];
    dw_s[e] = 0.f;
  }
  const float* ds_prev = ds_all;
  const float* ds_last = ds_all + (size_t)B * jd;
  for (int b0 = 0; b0 < B; b0 += kEmitChunk) {
    const int nb = min(kEmitChunk, B - b0);
    __syncthreads();                     // the previous chunk is consumed
    for (int e = threadIdx.x; e < nb * C; e += blockDim.x)
      u_c[e] = u[((size_t)(b0 + e / C) * I + i) * C + e % C];
    for (int e = threadIdx.x; e < 2 * nb; e += blockDim.x) {
      const int bb = e / 2, last = e % 2 == 0;
      const float* logits = last ? b_last : b_prev;
      softmax_row(logits + ((size_t)(b0 + bb) * I + i) * J,
                  c_c + e * J, J);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nb * jd; e += blockDim.x) {
      const int bb = e / jd, n = e % jd, j = n / D;
      const size_t row = (size_t)(b0 + bb) * jd + n;
      duh[e] = fmaf(c_c[(2 * bb) * J + j], ds_last[row],
                    c_c[(2 * bb + 1) * J + j] * ds_prev[row]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nb * C; e += blockDim.x) {
      const int bb = e / C, cc = e % C;
      float a = 0.f;
      for (int n = 0; n < jd; ++n)
        a = fmaf(duh[bb * jd + n], w_s[n * C + cc], a);
      du[((size_t)(b0 + bb) * I + i) * C + cc] = a;
    }
    for (int e = threadIdx.x; e < jd * C; e += blockDim.x) {
      const int n = e / C, cc = e % C;
      float a = dw_s[e];
      for (int bb = 0; bb < nb; ++bb)
        a = fmaf(duh[bb * jd + n], u_c[bb * C + cc], a);
      dw_s[e] = a;
    }
  }
  __syncthreads();
  float* dWi = dW + (size_t)i * jd * C;
  for (int e = threadIdx.x; e < jd * C; e += blockDim.x) dWi[e] = dw_s[e];
}

cudaError_t launch_routing_bwd(bool resident, const float* u, const float* W,
                               const float* g, float* b_prev, float* b_last,
                               float* ds, float* du, float* dW, int B, int I,
                               int C, int J, int D, int iters, int block_i,
                               int smem, int emit_smem, cudaStream_t s) {
  if (B < 1 || I < 1 || iters < 1 || block_i < 1 || block_i > I)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      routing_bwd_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  routing_bwd_replay_kernel<<<B, kThreads, smem, s>>>(
      u, W, g, b_prev, b_last, ds, B, I, C, J, D, iters, resident ? 1 : 0,
      block_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(routing_bwd_emit_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             emit_smem);
  if (err != cudaSuccess) return err;
  routing_bwd_emit_kernel<<<I, kThreads, emit_smem, s>>>(
      u, W, b_prev, b_last, ds, du, dW, B, I, C, J, D);
  return cudaGetLastError();
}

}  // namespace repro

// u [B, I, C], W [I, J*D, C], g [B, J*D] -> du [B, I, C], dW [I, J*D, C].
// Scratch in global memory: b_prev, b_last [B, I, J] (the logits b_{T-1},
// b_T) and ds [2, B, J*D] (ds_{T-1}, ds_T).  smem_bytes / emit_smem are the
// plan's footprints (execplan.votes_routing_bwd_smem / routing_bwd_emit_smem).
#define REPRO_ROUTING_BWD(NAME, RESIDENT)                                     \
  REPRO_EXPORT int NAME(const float* u, const float* W, const float* g,       \
                        float* b_prev, float* b_last, float* ds, float* du,   \
                        float* dW, int B, int I, int C, int J, int D,         \
                        int iters, int block_i, int smem_bytes,               \
                        int emit_smem, void* stream) {                        \
    return repro::launch_routing_bwd(RESIDENT, u, W, g, b_prev, b_last, ds,   \
                                     du, dW, B, I, C, J, D, iters, block_i,   \
                                     smem_bytes, emit_smem,                   \
                                     (cudaStream_t)stream);                   \
  }

REPRO_ROUTING_BWD(routing_bwd_resident_f32, true)    // K8
REPRO_ROUTING_BWD(routing_bwd_streamed_f32, false)   // K9
