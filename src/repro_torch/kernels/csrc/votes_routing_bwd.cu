// K8 / K9 routing backward: (du, dW) of votes + routing-by-agreement, with
// neither the votes u_hat nor their cotangent d u_hat in global memory.
//
// Replaces src/repro/kernels/votes_routing.py: _resident_bwd_kernel (K8),
// _streamed_bwd_kernel (K9) and _streamed_2pass_bwd_kernel (K13), each with
// _streamed_bwd_tail where it has one, dispatched through _vr_grad.  All
// compute the reference's stop-gradient VJP by one explicit formula
// (T = iters, c_t = softmax_j(b_t)):
//
//   ds_T     = squash_vjp(s_T, g)
//   db_T     = softmax_vjp(c_T, <u_hat, ds_T>)
//   ds_{T-1} = squash_vjp(s_{T-1}, sum_i u_hat . db_T)
//   d u_hat  = c_T (x) ds_T + c_{T-1} (x) ds_{T-1}
//   du = d u_hat . W,   dW[i] = sum_b d u_hat_b[i] (x) u_b[i]
//
// On the TPU one sequential grid carries the whole batch, so dW's sum over
// the batch accumulates in place.  On Hopper routing runs per sample, and
// dW[i] crosses samples, so the backward is two launches:
//
//   replay  one CLUSTER of cs CTAs per sample (routing_bwd_cluster_kernel
//           below).  It replays the forward's iters + 1 fused s+b passes
//           (route_cluster's schedule) on ONE logits slab; in pass T each
//           row's b_{T-1} goes to global memory just before the update
//           overwrites it, and b_T right after.  Then ONE pass merges the
//           seed and the reverse step: per votes block, db_T of its rows is
//           formed and used at once for dv_{T-1}, so no db_T slab is held.
//           It writes only the logits b_{T-1}, b_T ([B, I, J] each) and
//           ds_{T-1}, ds_T.  On routing_cluster.cuh's core each CTA of the
//           cluster owns a block of I/cs rows and keeps their u and logits,
//           and their votes computed once (K8, "resident", where they fit:
//           the SVHN ResCaps halves and ClassCaps, MNIST's ClassCaps at
//           cs >= 8) or recomputed block by block from W on every pass
//           (K9, "streamed", iters + 2 passes); a row takes a warp; s_t and
//           the reverse pass's dv are reduced through distributed shared
//           memory in rank order.  K13 (kTwoPass, the oracle) is K9 on the
//           unfused schedule: each pass after the first a b-pass and an
//           s-pass (2 * iters + 2 votes passes), the same sums in the same
//           order, so its du and dW equal K9's bit for bit at the same
//           cluster size and i-tile.
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
// At the SVHN halves (u [16, 32, 8], W [32, 256, 8]) K8's byte bound is
// 0.17 us, below any launch: there it is bound by latency, the replay's
// chain of passes and barriers.  One CTA per sample (the earlier K8, K9 and
// K13) kept only 16 SMs busy at batch 16, with a thread a row (32 of 256
// threads at work at the halves, each through J*D serial FMAs); the
// cluster spreads a sample over up to 16 SMs with a warp a row, and the
// emit over I CTAs.

#include "routing_cluster.cuh"

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

// The shared memory of one K8/K9 cluster CTA, in floats
// (execplan.routing_bwd_cluster_smem models the same sum): the votes rows
// with their couplings, then u and the logits of the CTA's rows, and s, v,
// s_{T-1}, ds_T, dv and the two partials.
struct ClusterBwdLayout {
  int rows, vrows, total;
};

__host__ __device__ inline ClusterBwdLayout cluster_bwd_layout(
    int I, int C, int J, int D, int cs, int resident, int block_i) {
  ClusterBwdLayout L;
  L.rows = (I + cs - 1) / cs;
  L.vrows = resident ? L.rows : min(block_i, L.rows);
  const int jd = J * D;
  L.total = L.vrows * (jd + 1 + J) + L.rows * (C + J) + 7 * jd;
  return L;
}

// K8's and K9's replay on the cluster core: the sample's rows split into
// cs blocks of ceil(I / cs) (the last ragged), one per CTA.  The forward
// passes run as in K3 and K5 (route_cluster), writing the rows' b_{T-1} and
// b_T in pass T; then every CTA forms ds_T = squash_vjp(s_T, g) (the same
// in each), its rows' db_T and its partial of dv, which is reduced in rank
// order like s; rank 0 writes ds_{T-1} = squash_vjp(s_{T-1}, dv) and ds_T.
// K13's replay (kTwoPass) runs the passes on the unfused schedule.  Held
// to 128 registers a thread, so that two CTAs of 113 KB (MNIST's resident
// rows at cs = 8) share an SM.
template <bool kTwoPass>
__global__ void __launch_bounds__(kThreads, 2)
routing_bwd_cluster_kernel(const float* __restrict__ u,
                           const float* __restrict__ W,
                           const float* __restrict__ g, float* b_prev_out,
                           float* b_last_out, float* __restrict__ ds_out,
                           int B, int I, int C, int J, int D, int iters,
                           int resident, int block_i) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int smp = blockIdx.x / cs;
  const int jd = J * D, ld = jd + 1;
  const ClusterBwdLayout L = cluster_bwd_layout(I, C, J, D, cs, resident,
                                                block_i);
  const int i0 = min(I, rank * L.rows);
  const int n = min(I, i0 + L.rows) - i0;
  const OwnedRows own{n, i0, max(n, 1), 0};
  ClusterScratch sc;
  sc.uh = smem;                                 // [vrows][J*D + 1]
  sc.c = sc.uh + L.vrows * ld;                  // [vrows][J]
  float* u_s = sc.c + L.vrows * J;              // [rows][C]
  sc.b = u_s + L.rows * C;                      // [rows][J]
  sc.s = sc.b + L.rows * J;
  sc.v = sc.s + jd;
  float* s_prev = sc.v + jd;
  float* ds = s_prev + jd;
  float* dv = ds + jd;
  sc.part = dv + jd;                            // [2][J*D]

  const float* ub = u + ((size_t)smp * I + i0) * C;
  for (int e = threadIdx.x; e < n * C; e += blockDim.x) u_s[e] = ub[e];
  __syncthreads();
  route_cluster(cl, sc, VotesOfW{u_s, W, own, C}, own, J, D, iters,
                resident != 0, block_i, s_prev,
                b_prev_out + (size_t)smp * I * J,
                b_last_out + (size_t)smp * I * J, kTwoPass);

  // Seed + reverse: the partial of dv goes to the half of the partials that
  // pass T did not use (see routing_cluster.cuh).
  const float* gb = g + (size_t)smp * jd;
  for (int j = threadIdx.x; j < J; j += blockDim.x)
    squash_vjp_into(sc.s + j * D, gb + j * D, ds + j * D, D);
  float* part = sc.part + ((iters + 1) & 1) * jd;
  for (int e = threadIdx.x; e < jd; e += blockDim.x) part[e] = 0.f;
  __syncthreads();
  const int step = resident ? max(n, 1) : block_i;
  for (int l0 = 0; l0 < n; l0 += step) {
    const int rows = min(step, n - l0);
    if (!resident) {
      votes_owned(u_s, W, own, l0, rows, jd, C, sc.uh, ld);
      __syncthreads();
    }
    reverse_owned(resident ? sc.uh + l0 * ld : sc.uh, ld, l0, rows, sc.b,
                  sc.c, ds, part, J, D);
  }
  cluster_sum(cl, part, dv, jd);
  if (rank == 0) {
    float* ds_prev = ds_out + (size_t)smp * jd;
    float* ds_last = ds_out + ((size_t)B + smp) * jd;
    for (int j = threadIdx.x; j < J; j += blockDim.x)
      squash_vjp_into(s_prev + j * D, dv + j * D, ds_prev + j * D, D);
    for (int e = threadIdx.x; e < jd; e += blockDim.x) ds_last[e] = ds[e];
  }
  cl.sync();                      // no CTA leaves while a peer reads it
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

cudaError_t launch_emit(const float* u, const float* W, const float* b_prev,
                        const float* b_last, const float* ds, float* du,
                        float* dW, int B, int I, int C, int J, int D,
                        int emit_smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      routing_bwd_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      emit_smem);
  if (err != cudaSuccess) return err;
  routing_bwd_emit_kernel<<<I, kThreads, emit_smem, s>>>(
      u, W, b_prev, b_last, ds, du, dW, B, I, C, J, D);
  return cudaGetLastError();
}

// Checks and launches the replay on B clusters of cs CTAs (K8, K9, or
// K13 with two_pass and streamed votes), then the emit.
cudaError_t launch_cluster_bwd(const float* u, const float* W, const float* g,
                               float* b_prev, float* b_last, float* ds,
                               float* du, float* dW, int B, int I, int C,
                               int J, int D, int iters, int resident,
                               int block_i, int cs, int smem_bytes,
                               int emit_smem, int two_pass,
                               cudaStream_t s) {
  if (B < 1 || I < 1 || iters < 1 || block_i < 1 || cs < 1 || cs > 16 ||
      (two_pass && resident) ||
      cluster_bwd_layout(I, C, J, D, cs, resident, block_i).total *
              (int)sizeof(float) != smem_bytes)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_clusters(
      two_pass ? routing_bwd_cluster_kernel<true>
               : routing_bwd_cluster_kernel<false>,
      B, cs, smem_bytes, s, u, W, g, b_prev, b_last, ds, B, I, C, J, D,
      iters, resident, block_i);
  if (err != cudaSuccess) return err;
  return launch_emit(u, W, b_prev, b_last, ds, du, dW, B, I, C, J, D,
                     emit_smem, s);
}

}  // namespace repro

// Every entry: u [B, I, C], W [I, J*D, C], g [B, J*D] -> du [B, I, C],
// dW [I, J*D, C].  Scratch in global memory: b_prev, b_last [B, I, J] (the
// logits b_{T-1}, b_T) and ds [2, B, J*D] (ds_{T-1}, ds_T).  smem_bytes /
// emit_smem are the plan's footprints (execplan.routing_bwd_cluster_smem /
// routing_bwd_emit_smem).

// The kernel's own shared-memory layout in bytes (execplan models it).
REPRO_EXPORT int routing_bwd_cluster_smem_bytes(int I, int C, int J, int D,
                                                int cs, int resident,
                                                int block_i) {
  return repro::cluster_bwd_layout(I, C, J, D, cs, resident, block_i).total *
         (int)sizeof(float);
}

// K8 (resident != 0: the CTAs' votes in shared memory) and K9: the replay
// on B clusters of cs CTAs, then the emit; smem_bytes must equal the
// kernel's layout.
REPRO_EXPORT int routing_bwd_cluster_f32(const float* u, const float* W,
                                         const float* g, float* b_prev,
                                         float* b_last, float* ds, float* du,
                                         float* dW, int B, int I, int C,
                                         int J, int D, int iters,
                                         int resident, int block_i, int cs,
                                         int smem_bytes, int emit_smem,
                                         void* stream) {
  return repro::launch_cluster_bwd(u, W, g, b_prev, b_last, ds, du, dW, B, I,
                                   C, J, D, iters, resident, block_i, cs,
                                   smem_bytes, emit_smem, 0,
                                   (cudaStream_t)stream);
}

// out = {max active clusters, static shared bytes, max dynamic shared
// bytes, registers a thread} of the replay at these sizes.
REPRO_EXPORT int routing_bwd_cluster_occupancy(int I, int C, int J, int D,
                                               int cs, int resident,
                                               int block_i, int* out) {
  using namespace repro;
  return cluster_occupancy(
      routing_bwd_cluster_kernel<false>, cs,
      cluster_bwd_layout(I, C, J, D, cs, resident, block_i).total *
          (int)sizeof(float),
      out);
}

// K13, the unfused oracle: K9's streamed replay (block_i rows at a time) on
// B clusters of cs CTAs with each pass after the first a b-pass and an
// s-pass, then the emit.
REPRO_EXPORT int routing_bwd_2pass_f32(const float* u, const float* W,
                                       const float* g, float* b_prev,
                                       float* b_last, float* ds, float* du,
                                       float* dW, int B, int I, int C, int J,
                                       int D, int iters, int block_i, int cs,
                                       int smem_bytes, int emit_smem,
                                       void* stream) {
  return repro::launch_cluster_bwd(u, W, g, b_prev, b_last, ds, du, dW, B, I,
                                   C, J, D, iters, 0, block_i, cs,
                                   smem_bytes, emit_smem, 1,
                                   (cudaStream_t)stream);
}
