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
// CIFAR-10's full-width halves (1024 capsules of 8D routed to 1024 x 8D,
// J*D = 8192) fit neither launch in a CTA.  K9g, the replay's
// "streamed-global" placement, keeps the rows' logits in device memory --
// the sample's rows of the b_T slab it writes anyway, so pass T's update
// leaves b_T in place -- and, since s_T and v_T are spent once ds_T is
// formed, puts ds_T where s_T was and dv where v_T was: five [J*D]
// vectors instead of seven (202,756 B at 16 CTAs a sample, block_i 1).
// The arithmetic and its order are K9's, so every rank holds the same v
// and ds bits, and the output equals K9's bit for bit where both run.
// The emit, whose W[i] and dW[i] alone take 512 KB there, splits over
// blocks of whole classes of the J*D columns (execplan.emit_columns):
// CTA (i, k) rebuilds its classes' couplings from the row's whole logits
// (the same max and sum as softmax_row, so the same bits), writes dW[i]
// over its columns (each element the same sum as the unsplit emit's) and
// its partial of du[b, i, :] over them, a warp a (sample, c) pair; a
// second launch adds the partials in column-block order.  No atomics, so
// a second launch repeats the bits; du's order differs from the unsplit
// emit's, which is why the split is taken only where the row does not
// fit.
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

// The logits of one row, softmax_row's arithmetic, only the nj classes
// from j0 written: the same max and the same sum in the same order, so
// the same bits for those classes.
__device__ inline void softmax_cols(const float* b, float* c, int J, int j0,
                                    int nj) {
  float m = -INFINITY;
  for (int j = 0; j < J; ++j) m = fmaxf(m, b[j]);
  float sum = 0.f;
  for (int j = 0; j < J; ++j) sum += expf(b[j] - m);
  for (int j = 0; j < nj; ++j) c[j] = expf(b[j0 + j] - m) / sum;
}

// The shared memory of one K8/K9 cluster CTA, in floats
// (execplan.routing_bwd_cluster_smem models the same sum): the votes rows
// with their couplings, then u and the logits of the CTA's rows, and s, v,
// s_{T-1}, ds_T, dv and the two partials.  K9g (logits_global) keeps no
// logits and five vectors: s_T / ds_T, v_T / dv, s_{T-1} and the partials.
struct ClusterBwdLayout {
  int rows, vrows, total;
};

__host__ __device__ inline ClusterBwdLayout cluster_bwd_layout(
    int I, int C, int J, int D, int cs, int resident, int block_i,
    int logits_global = 0) {
  ClusterBwdLayout L;
  L.rows = (I + cs - 1) / cs;
  L.vrows = resident ? L.rows : min(block_i, L.rows);
  const int jd = J * D;
  L.total = logits_global
                ? L.vrows * (jd + 1 + J) + L.rows * C + 5 * jd
                : L.vrows * (jd + 1 + J) + L.rows * (C + J) + 7 * jd;
  return L;
}

// One emit CTA's shared memory in floats (execplan.routing_bwd_emit_smem):
// W[i] and dW[i] over `cols` columns, then per chunk of samples u[i], the
// couplings of the columns' classes and the columns' d u_hat.
__host__ __device__ inline int emit_layout(int C, int J, int D, int cols) {
  return 2 * cols * C + kEmitChunk * (C + 2 * (cols / D) + cols);
}

// K8's and K9's replay on the cluster core: the sample's rows split into
// cs blocks of ceil(I / cs) (the last ragged), one per CTA.  The forward
// passes run as in K3 and K5 (route_cluster), writing the rows' b_{T-1} and
// b_T in pass T; then every CTA forms ds_T = squash_vjp(s_T, g) (the same
// in each), its rows' db_T and its partial of dv, which is reduced in rank
// order like s; rank 0 writes ds_{T-1} = squash_vjp(s_{T-1}, dv) and ds_T.
// K13's replay (kTwoPass) runs the passes on the unfused schedule; K9g's
// (kGlobal) keeps the rows' logits in their rows of b_last_out, the b_T
// slab, and ds_T / dv in s_T's / v_T's place.  Held to 128 registers a
// thread, so that two CTAs of 113 KB (MNIST's resident rows at cs = 8)
// share an SM.
template <bool kTwoPass, bool kGlobal>
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
                                                block_i, kGlobal);
  const int i0 = min(I, rank * L.rows);
  const int n = min(I, i0 + L.rows) - i0;
  const OwnedRows own{n, i0, max(n, 1), 0};
  ClusterScratch sc;
  sc.uh = smem;                                 // [vrows][J*D + 1]
  sc.c = sc.uh + L.vrows * ld;                  // [vrows][J]
  float* u_s = sc.c + L.vrows * J;              // [rows][C]
  float* b_last = b_last_out + (size_t)smp * I * J;
  if (kGlobal) {
    sc.b = b_last + (size_t)i0 * J;             // the rows of the b_T slab
    sc.s = u_s + L.rows * C;
  } else {
    sc.b = u_s + L.rows * C;                    // [rows][J]
    sc.s = sc.b + L.rows * J;
  }
  sc.v = sc.s + jd;
  float* s_prev = sc.v + jd;
  float* ds = kGlobal ? sc.s : s_prev + jd;     // s_T is spent once ds_T is
  float* dv = kGlobal ? sc.v : ds + jd;         // formed, v_T before dv
  sc.part = kGlobal ? s_prev + jd : dv + jd;    // [2][J*D]

  const float* ub = u + ((size_t)smp * I + i0) * C;
  for (int e = threadIdx.x; e < n * C; e += blockDim.x) u_s[e] = ub[e];
  __syncthreads();
  // Under kGlobal pass T's update leaves b_T in the slab itself.
  route_cluster(cl, sc, VotesOfW{u_s, W, own, C}, own, J, D, iters,
                resident != 0, block_i, s_prev,
                b_prev_out + (size_t)smp * I * J, kGlobal ? nullptr : b_last,
                kTwoPass);

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

// The votes computations of one replay CTA: route_cluster's, then the
// merged seed + reverse pass above brings streamed votes in once more.
__host__ __device__ constexpr int replay_votes(bool resident, bool two_pass,
                                               int iters) {
  return route_votes(resident, two_pass, iters) + (resident ? 0 : 1);
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

// The emit split over column blocks of `cols` (whole classes) of J*D: CTA
// (i = blockIdx.x, k = blockIdx.y) takes the columns [k cols, (k+1) cols)
// of capsule i for every sample, kEmitChunk samples at a time: dW[i] over
// them, and du_part[k][b, i, :] = sum over them of d u_hat . W[i], a warp a
// (sample, c) pair, its lanes striding the columns, then a shuffle sum.
__global__ void __launch_bounds__(kThreads)
routing_bwd_emit_cols_kernel(const float* __restrict__ u,
                             const float* __restrict__ W,
                             const float* __restrict__ b_prev,
                             const float* __restrict__ b_last,
                             const float* __restrict__ ds_all,
                             float* __restrict__ du_part,
                             float* __restrict__ dW, int B, int I, int C,
                             int J, int D, int cols) {
  extern __shared__ float smem[];
  const int jd = J * D, i = blockIdx.x, k = blockIdx.y;
  const int n0 = k * cols, nj = cols / D, j0 = n0 / D;
  float* w_s = smem;                      // [cols][C] W[i, n0:n0+cols]
  float* dw_s = w_s + cols * C;           // [cols][C] dW accumulator
  float* u_c = dw_s + cols * C;           // [chunk][C]
  float* c_c = u_c + kEmitChunk * C;      // [chunk][2][nj]: c_T, c_{T-1}
  float* duh = c_c + kEmitChunk * 2 * nj; // [chunk][cols]
  const float* Wi = W + ((size_t)i * jd + n0) * C;
  for (int e = threadIdx.x; e < cols * C; e += blockDim.x) {
    w_s[e] = Wi[e];
    dw_s[e] = 0.f;
  }
  const float* ds_prev = ds_all;
  const float* ds_last = ds_all + (size_t)B * jd;
  float* part = du_part + (size_t)k * B * I * C;
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int b0 = 0; b0 < B; b0 += kEmitChunk) {
    const int nb = min(kEmitChunk, B - b0);
    __syncthreads();                      // the previous chunk is consumed
    for (int e = threadIdx.x; e < nb * C; e += blockDim.x)
      u_c[e] = u[((size_t)(b0 + e / C) * I + i) * C + e % C];
    for (int e = threadIdx.x; e < 2 * nb; e += blockDim.x) {
      const int bb = e / 2, last = e % 2 == 0;
      const float* logits = last ? b_last : b_prev;
      softmax_cols(logits + ((size_t)(b0 + bb) * I + i) * J, c_c + e * nj, J,
                   j0, nj);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nb * cols; e += blockDim.x) {
      const int bb = e / cols, n = e % cols, j = n / D;
      const size_t row = (size_t)(b0 + bb) * jd + n0 + n;
      duh[e] = fmaf(c_c[(2 * bb) * nj + j], ds_last[row],
                    c_c[(2 * bb + 1) * nj + j] * ds_prev[row]);
    }
    __syncthreads();
    for (int p = threadIdx.x / 32; p < nb * C; p += nwarps) {
      const int bb = p / C, cc = p % C;
      float a = 0.f;
      for (int n = lane; n < cols; n += 32)
        a = fmaf(duh[bb * cols + n], w_s[n * C + cc], a);
      a = warp_sum(a);
      if (lane == 0) part[((size_t)(b0 + bb) * I + i) * C + cc] = a;
    }
    for (int e = threadIdx.x; e < cols * C; e += blockDim.x) {
      const int n = e / C, cc = e % C;
      float a = dw_s[e];
      for (int bb = 0; bb < nb; ++bb)
        a = fmaf(duh[bb * cols + n], u_c[bb * C + cc], a);
      dw_s[e] = a;
    }
  }
  __syncthreads();
  float* dWi = dW + ((size_t)i * jd + n0) * C;
  for (int e = threadIdx.x; e < cols * C; e += blockDim.x) dWi[e] = dw_s[e];
}

// du[e] = the nk column blocks' partials of element e, added in block
// order.
__global__ void __launch_bounds__(kThreads)
du_blocks_sum_kernel(const float* __restrict__ du_part,
                     float* __restrict__ du, int nk, size_t total) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float a = 0.f;
  for (int k = 0; k < nk; ++k) a += du_part[(size_t)k * total + e];
  du[e] = a;
}

// The emit of whole rows where emit_cols is J*D (the kernel as it always
// ran), else the column-split emit into du_part and the sum of its
// partials.  emit_smem must equal the layout at emit_cols.
cudaError_t launch_emit(const float* u, const float* W, const float* b_prev,
                        const float* b_last, const float* ds, float* du_part,
                        float* du, float* dW, int B, int I, int C, int J,
                        int D, int emit_cols, int emit_smem, cudaStream_t s) {
  const int jd = J * D;
  if (emit_cols < D || emit_cols % D || jd % emit_cols ||
      emit_layout(C, J, D, emit_cols) * (int)sizeof(float) != emit_smem ||
      (emit_cols < jd && !du_part))
    return cudaErrorInvalidValue;
  if (emit_cols == jd) {
    cudaError_t err = cudaFuncSetAttribute(
        routing_bwd_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        emit_smem);
    if (err != cudaSuccess) return err;
    routing_bwd_emit_kernel<<<I, kThreads, emit_smem, s>>>(
        u, W, b_prev, b_last, ds, du, dW, B, I, C, J, D);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      routing_bwd_emit_cols_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, emit_smem);
  if (err != cudaSuccess) return err;
  const int nk = jd / emit_cols;
  routing_bwd_emit_cols_kernel<<<dim3(I, nk), kThreads, emit_smem, s>>>(
      u, W, b_prev, b_last, ds, du_part, dW, B, I, C, J, D, emit_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)B * I * C;
  du_blocks_sum_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                         kThreads, 0, s>>>(du_part, du, nk, total);
  return cudaGetLastError();
}

// Checks and launches the replay on B clusters of cs CTAs (K8, K9, K13
// with two_pass and streamed votes, or K9g with logits_global and
// streamed votes), then the emit.
cudaError_t launch_cluster_bwd(const float* u, const float* W, const float* g,
                               float* b_prev, float* b_last, float* ds,
                               float* du_part, float* du, float* dW, int B,
                               int I, int C, int J, int D, int iters,
                               int resident, int block_i, int cs,
                               int smem_bytes, int emit_cols, int emit_smem,
                               int two_pass, int logits_global,
                               cudaStream_t s) {
  if (B < 1 || I < 1 || iters < 1 || block_i < 1 || cs < 1 || cs > 16 ||
      (two_pass && resident) || (logits_global && (resident || two_pass)) ||
      cluster_bwd_layout(I, C, J, D, cs, resident, block_i, logits_global)
                  .total *
              (int)sizeof(float) != smem_bytes)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_clusters(
      logits_global ? routing_bwd_cluster_kernel<false, true>
      : two_pass    ? routing_bwd_cluster_kernel<true, false>
                    : routing_bwd_cluster_kernel<false, false>,
      B, cs, smem_bytes, s, u, W, g, b_prev, b_last, ds, B, I, C, J, D,
      iters, resident, block_i);
  if (err != cudaSuccess) return err;
  return launch_emit(u, W, b_prev, b_last, ds, du_part, du, dW, B, I, C, J,
                     D, emit_cols, emit_smem, s);
}

}  // namespace repro

// Every entry: u [B, I, C], W [I, J*D, C], g [B, J*D] -> du [B, I, C],
// dW [I, J*D, C].  Scratch in global memory: b_prev, b_last [B, I, J] (the
// logits b_{T-1}, b_T), ds [2, B, J*D] (ds_{T-1}, ds_T) and, where the
// emit splits over column blocks, du_part [J*D / emit_cols, B, I, C]
// (null otherwise).  smem_bytes / emit_smem are the plan's footprints
// (execplan.routing_bwd_cluster_smem / routing_bwd_emit_smem at
// emit_cols, execplan.emit_columns).

// The kernel's own shared-memory layout in bytes (execplan models it).
REPRO_EXPORT int routing_bwd_cluster_smem_bytes(int I, int C, int J, int D,
                                                int cs, int resident,
                                                int block_i) {
  return repro::cluster_bwd_layout(I, C, J, D, cs, resident, block_i).total *
         (int)sizeof(float);
}

// K9g's replay layout (streamed votes, logits in device memory) in bytes.
REPRO_EXPORT int routing_bwd_global_smem_bytes(int I, int C, int J, int D,
                                               int cs, int block_i) {
  return repro::cluster_bwd_layout(I, C, J, D, cs, 0, block_i, 1).total *
         (int)sizeof(float);
}

// out = {the votes computations of a sample's replay CTA over the W stream
// (replay_votes), its blocks of rows (1 where the votes come in whole)}
// at a K8/K9/K9g/K13b launch's sizes, for python -m repro_torch.verify.
REPRO_EXPORT int routing_bwd_passes(int I, int C, int J, int D, int cs,
                                    int resident, int block_i, int two_pass,
                                    int iters, int* out) {
  if (I < 1 || cs < 1 || block_i < 1 || iters < 1)
    return cudaErrorInvalidValue;
  const repro::ClusterBwdLayout L =
      repro::cluster_bwd_layout(I, C, J, D, cs, resident, block_i);
  out[0] = repro::replay_votes(resident != 0, two_pass != 0, iters);
  out[1] = resident ? 1 : (L.rows + block_i - 1) / block_i;
  return cudaSuccess;
}

// The emit's layout in bytes at emit_cols columns a CTA.
REPRO_EXPORT int routing_bwd_emit_smem_bytes(int C, int J, int D,
                                             int emit_cols) {
  return repro::emit_layout(C, J, D, emit_cols) * (int)sizeof(float);
}

// K8 (resident != 0: the CTAs' votes in shared memory) and K9: the replay
// on B clusters of cs CTAs, then the emit (split over emit_cols columns a
// CTA where emit_cols < J*D); smem_bytes and emit_smem must equal the
// kernels' layouts.
REPRO_EXPORT int routing_bwd_cluster_f32(const float* u, const float* W,
                                         const float* g, float* b_prev,
                                         float* b_last, float* ds,
                                         float* du_part, float* du,
                                         float* dW, int B, int I, int C,
                                         int J, int D, int iters,
                                         int resident, int block_i, int cs,
                                         int smem_bytes, int emit_cols,
                                         int emit_smem, void* stream) {
  return repro::launch_cluster_bwd(u, W, g, b_prev, b_last, ds, du_part, du,
                                   dW, B, I, C, J, D, iters, resident,
                                   block_i, cs, smem_bytes, emit_cols,
                                   emit_smem, 0, 0, (cudaStream_t)stream);
}

// K9g, the plan's "streamed-global" backward: K9's streamed replay with
// the rows' logits in b_last (which ends holding b_T) and five [J*D]
// vectors a CTA, then the emit as routing_bwd_cluster_f32's.
REPRO_EXPORT int routing_bwd_global_cluster_f32(
    const float* u, const float* W, const float* g, float* b_prev,
    float* b_last, float* ds, float* du_part, float* du, float* dW, int B,
    int I, int C, int J, int D, int iters, int block_i, int cs,
    int smem_bytes, int emit_cols, int emit_smem, void* stream) {
  return repro::launch_cluster_bwd(u, W, g, b_prev, b_last, ds, du_part, du,
                                   dW, B, I, C, J, D, iters, 0, block_i, cs,
                                   smem_bytes, emit_cols, emit_smem, 0, 1,
                                   (cudaStream_t)stream);
}

// out = {max active clusters, static shared bytes, max dynamic shared
// bytes, registers a thread} of the replay at these sizes.
REPRO_EXPORT int routing_bwd_cluster_occupancy(int I, int C, int J, int D,
                                               int cs, int resident,
                                               int block_i, int* out) {
  using namespace repro;
  return cluster_occupancy(
      routing_bwd_cluster_kernel<false, false>, cs,
      cluster_bwd_layout(I, C, J, D, cs, resident, block_i).total *
          (int)sizeof(float),
      out);
}

// The same of K9g's replay.
REPRO_EXPORT int routing_bwd_global_occupancy(int I, int C, int J, int D,
                                              int cs, int block_i,
                                              int* out) {
  using namespace repro;
  return cluster_occupancy(
      routing_bwd_cluster_kernel<false, true>, cs,
      cluster_bwd_layout(I, C, J, D, cs, 0, block_i, 1).total *
          (int)sizeof(float),
      out);
}

// out = {CTAs of the emit an SM holds at once, static shared bytes, max
// dynamic shared bytes, registers a thread} of the emit at emit_cols
// columns a CTA (the split kernel where emit_cols < J*D).
REPRO_EXPORT int routing_bwd_emit_occupancy(int C, int J, int D,
                                            int emit_cols, int* out) {
  using namespace repro;
  const void* kernel = emit_cols < J * D
                           ? (const void*)routing_bwd_emit_cols_kernel
                           : (const void*)routing_bwd_emit_kernel;
  const int smem = emit_layout(C, J, D, emit_cols) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = fa.maxDynamicSharedSizeBytes;
  out[3] = fa.numRegs;
  return cudaSuccess;
}

// K13, the unfused oracle: K9's streamed replay (block_i rows at a time) on
// B clusters of cs CTAs with each pass after the first a b-pass and an
// s-pass, then the emit of whole rows.
REPRO_EXPORT int routing_bwd_2pass_f32(const float* u, const float* W,
                                       const float* g, float* b_prev,
                                       float* b_last, float* ds, float* du,
                                       float* dW, int B, int I, int C, int J,
                                       int D, int iters, int block_i, int cs,
                                       int smem_bytes, int emit_smem,
                                       void* stream) {
  return repro::launch_cluster_bwd(u, W, g, b_prev, b_last, ds, nullptr, du,
                                   dW, B, I, C, J, D, iters, 0, block_i, cs,
                                   smem_bytes, J * D, emit_smem, 1, 0,
                                   (cudaStream_t)stream);
}
