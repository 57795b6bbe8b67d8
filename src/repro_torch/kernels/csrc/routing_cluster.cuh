// Routing-by-agreement of ONE sample over a thread-block cluster: the
// forward of K3 and K4 (votes_routing.cu), the consume schedule of K5
// (primary_routing.cu), the replay of K8/K9 (votes_routing_bwd.cu), the
// split path's K14b (routing.cu) and the unfused oracle K13/K13b, all on
// one pass loop (route_cluster).
//
// One CTA a sample keeps a batch of 8-16 samples on 8-16 of the H100's
// 132 SMs, and one sample's votes (737 KB at MNIST) or logits (524 KB at
// the SVHN bottleneck) do not fit it.  Here a cluster of cs CTAs (1, 2, 4,
// 8 or 16; 16 is a non-portable size) shares the sample.  CTA rank r owns
// a fixed set of capsule rows and keeps their u, their logits and -- where
// they fit -- their votes in its own shared memory; nothing of them
// reaches device memory.
//
// Each pass t = 0 .. iters folds the logits update b_t = b_{t-1} +
// <u_hat, v_{t-1}> (t > 0) into the accumulation of the CTA's share of
// s_t over its own rows (the reference's fused s+b pass), writes that
// partial into its own shared memory and waits at cluster.sync().  Then
// every CTA reads all cs partials through distributed shared memory
// (cluster.map_shared_rank) and sums them in rank order 0 .. cs-1, so every
// CTA holds the same s_t and squashes it into v_t itself: no float atomics,
// and a second launch repeats the bits.  The partial buffer is double-
// buffered by the parity of t: pass t+1 writes the other half, and a peer
// can still be reading this pass's half only until it reaches pass t+1's
// cluster.sync(), which the writer of pass t+2 has passed.  So one barrier
// a pass suffices, and the caller's last cluster.sync() keeps every CTA
// alive until its peers have read its last partial.
//
// The oracle (two_pass: the reference's unfused _streamed_2pass_kernel)
// splits each pass t > 0 in two: a b-pass over the CTA's rows that makes
// the logits update alone, then the s-pass with no update.  A row's update
// and a block's share of s are the same operations in the same order as in
// the fused pass, and the update of a row reads only v_{t-1} and its own
// votes, so the oracle's output equals the fused pass's bit for bit at the
// same cluster size and i-tile; with streamed votes it reads W twice a
// pass instead of once.
//
// Votes: "resident" brings the CTA's rows' votes into shared memory once;
// "streamed" brings them block by block on every pass, keeping only the
// rows' logits (and u).  Where they come from is the caller's votes source:
// computed from W and u (VotesOfW: one read of the rows' W a sample when
// resident, one a pass when streamed), or read from a u_hat in device
// memory (VotesRead, K14b).  The logits sit in the CTA's shared memory,
// or -- K4's streamed-global placement, where even a 16-CTA cluster's
// share of them fits no CTA -- in the sample's rows of a global scratch;
// the arithmetic is the same.  A row's logits work (the update, the
// softmax) takes one warp, its lanes the classes.
//
// Only s (J*D floats: 160 at MNIST, 512 at the SVHN bottleneck) crosses
// CTAs in a pass, from 2 to 16 SMs' shared memory, which is what the
// cluster's network is for.

#pragma once

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {

namespace cg = cooperative_groups;

// The capsule rows one CTA of the cluster owns: local row l is the sample's
// row global(l).  K5 owns `run` consecutive groups at each of the P
// positions (rows i = p * groups + g, runs `stride` = groups apart); the
// standalone K9 owns one block of rows (a single run).
struct OwnedRows {
  int n;        // rows this CTA owns (0 for a rank past a ragged end)
  int i0;       // the sample's row of local row 0
  int run;      // local rows per run of consecutive sample rows (>= 1)
  int stride;   // sample rows from one run's start to the next
  __host__ __device__ int global(int l) const {
    return stride ? i0 + (l / run) * stride + l % run : i0 + l;
  }
};

// The shared memory one cluster CTA routes in.
struct ClusterScratch {
  float* b;     // [n][J] the CTA's rows' logits (or their global rows)
  float* s;     // [J*D] s_t, reduced over the cluster
  float* v;     // [J*D] squash(s_t)
  float* part;  // [2][J*D] this CTA's partial s, by the parity of t
  float* uh;    // [vrows][J*D + 1] votes rows (padded against bank conflicts)
  float* c;     // [vrows][J] couplings
};

// uh[r][n] = sum_c W[r][n][c] u[r][c] for the `rows` consecutive rows at
// u_s / W, each dot summed over c in order.
__device__ inline void votes_rows(const float* __restrict__ u_s,
                                  const float* __restrict__ W, int rows,
                                  int jd, int C, float* uh, int ld) {
  const bool vec4 = (C % 4 == 0) && ((uintptr_t)W % 16 == 0);
  const int total = rows * jd;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / jd, n = e - r * jd;
    const float* w = W + ((size_t)r * jd + n) * C;
    const float* uu = u_s + r * C;
    float a = 0.f;
    if (vec4) {
      for (int c = 0; c < C; c += 4) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(w + c));
        a = fmaf(wv.x, uu[c], a);
        a = fmaf(wv.y, uu[c + 1], a);
        a = fmaf(wv.z, uu[c + 2], a);
        a = fmaf(wv.w, uu[c + 3], a);
      }
    } else {
      for (int c = 0; c < C; ++c) a = fmaf(__ldg(w + c), uu[c], a);
    }
    uh[r * ld + n] = a;
  }
}

// uh[r][n] = <W[global(l0 + r)][n][:], u[l0 + r][:]> for the owned local
// rows [l0, l0 + rows) with capsules of C floats known at compile time, each
// dot summed over c in order, as votes_rows does: a vote's float4 loads
// go out together, and the loop is simple enough for the compiler to keep
// several votes' loads in flight.  The W stream comes from L2 and is bound
// by its latency, drained at every block of rows (see PERF.md).
template <int C>
__device__ inline void votes_c(const float* u_s, const float* W,
                               const OwnedRows& own, int l0, int rows,
                               int jd, float* uh, int ld) {
  const int total = rows * jd;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / jd, n = e - r * jd;
    const float4* wp = reinterpret_cast<const float4*>(
        W + ((size_t)own.global(l0 + r) * jd + n) * C);
    const float* uu = u_s + (l0 + r) * C;
    float a = 0.f;
#pragma unroll
    for (int h = 0; h < C / 4; ++h) {
      const float4 w = __ldg(wp + h);
      a = fmaf(w.x, uu[4 * h], a);
      a = fmaf(w.y, uu[4 * h + 1], a);
      a = fmaf(w.z, uu[4 * h + 2], a);
      a = fmaf(w.w, uu[4 * h + 3], a);
    }
    uh[r * ld + n] = a;
  }
}

// Votes of the owned local rows [l0, l0 + rows) into uh: votes_c for
// capsules of 4 or 8 floats on 16-byte rows, else run by run through
// votes_rows.
__device__ inline void votes_owned(const float* u_s, const float* W,
                                   const OwnedRows& own, int l0, int rows,
                                   int jd, int C, float* uh, int ld) {
  if ((uintptr_t)W % 16 == 0 && (C == 4 || C == 8)) {
    if (C == 8)
      votes_c<8>(u_s, W, own, l0, rows, jd, uh, ld);
    else
      votes_c<4>(u_s, W, own, l0, rows, jd, uh, ld);
    return;
  }
  for (int l = l0; l < l0 + rows;) {
    const int len = min(l0 + rows - l, own.run - l % own.run);
    votes_rows(u_s + l * C, W + (size_t)own.global(l) * jd * C, len, jd, C,
               uh + (l - l0) * ld, ld);
    l += len;
  }
}

constexpr int kLoadBatch = 8;   // float4 loads a thread has in flight

// Copy `rows` rows of jd floats (contiguous at src) into dst, row pitch ld.
// Each thread starts kLoadBatch loads before it stores any: one L2 round
// trip per batch instead of one per float4.
__device__ inline void load_rows(const float* __restrict__ src, int rows,
                                 int jd, float* dst, int ld) {
  const int total = rows * jd;
  if (jd % 4 == 0 && (uintptr_t)src % 16 == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int total4 = total / 4;
    for (int f0 = threadIdx.x; f0 < total4; f0 += kLoadBatch * blockDim.x) {
      float4 v[kLoadBatch];
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int f = f0 + k * blockDim.x;
        if (f < total4) v[k] = __ldg(src4 + f);
      }
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int f = f0 + k * blockDim.x;
        if (f < total4) {
          const int r = 4 * f / jd, n = 4 * f - r * jd;  // never straddles
          float* d = dst + r * ld + n;
          d[0] = v[k].x;
          d[1] = v[k].y;
          d[2] = v[k].z;
          d[3] = v[k].w;
        }
      }
    }
  } else {
    for (int f = threadIdx.x; f < total; f += blockDim.x) {
      const int r = f / jd;
      dst[r * ld + (f - r * jd)] = __ldg(src + f);
    }
  }
}

// The votes sources of route_cluster: each fills uh (row pitch ld) with
// the votes of the owned local rows [l0, l0 + rows).
// Computed from W and the rows' u in shared memory (K3, K4, K5, K8/K9).
struct VotesOfW {
  const float* u_s;
  const float* W;
  OwnedRows own;
  int C;
  __device__ void operator()(int l0, int rows, int jd, float* uh,
                             int ld) const {
    votes_owned(u_s, W, own, l0, rows, jd, C, uh, ld);
  }
};

// Read from the sample's u_hat [I][J*D] in device memory (K14b), whose
// owned rows are one block (own.stride == 0).
struct VotesRead {
  const float* uh_g;
  OwnedRows own;
  __device__ void operator()(int l0, int rows, int jd, float* uh,
                             int ld) const {
    load_rows(uh_g + (size_t)own.global(l0) * jd, rows, jd, uh, ld);
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The couplings of one row from its logits br, by one warp (lane l takes
// the classes l, l + 32, ...): cr = softmax(br).
__device__ inline void softmax_warp(const float* br, float* cr, int J,
                                    int lane) {
  float m = -INFINITY;
  for (int j = lane; j < J; j += 32) m = fmaxf(m, br[j]);
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < J; j += 32) {
    const float e = expf(br[j] - m);
    cr[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < J; j += 32) cr[j] = cr[j] / sum;
}

// One row's logits update by its warp (lane l takes the classes l, l + 32,
// ...): br[j] += <u_hat[r, j, :], v[j, :]> over d in order (if `update`).
// With bp / bl (the replay's pass T) the row's logits go to row gi of
// those [I][J] slabs just before (bp) and just after (bl) the update.
__device__ inline void update_warp(const float* ur, float* br, const float* v,
                                   bool update, int J, int D, int lane,
                                   size_t gi, float* bp, float* bl) {
  for (int j = lane; j < J; j += 32) {
    if (bp) bp[gi + j] = br[j];
    if (update) {
      float a = 0.f;
      for (int d = 0; d < D; ++d) a = fmaf(ur[j * D + d], v[j * D + d], a);
      br[j] += a;
    }
    if (bl) bl[gi + j] = br[j];
  }
}

// The fused s+b step over the owned local rows [l0, l0 + rows), whose
// votes are at uh: the logits update (if `update`), the couplings, and the
// rows' share of s added to s.  One warp takes a row, its lanes the classes:
// one thread walking a row's J*D products and J exponentials serially set
// the pace of every block at SVHN's J = 64 (and its stride of J floats hit
// one bank).  bp / bl: see update_warp.
__device__ inline void route_owned(const float* uh, int ld, int l0, int rows,
                                   float* b, float* c, float* s,
                                   const float* v, bool update, int J, int D,
                                   const OwnedRows& own, float* bp,
                                   float* bl) {
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < rows; r += nwarps) {
    float* br = b + (l0 + r) * J;
    update_warp(uh + r * ld, br, v, update, J, D, lane,
                (size_t)own.global(l0 + r) * J, bp, bl);
    __syncwarp();
    softmax_warp(br, c + r * J, J, lane);
  }
  __syncthreads();
  const int jd = J * D;
  for (int n = threadIdx.x; n < jd; n += blockDim.x) {
    const int j = n / D;
    float a = s[n];
    for (int r = 0; r < rows; ++r) a = fmaf(c[r * J + j], uh[r * ld + n], a);
    s[n] = a;
  }
  __syncthreads();
}

// The oracle's b-pass step over the owned local rows [l0, l0 + rows),
// whose votes are at uh: the logits update alone, each row by
// route_owned's update (a warp a row).
__device__ inline void update_owned(const float* uh, int ld, int l0,
                                    int rows, float* b, const float* v,
                                    int J, int D, const OwnedRows& own,
                                    float* bp, float* bl) {
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < rows; r += nwarps)
    update_warp(uh + r * ld, b + (l0 + r) * J, v, true, J, D, lane,
                (size_t)own.global(l0 + r) * J, bp, bl);
  __syncthreads();
}

// The merged seed + reverse step over the owned rows [l0, l0 + rows) whose
// votes are at vb: db_T of each row (into c; a warp a row), used at once
// for dv += sum_r u_hat[r] . db_T[r].
__device__ inline void reverse_owned(const float* vb, int ld, int l0,
                                     int rows, const float* b, float* c,
                                     const float* ds, float* dv, int J,
                                     int D) {
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < rows; r += nwarps) {
    const float* ur = vb + r * ld;
    float* cr = c + r * J;
    softmax_warp(b + (l0 + r) * J, cr, J, lane);
    __syncwarp();
    // db_j = c_j (dc_j - sum_k c_k dc_k),  dc_j = <u_hat[r, j], ds_T[j]>.
    float cdc = 0.f;
    for (int j = lane; j < J; j += 32) {
      float dc = 0.f;
      for (int d = 0; d < D; ++d) dc = fmaf(ur[j * D + d], ds[j * D + d], dc);
      cdc = fmaf(cr[j], dc, cdc);
    }
    cdc = warp_sum(cdc);
    for (int j = lane; j < J; j += 32) {
      float dc = 0.f;
      for (int d = 0; d < D; ++d) dc = fmaf(ur[j * D + d], ds[j * D + d], dc);
      cr[j] = cr[j] * (dc - cdc);
    }
  }
  __syncthreads();
  const int jd = J * D;
  for (int n = threadIdx.x; n < jd; n += blockDim.x) {
    const int j = n / D;
    float a = dv[n];
    for (int r = 0; r < rows; ++r) a = fmaf(vb[r * ld + n], c[r * J + j], a);
    dv[n] = a;
  }
  __syncthreads();
}

// dst = the cluster's partials (each CTA's at `mine`) summed in rank order.
__device__ inline void cluster_sum(cg::cluster_group& cl, float* mine,
                                   float* dst, int jd) {
  cl.sync();
  const int cs = (int)cl.num_blocks();
  for (int n = threadIdx.x; n < jd; n += blockDim.x) {
    float a = 0.f;
    for (int r = 0; r < cs; ++r) a += cl.map_shared_rank(mine, r)[n];
    dst[n] = a;
  }
  __syncthreads();
}

// Every routing pass of the cluster's sample, its votes from `votes` (a
// votes source above): on return sc.s holds s_T and sc.v holds v_T (T =
// iters) in every CTA, and s_prev (if given) s_{T-1}.  With two_pass (the
// oracle K13/K13b) each pass t > 0 first runs a b-pass (update_owned,
// the votes brought again where they are streamed), then the s-pass with
// no update.  bp / bl: see update_warp (pass T only).  The caller's last
// cluster.sync() must follow the last read of sc.part by a peer (see the
// note above).
template <class Votes>
__device__ inline void route_cluster(cg::cluster_group& cl,
                                     const ClusterScratch& sc,
                                     const Votes& votes,
                                     const OwnedRows& own, int J, int D,
                                     int iters, bool resident, int block_i,
                                     float* s_prev, float* bp, float* bl,
                                     bool two_pass = false) {
  const int jd = J * D, ld = jd + 1;
  for (int e = threadIdx.x; e < own.n * J; e += blockDim.x) sc.b[e] = 0.f;
  if (resident) votes(0, own.n, jd, sc.uh, ld);
  __syncthreads();
  const int step = resident ? max(own.n, 1) : block_i;
  for (int t = 0; t <= iters; ++t) {
    float* part = sc.part + (t & 1) * jd;
    for (int n = threadIdx.x; n < jd; n += blockDim.x) part[n] = 0.f;
    __syncthreads();
    const bool last = t == iters;
    float* bpt = last ? bp : nullptr;
    float* blt = last ? bl : nullptr;
    if (two_pass && t > 0) {
      for (int l0 = 0; l0 < own.n; l0 += step) {
        const int rows = min(step, own.n - l0);
        if (!resident) {
          votes(l0, rows, jd, sc.uh, ld);
          __syncthreads();
        }
        update_owned(resident ? sc.uh + l0 * ld : sc.uh, ld, l0, rows, sc.b,
                     sc.v, J, D, own, bpt, blt);
      }
      bpt = blt = nullptr;
    }
    for (int l0 = 0; l0 < own.n; l0 += step) {
      const int rows = min(step, own.n - l0);
      if (!resident) {
        votes(l0, rows, jd, sc.uh, ld);
        __syncthreads();
      }
      route_owned(resident ? sc.uh + l0 * ld : sc.uh, ld, l0, rows, sc.b,
                  sc.c, part, sc.v, t > 0 && !two_pass, J, D, own, bpt, blt);
    }
    cluster_sum(cl, part, sc.s, jd);
    if (s_prev && t == iters - 1)
      for (int n = threadIdx.x; n < jd; n += blockDim.x) s_prev[n] = sc.s[n];
    for (int j = threadIdx.x; j < J; j += blockDim.x)
      squash_into(sc.s + j * D, sc.v + j * D, D);
    __syncthreads();
  }
}

// Launch `kernel` on B clusters of cs CTAs (grid B * cs), opting in to
// smem bytes of dynamic shared memory and, for cs > 8, to the non-portable
// cluster size.  Returns the runtime's error: a refused launch is reported,
// never replaced by another schedule.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int B, int cs,
                            int smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(B * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of cs CTAs with smem bytes each the card can hold at
// once (cudaOccupancyMaxActiveClusters), and the kernel's attributes as
// cudaFuncGetAttributes reports them: out = {max active clusters, static
// shared bytes, max dynamic shared bytes, registers a thread}.
template <typename... Params>
cudaError_t cluster_occupancy(void (*kernel)(Params...), int cs, int smem,
                              int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(&out[0], (void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, (const void*)kernel);
  if (err != cudaSuccess) return err;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = fa.maxDynamicSharedSizeBytes;
  out[3] = fa.numRegs;
  return cudaSuccess;
}

}  // namespace repro
