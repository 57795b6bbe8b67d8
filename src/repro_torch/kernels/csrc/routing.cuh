// Votes + routing-by-agreement of ONE sample inside one CTA: K13, the
// unfused streamed schedule of votes_routing.cu (the reference's
// _streamed_2pass_kernel, mode "streamed-2pass"), and the votes and logits
// helpers that K13b's replay (votes_routing_bwd.cu) shares with it.
//
// u (the sample's I x C capsules) is already in shared memory.  Routing
// runs iters + 1 s-passes; before each s-pass after the first, a b-pass
// recomputes the votes i-block by i-block from W and folds iteration t's
// logits update b_t = b_{t-1} + <u_hat, v_{t-1}> into the logits; the
// s-pass recomputes them again and accumulates s_t = sum_i softmax_j(b_t)
// [i, j] u_hat[i, j, :], then squashes s_t into v_t.  So W is read
// 2 * iters + 1 times.  It is the oracle of the fused s+b pass (the
// reference's _streamed_kernel), never a plan mode: per row it does the
// same operations in the same order, one thread a row.  The fused schedule
// itself -- K3, K4 (votes_routing.cu) and K14b (routing.cu) -- runs each
// sample on a thread-block cluster (routing_cluster.cuh), its s summed rank
// by rank, so K13 agrees with K4 within the routing tolerance
// (chip_smoke.py's ROUTING), no longer to the bit.
//
// The logits live in shared memory, or -- where one sample's I x J logits
// do not fit a CTA (2048 x 64 fp32 = 524 KB at the SVHN bottleneck) -- in
// the sample's slab of a scratch in global memory that the wrapper
// allocates (B * I * J floats, resident in the 50 MB L2).  That is only
// where RouteScratch::b points: the schedule and its arithmetic are the
// same.  An optional residual r [J*D] is added to v just before the store
// (the ResCapsBlock coupling epilogue); s and v themselves stay pure, as
// the reference keeps v_scr pure.
//
// Rows past I are never computed: the reference zero-pads the i axis to a
// multiple of block_i, and zero rows add nothing to s and leave their own
// logits unread, so skipping them gives the same result.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {

struct RouteScratch {
  float* b;    // [I][J] logits: shared memory, or the sample's global slab
  float* s;    // [J*D]
  float* v;    // [J*D]
  float* uh;   // [rows][J*D + 1] votes (row padded against bank conflicts)
  float* c;    // [rows][J] couplings
};

// Carve the routing scratch from p: I*J + 2*J*D + rows*(J*D + 1 + J)
// floats (execplan.routing_smem_floats), or no I*J term when the logits
// are given in global memory (b_global); the votes rows and couplings come
// last.
__device__ inline RouteScratch carve_route(float* p, int I, int J, int jd,
                                           float* b_global = nullptr) {
  RouteScratch sc;
  sc.b = b_global ? b_global : p;
  sc.s = b_global ? p : p + I * J;
  sc.v = sc.s + jd;
  sc.uh = sc.v + jd;
  sc.c = nullptr;                  // placed by route_2pass after the votes
  return sc;
}

// uh[r][n] = sum_c W[r][n][c] u[r][c] for the `rows` rows at u_s / W.
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

// The logits update of one row: br[j] += <u_hat[r, j, :], v[j, :]>.
__device__ inline void update_row(const float* ur, float* br, const float* v,
                                  int J, int D) {
  for (int j = 0; j < J; ++j) {
    float a = 0.f;
    for (int d = 0; d < D; ++d) a = fmaf(ur[j * D + d], v[j * D + d], a);
    br[j] += a;
  }
}

// The b-pass of the two-pass schedule over `rows` rows: update only.
__device__ inline void update_rows(const float* uh, int ld, int rows,
                                   float* b, const float* v, int J, int D) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    update_row(uh + r * ld, b + r * J, v, J, D);
  __syncthreads();
}

// The s-pass over `rows` rows: soften their logits into couplings, and add
// their share of s.
__device__ inline void route_rows(const float* uh, int ld, int rows,
                                  const float* b, float* c, float* s, int J,
                                  int D) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* br = b + r * J;
    float* cr = c + r * J;
    float m = -INFINITY;
    for (int j = 0; j < J; ++j) m = fmaxf(m, br[j]);
    float sum = 0.f;
    for (int j = 0; j < J; ++j) {
      const float e = expf(br[j] - m);
      cr[j] = e;
      sum += e;
    }
    for (int j = 0; j < J; ++j) cr[j] = cr[j] / sum;
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

// All routing passes of one sample on K13's two-pass schedule; writes v
// [J*D] (plus r [J*D] when r is given) to out.
__device__ inline void route_2pass(const float* u_s,
                                   const float* __restrict__ W, int I, int C,
                                   int J, int D, int iters, int block_i,
                                   RouteScratch sc, const float* r,
                                   float* out) {
  const int jd = J * D, ld = jd + 1;
  sc.c = sc.uh + block_i * ld;
  for (int e = threadIdx.x; e < I * J; e += blockDim.x) sc.b[e] = 0.f;
  __syncthreads();
  for (int t = 0; t <= iters; ++t) {
    if (t > 0) {
      // b-pass of iteration t: b_t = b_{t-1} + <u_hat, v_{t-1}>.
      for (int i0 = 0; i0 < I; i0 += block_i) {
        const int rows = min(block_i, I - i0);
        votes_rows(u_s + i0 * C, W + (size_t)i0 * jd * C, rows, jd, C,
                   sc.uh, ld);
        __syncthreads();
        update_rows(sc.uh, ld, rows, sc.b + i0 * J, sc.v, J, D);
      }
    }
    for (int n = threadIdx.x; n < jd; n += blockDim.x) sc.s[n] = 0.f;
    __syncthreads();
    for (int i0 = 0; i0 < I; i0 += block_i) {
      const int rows = min(block_i, I - i0);
      votes_rows(u_s + i0 * C, W + (size_t)i0 * jd * C, rows, jd, C, sc.uh,
                 ld);
      __syncthreads();
      route_rows(sc.uh, ld, rows, sc.b + i0 * J, sc.c, sc.s, J, D);
    }
    for (int j = threadIdx.x; j < J; j += blockDim.x)
      squash_into(sc.s + j * D, sc.v + j * D, D);
    __syncthreads();
  }
  for (int n = threadIdx.x; n < jd; n += blockDim.x)
    out[n] = r ? sc.v[n] + r[n] : sc.v[n];
}

}  // namespace repro
