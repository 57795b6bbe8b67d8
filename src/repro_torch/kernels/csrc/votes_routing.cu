// K3/K4 votes_routing: ClassCaps votes + every routing iteration, u_hat
// never written to global memory; and K13, the unfused streamed schedule
// that is the fused pass's oracle, on the same cluster kernel.
//
// Replaces src/repro/kernels/votes_routing.py: _resident_kernel (K3, with
// _votes_block and _routing_iterations), _streamed_kernel (K4) and
// _streamed_2pass_kernel (K13), all dispatched through _vr_apply, each
// with the optional residual-add epilogue (r [B, J*D] added to the output
// just before the store: one coupling half of a ResCapsBlock).  The plan's
// mode picks the placement of the votes and the logits.
//
// On the TPU the whole batch shares one sequential grid.  On Hopper
// routing is independent per sample.
//
// K3, K4 and K13 (votes_routing_cluster_kernel) route each sample on a
// thread-block cluster of cs CTAs (routing_cluster.cuh), each owning a
// block of ceil(I / cs) rows with their u and logits in its shared memory;
// s is summed in rank order through distributed shared memory once a pass,
// so a second launch repeats the bits.  The placement of the votes is the
// kernel's first template argument:
//
//   resident  (K3, the SVHN ResCaps halves and ClassCaps, MNIST's ClassCaps
//             at cs >= 4) the CTA's rows' votes are computed once and kept.
//   streamed  (K4, the SVHN bottleneck: 2048 capsules routed to 64 x 8D)
//             only block_i votes rows are held, recomputed from W on each
//             of the iters + 1 passes: iters + 1 reads of the rows' W a
//             sample, from the 50 MB L2 after the first cluster.
//
// and the logits are the CTA's rows' in shared memory, or -- the plan's
// "streamed-global" (K4g), only where even a 16-CTA cluster's share of a
// sample's logits fits no CTA (CIFAR-10's full-width halves, 64 rows x 1024
// logits = 256 KB) -- the rows of the sample's slab of a [B, I, J] scratch
// in global memory, with the arithmetic unchanged.
//
// What bounds it: not bytes -- the MNIST ClassCaps moves 0.6 MB at batch 8
// (0.19 us at 3.35 TB/s), the SVHN bottleneck 34 MB (10 us: W, once) -- but
// latency: iters + 1 routing passes, each a chain of dependent steps (the
// votes' W loads from L2, the logits update, a softmax, the sum of s over
// the rows, a cluster barrier, the squash), and with streamed votes the W
// stream each pass (33.5 MB at the SVHN bottleneck, from L2, bound by its
// latency and the bytes in flight).  One CTA a sample (the earlier K4) ran
// that chain on 8 of 132 SMs with a thread a row (32 of 256 threads at work
// at MNIST, each through J*D serial FMAs and J exponentials; at SVHN's
// J = 64 the row stride of J floats hit one bank, and the logits went
// through L2 every pass).  Here a sample takes up to 16 SMs, each CTA's
// votes are a cs-th of the W stream, and a row takes a warp (lanes on the
// classes, the softmax reduced by shuffles; its logits contiguous, so no
// bank conflicts).  At ClassCaps' J = 10 a warp a row leaves 22 lanes idle;
// the mapping is kept because it is the cluster core's (the same sums in
// the same order as K5's, K8/K9's and K14b's).  Rank 0 writes v (+ r).
//
// K13 (kTwoPass) is K4 with each pass after the first split into a b-pass
// (the logits update alone) and an s-pass (route_cluster's two_pass): the
// reference's unfused schedule, on no plan.  It reads W 2 * iters + 1
// times a sample, keeps its logits where K4 would at the same cluster
// size and i-tile, and gives K4's output bit for bit.

#include "routing_cluster.cuh"

namespace repro {

// The shared memory of one K3/K4/K13 cluster CTA, in floats
// (execplan.votes_routing_cluster_smem models the same sum): the votes rows
// -- all of its ceil(I / cs) rows when resident, block_i of them when
// streamed -- with their couplings, then the rows' u and (unless they are
// in global memory) logits, and s, v and the two partials of s.
struct ClusterFwdLayout {
  int rows, vrows, total;
};

__host__ __device__ inline ClusterFwdLayout cluster_fwd_layout(
    int I, int C, int J, int D, int cs, int resident, int block_i,
    int logits_global) {
  ClusterFwdLayout L;
  L.rows = (I + cs - 1) / cs;
  L.vrows = resident ? L.rows : min(block_i, L.rows);
  const int jd = J * D;
  L.total = L.vrows * (jd + 1 + J) + L.rows * (C + (logits_global ? 0 : J)) +
            4 * jd;
  return L;
}

// K3 (kResident), K4 and K13 (kTwoPass): one sample per cluster of cs
// CTAs, rank r owning the sample's rows [r * rows, (r + 1) * rows) (the
// last block ragged or empty).  logits is null (the rows' logits in shared
// memory) or the [B, I, J] scratch.  Held to 128 registers a thread, so
// that two CTAs share an SM where their shared memory allows.
template <bool kResident, bool kTwoPass>
__global__ void __launch_bounds__(kThreads, 2)
votes_routing_cluster_kernel(const float* __restrict__ u,
                             const float* __restrict__ W,
                             const float* __restrict__ r, float* logits,
                             float* __restrict__ out, int I, int C, int J,
                             int D, int iters, int block_i) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int smp = blockIdx.x / cs;
  const int jd = J * D, ld = jd + 1;
  const ClusterFwdLayout L = cluster_fwd_layout(I, C, J, D, cs, kResident,
                                                block_i, logits != nullptr);
  const int i0 = min(I, rank * L.rows);
  const int n = min(I, i0 + L.rows) - i0;
  const OwnedRows own{n, i0, max(n, 1), 0};
  ClusterScratch sc;
  sc.uh = smem;                                 // [vrows][J*D + 1]
  sc.c = sc.uh + L.vrows * ld;                  // [vrows][J]
  float* u_s = sc.c + L.vrows * J;              // [rows][C]
  float* rest = u_s + L.rows * C;
  if (logits) {
    sc.b = logits + ((size_t)smp * I + i0) * J;  // the rows of the slab
  } else {
    sc.b = rest;                                // [rows][J]
    rest += L.rows * J;
  }
  sc.s = rest;
  sc.v = sc.s + jd;
  sc.part = sc.v + jd;                          // [2][J*D]

  const float* ub = u + ((size_t)smp * I + i0) * C;
  for (int e = threadIdx.x; e < n * C; e += blockDim.x) u_s[e] = ub[e];
  __syncthreads();
  route_cluster(cl, sc, VotesOfW{u_s, W, own, C}, own, J, D, iters,
                kResident, kResident ? max(n, 1) : block_i, nullptr, nullptr,
                nullptr, kTwoPass);
  if (rank == 0) {
    const float* rb = r ? r + (size_t)smp * jd : nullptr;
    float* ob = out + (size_t)smp * jd;
    for (int e = threadIdx.x; e < jd; e += blockDim.x)
      ob[e] = rb ? sc.v[e] + rb[e] : sc.v[e];
  }
  cl.sync();                      // no CTA leaves while a peer reads it
}

// K3 (resident), K4, or K13 (two_pass, streamed votes only).
inline void (*cluster_kernel_for(int resident, int two_pass))(
    const float*, const float*, const float*, float*, float*, int, int, int,
    int, int, int) {
  if (two_pass) return votes_routing_cluster_kernel<false, true>;
  return resident ? votes_routing_cluster_kernel<true, false>
                  : votes_routing_cluster_kernel<false, false>;
}

// Checks and launches K3/K4/K13 on B clusters of cs CTAs.
cudaError_t launch_cluster_fwd(const float* u, const float* W, const float* r,
                               float* logits, float* out, int B, int I, int C,
                               int J, int D, int iters, int resident,
                               int block_i, int cs, int smem_bytes,
                               cudaStream_t stream, int two_pass = 0) {
  if (B < 1 || I < 1 || iters < 1 || block_i < 1 || cs < 1 || cs > 16 ||
      (two_pass && resident) ||
      cluster_fwd_layout(I, C, J, D, cs, resident, block_i,
                         logits != nullptr).total *
              (int)sizeof(float) != smem_bytes)
    return cudaErrorInvalidValue;
  return launch_clusters(cluster_kernel_for(resident, two_pass), B, cs,
                         smem_bytes, stream, u, W, r, logits, out, I, C, J,
                         D, iters, block_i);
}

// Does nothing: launched on a kernel's grid, cluster and shared memory, its
// time is the floor under that launch (chip_smoke.py prints it beside the
// byte bounds of K3, K4, K8 and K14b, which are below any launch).
__global__ void __launch_bounds__(kThreads) empty_cluster_kernel() {}

}  // namespace repro

// u [B, I, C], W [I, J*D, C] -> out [B, J*D] = v (+ r [B, J*D] when r is
// not null).  smem_bytes is the plan's footprint, which must equal the
// kernel's layout (execplan.votes_routing_cluster_smem).  A refused launch
// returns the runtime's error, never another schedule.

// K13, the unfused oracle: K4's streamed votes (block_i rows at a time) on
// B clusters of cs CTAs, each pass after the first a b-pass and an s-pass;
// logits is null (the rows' logits in shared memory) or a [B, I, J]
// scratch, where K4 keeps them at this cluster size and i-tile.
REPRO_EXPORT int votes_routing_2pass_f32(const float* u, const float* W,
                                         const float* r, float* logits,
                                         float* out, int B, int I, int C,
                                         int J, int D, int iters, int block_i,
                                         int cs, int smem_bytes,
                                         void* stream) {
  return repro::launch_cluster_fwd(u, W, r, logits, out, B, I, C, J, D,
                                   iters, 0, block_i, cs, smem_bytes,
                                   (cudaStream_t)stream, 1);
}

// K3/K4's shared-memory layout in bytes (execplan models it).
REPRO_EXPORT int votes_routing_cluster_smem_bytes(int I, int C, int J, int D,
                                                  int cs, int resident,
                                                  int block_i,
                                                  int logits_global) {
  return repro::cluster_fwd_layout(I, C, J, D, cs, resident, block_i,
                                   logits_global).total *
         (int)sizeof(float);
}

// out = {the votes computations of a sample's CTA over the W stream
// (route_votes), its blocks of rows (1 where the votes come in whole)} at
// a K3/K4/K13 launch's sizes, for python -m repro_torch.verify.
REPRO_EXPORT int votes_routing_passes(int I, int C, int J, int D, int cs,
                                      int resident, int block_i,
                                      int two_pass, int iters, int* out) {
  if (I < 1 || cs < 1 || block_i < 1 || iters < 1)
    return cudaErrorInvalidValue;
  const repro::ClusterFwdLayout L =
      repro::cluster_fwd_layout(I, C, J, D, cs, resident, block_i, 0);
  out[0] = repro::route_votes(resident != 0, two_pass != 0, iters);
  out[1] = resident ? 1 : (L.rows + block_i - 1) / block_i;
  return cudaSuccess;
}

// K3: resident votes on B clusters of cs CTAs (1, 2, 4, 8 or 16), one
// sample each; r may be null.
REPRO_EXPORT int votes_routing_cluster_f32(const float* u, const float* W,
                                           const float* r, float* out, int B,
                                           int I, int C, int J, int D,
                                           int iters, int cs, int smem_bytes,
                                           void* stream) {
  return repro::launch_cluster_fwd(u, W, r, nullptr, out, B, I, C, J, D,
                                   iters, 1, 1, cs, smem_bytes,
                                   (cudaStream_t)stream);
}

// K4: streamed votes (block_i rows at a time) on B clusters of cs CTAs, the
// rows' logits in shared memory.
REPRO_EXPORT int votes_routing_streamed_cluster_f32(
    const float* u, const float* W, const float* r, float* out, int B, int I,
    int C, int J, int D, int iters, int block_i, int cs, int smem_bytes,
    void* stream) {
  return repro::launch_cluster_fwd(u, W, r, nullptr, out, B, I, C, J, D,
                                   iters, 0, block_i, cs, smem_bytes,
                                   (cudaStream_t)stream);
}

// K4g, the plan's "streamed-global": K4 with the logits in logits [B, I, J]
// (a scratch in global memory, written and read only by the kernel).
REPRO_EXPORT int votes_routing_global_cluster_f32(
    const float* u, const float* W, const float* r, float* logits, float* out,
    int B, int I, int C, int J, int D, int iters, int block_i, int cs,
    int smem_bytes, void* stream) {
  if (!logits) return cudaErrorInvalidValue;
  return repro::launch_cluster_fwd(u, W, r, logits, out, B, I, C, J, D,
                                   iters, 0, block_i, cs, smem_bytes,
                                   (cudaStream_t)stream);
}

// out = {max active clusters, static shared bytes, max dynamic shared
// bytes, registers a thread} of K3/K4 at these sizes.
REPRO_EXPORT int votes_routing_cluster_occupancy(int I, int C, int J, int D,
                                                 int cs, int resident,
                                                 int block_i,
                                                 int logits_global,
                                                 int* out) {
  using namespace repro;
  return cluster_occupancy(
      cluster_kernel_for(resident, 0), cs,
      cluster_fwd_layout(I, C, J, D, cs, resident, block_i, logits_global)
              .total *
          (int)sizeof(float),
      out);
}

// An empty launch of B clusters of cs CTAs with smem bytes of shared memory
// each (empty_cluster_kernel): a measurement aid, on no model path.
REPRO_EXPORT int empty_cluster_launch(int B, int cs, int smem_bytes,
                                      void* stream) {
  using namespace repro;
  if (B < 1 || cs < 1 || cs > 16) return cudaErrorInvalidValue;
  return launch_clusters(empty_cluster_kernel, B, cs, smem_bytes,
                         (cudaStream_t)stream);
}
