// K3/K4 votes_routing: ClassCaps votes + every routing iteration, u_hat
// never written to global memory; and K13, the unfused streamed schedule
// that is the fused pass's oracle.
//
// Replaces src/repro/kernels/votes_routing.py: _resident_kernel (K3, with
// _votes_block and _routing_iterations), _streamed_kernel (K4) and
// _streamed_2pass_kernel (K13), all dispatched through _vr_apply, each
// with the optional residual-add epilogue (r [B, J*D] added to the output
// just before the store: one coupling half of a ResCapsBlock).  The plan's
// mode picks the kernel.
//
// On the TPU the whole batch shares one sequential grid.  On Hopper
// routing is independent per sample.
//
// K3 (votes_routing_cluster_kernel, the plan's "resident" mode, where one
// CTA could hold a whole sample's votes: the SVHN ResCaps halves, 32 x 8D
// routed to 32 x 8D, and its ClassCaps, 64 x 8D to 10 x 16D) routes each
// sample on a thread-block cluster of cs CTAs (routing_cluster.cuh), each
// owning a block of ceil(I / cs) rows with their u, logits and votes in
// its shared memory; s is summed in rank order through distributed shared
// memory once a pass, so a second launch repeats the bits.  What bounds
// it: not bytes -- a half moves 0.29 MB at batch 8, 86 ns at 3.35 TB/s,
// less than any launch -- but latency: 4 routing passes, each a chain of
// dependent steps (the votes' W loads from L2, the logits update, a
// softmax, the sum of s over the rows, a cluster barrier, the squash).
// One CTA a sample ran that chain on 8 of 132 SMs with a thread a row
// (32 of 256 threads at work, each through J*D serial FMAs and J
// exponentials); here a sample takes up to 16 SMs, each CTA's votes are a
// cs-th of the W stream, and a row takes a warp (lanes on the classes,
// the softmax reduced by shuffles; its logits contiguous, so no bank
// conflicts).  At ClassCaps' J = 10 a warp a row leaves 22 lanes idle;
// the mapping is kept because it is the cluster core's (the same sums in
// the same order as K5's and K8/K9's), and a CTA's rows at the planned
// cluster sizes are at most a few per warp, so the idle lanes add a few
// serial steps, not a longer chain per row.  Rank 0 writes v (+ r).
//
// K4 (votes_routing_kernel, streamed; and the plan's "streamed-global"
// mode) takes one CTA per sample: u (I*C floats), the logits (I*J), s
// and v (J*D each) stay in its shared memory, and each pass recomputes
// the votes block by block from W -- iters + 1 reads of W per sample,
// from the 50 MB L2 after the first CTA.  At MNIST width one sample's
// votes (1152 x 160 fp32 = 737,280 B) fit no CTA, so the plan streams;
// at the SVHN bottleneck (2048 capsules routed to 64, 524 KB of logits
// a sample) even the logits do not fit, and "streamed-global" keeps them
// in a per-sample slab of a global scratch (4.2 MB at batch 8,
// L2-resident) with the schedule unchanged.  K4 on the cluster core is
// later work.

#include "routing_cluster.cuh"

namespace repro {

__global__ void __launch_bounds__(kThreads)
votes_routing_kernel(const float* __restrict__ u, const float* __restrict__ W,
                     const float* __restrict__ r, float* logits,
                     float* __restrict__ out, int I, int C, int J, int D,
                     int iters, int schedule, int block_i) {
  extern __shared__ float smem[];
  const int jd = J * D;
  float* u_s = smem;                                   // [I][C]
  const float* ub = u + (size_t)blockIdx.x * I * C;
  for (int e = threadIdx.x; e < I * C; e += blockDim.x) u_s[e] = ub[e];
  RouteScratch sc = carve_route(
      u_s + I * C, I, J, jd,
      logits ? logits + (size_t)blockIdx.x * I * J : nullptr);
  __syncthreads();
  route_sample(u_s, W, I, C, J, D, iters, schedule, block_i, sc,
               r ? r + (size_t)blockIdx.x * jd : nullptr,
               out + (size_t)blockIdx.x * jd);
}

cudaError_t launch_votes_routing(const float* u, const float* W,
                                 const float* r, float* logits, float* out,
                                 int B, int I, int C, int J, int D, int iters,
                                 int schedule, int block_i, int smem_bytes,
                                 cudaStream_t stream) {
  if (B < 1 || I < 1 || iters < 1 || block_i < 1 || block_i > I)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      votes_routing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  votes_routing_kernel<<<B, kThreads, smem_bytes, stream>>>(
      u, W, r, logits, out, I, C, J, D, iters, schedule, block_i);
  return cudaGetLastError();
}

// The shared memory of one K3 cluster CTA, in floats
// (execplan.votes_routing_cluster_smem models the same sum): the votes rows
// of its ceil(I / cs) rows with their couplings, then the rows' u and
// logits, and s, v and the two partials of s.
struct ClusterFwdLayout {
  int rows, total;
};

__host__ __device__ inline ClusterFwdLayout cluster_fwd_layout(int I, int C,
                                                               int J, int D,
                                                               int cs) {
  ClusterFwdLayout L;
  L.rows = (I + cs - 1) / cs;
  const int jd = J * D;
  L.total = L.rows * (jd + 1 + J) + L.rows * (C + J) + 4 * jd;
  return L;
}

// K3: one sample per cluster of cs CTAs, rank r owning the sample's rows
// [r * rows, (r + 1) * rows) (the last block ragged or empty).  Held to 128
// registers a thread, so that two CTAs share an SM.
__global__ void __launch_bounds__(kThreads, 2)
votes_routing_cluster_kernel(const float* __restrict__ u,
                             const float* __restrict__ W,
                             const float* __restrict__ r,
                             float* __restrict__ out, int I, int C, int J,
                             int D, int iters) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int smp = blockIdx.x / cs;
  const int jd = J * D, ld = jd + 1;
  const ClusterFwdLayout L = cluster_fwd_layout(I, C, J, D, cs);
  const int i0 = min(I, rank * L.rows);
  const int n = min(I, i0 + L.rows) - i0;
  const OwnedRows own{n, i0, max(n, 1), 0};
  ClusterScratch sc;
  sc.uh = smem;                                 // [rows][J*D + 1]
  sc.c = sc.uh + L.rows * ld;                   // [rows][J]
  float* u_s = sc.c + L.rows * J;               // [rows][C]
  sc.b = u_s + L.rows * C;                      // [rows][J]
  sc.s = sc.b + L.rows * J;
  sc.v = sc.s + jd;
  sc.part = sc.v + jd;                          // [2][J*D]

  const float* ub = u + ((size_t)smp * I + i0) * C;
  for (int e = threadIdx.x; e < n * C; e += blockDim.x) u_s[e] = ub[e];
  __syncthreads();
  route_cluster(cl, sc, u_s, W, own, C, J, D, iters, true, max(n, 1),
                nullptr, nullptr, nullptr);
  if (rank == 0) {
    const float* rb = r ? r + (size_t)smp * jd : nullptr;
    float* ob = out + (size_t)smp * jd;
    for (int e = threadIdx.x; e < jd; e += blockDim.x)
      ob[e] = rb ? sc.v[e] + rb[e] : sc.v[e];
  }
  cl.sync();                      // no CTA leaves while a peer reads it
}

// Does nothing: launched on a kernel's grid, cluster and shared memory, its
// time is the floor under that launch (chip_smoke.py prints it beside the
// byte bounds of K3 and K8, which are below any launch).
__global__ void __launch_bounds__(kThreads) empty_cluster_kernel() {}

}  // namespace repro

// u [B, I, C], W [I, J*D, C] -> out [B, J*D] = v (+ r [B, J*D] when r is
// not null).  smem_bytes is the plan's footprint
// (execplan.votes_routing_smem).
//
// K4, the logits in shared memory.
REPRO_EXPORT int votes_routing_f32(const float* u, const float* W,
                                   const float* r, float* out, int B, int I,
                                   int C, int J, int D, int iters,
                                   int block_i, int smem_bytes,
                                   void* stream) {
  return repro::launch_votes_routing(u, W, r, nullptr, out, B, I, C, J, D,
                                     iters, repro::kStreamed, block_i,
                                     smem_bytes, (cudaStream_t)stream);
}

// K4 in the plan's "streamed-global" mode: logits [B, I, J] is the scratch
// in global memory (written and read only by the kernel).
REPRO_EXPORT int votes_routing_global_f32(const float* u, const float* W,
                                          const float* r, float* logits,
                                          float* out, int B, int I, int C,
                                          int J, int D, int iters,
                                          int block_i, int smem_bytes,
                                          void* stream) {
  return repro::launch_votes_routing(u, W, r, logits, out, B, I, C, J, D,
                                     iters, repro::kStreamed, block_i,
                                     smem_bytes, (cudaStream_t)stream);
}

// K13, the unfused oracle: logits [B, I, J] in global memory, or null to
// keep them in shared memory (the placement of the schedule it checks).
REPRO_EXPORT int votes_routing_2pass_f32(const float* u, const float* W,
                                         const float* r, float* logits,
                                         float* out, int B, int I, int C,
                                         int J, int D, int iters, int block_i,
                                         int smem_bytes, void* stream) {
  return repro::launch_votes_routing(u, W, r, logits, out, B, I, C, J, D,
                                     iters, repro::kTwoPass, block_i,
                                     smem_bytes, (cudaStream_t)stream);
}

// K3's shared-memory layout in bytes (execplan models it).
REPRO_EXPORT int votes_routing_cluster_smem_bytes(int I, int C, int J, int D,
                                                  int cs) {
  return repro::cluster_fwd_layout(I, C, J, D, cs).total *
         (int)sizeof(float);
}

// K3: B clusters of cs CTAs (1, 2, 4, 8 or 16), one sample each; arguments
// as votes_routing_f32's, r may be null.  smem_bytes must equal the
// kernel's layout.  A refused launch returns the runtime's error.
REPRO_EXPORT int votes_routing_cluster_f32(const float* u, const float* W,
                                           const float* r, float* out, int B,
                                           int I, int C, int J, int D,
                                           int iters, int cs, int smem_bytes,
                                           void* stream) {
  using namespace repro;
  if (B < 1 || I < 1 || iters < 1 || cs < 1 || cs > 16 ||
      cluster_fwd_layout(I, C, J, D, cs).total * (int)sizeof(float) !=
          smem_bytes)
    return cudaErrorInvalidValue;
  return launch_clusters(votes_routing_cluster_kernel, B, cs, smem_bytes,
                         (cudaStream_t)stream, u, W, r, out, I, C, J, D,
                         iters);
}

// out = {max active clusters, static shared bytes, max dynamic shared
// bytes, registers a thread} of K3 at these sizes.
REPRO_EXPORT int votes_routing_cluster_occupancy(int I, int C, int J, int D,
                                                 int cs, int* out) {
  using namespace repro;
  return cluster_occupancy(
      votes_routing_cluster_kernel, cs,
      cluster_fwd_layout(I, C, J, D, cs).total * (int)sizeof(float), out);
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
