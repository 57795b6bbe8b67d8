// K14b routing: every routing-by-agreement iteration over a u_hat that
// caps_votes.cu (K14a) wrote to device memory -- the split path's
// Sum+Squash and Update+Sum, u_hat [B, I, J*D] -> v [B, J*D].
//
// Replaces src/repro/kernels/routing.py: _routing_kernel, one grid step
// per sample, the sample's whole u_hat in VMEM (~0.8 MiB at MNIST width).
// Inference only: the reference applies no stop-gradient here, and the
// forward values do not depend on one.
//
// On Hopper each sample routes on a thread-block cluster of cs CTAs, on
// the pass loop that K3/K4/K5/K9 share (routing_cluster.cuh's
// route_cluster: iters + 1 fused s+b passes, a warp a row, s summed in
// rank order through distributed shared memory), with the votes read
// from u_hat instead of computed from W (its VotesRead source).  CTA rank
// r owns the sample's rows [r * ceil(I / cs), ...) with their logits, s,
// v and the two partials in its shared memory.  Where they fit
// ("resident": 144 rows x 161 floats, 93 KB, at MNIST on clusters of 8)
// it copies its rows of u_hat once, with batches of float4 reads, into
// rows padded to J*D + 1 floats, so each sample's u_hat is read from
// device memory once (737,280 B at MNIST, 5.9 MB at batch 8) -- where one
// CTA a sample read the whole of it through one SM on each of the 4
// passes.  Otherwise ("streamed") it reads block_i rows on every pass, the
// passes after the first from L2.
// What bounds it: the bytes, u_hat once (1.8 us at 3.35 TB/s at MNIST
// batch 8), below the passes' chain of dependent steps and cluster
// barriers; a cluster spreads a batch of 8 over up to 128 SMs.

#include "routing_cluster.cuh"

namespace repro {

// The shared memory of one K14b cluster CTA, in floats
// (execplan.routing_split_cluster_smem models the same sum): the u_hat rows
// -- all of its ceil(I / cs) rows when resident, block_i of them when
// streamed -- with their couplings, then the rows' logits, and s, v and the
// two partials of s.
struct SplitLayout {
  int rows, vrows, total;
};

__host__ __device__ inline SplitLayout split_layout(int I, int J, int D,
                                                    int cs, int resident,
                                                    int block_i) {
  SplitLayout L;
  L.rows = (I + cs - 1) / cs;
  L.vrows = resident ? L.rows : min(block_i, L.rows);
  const int jd = J * D;
  L.total = L.vrows * (jd + 1 + J) + L.rows * J + 4 * jd;
  return L;
}

// One sample per cluster of cs CTAs, rank r owning the sample's rows
// [r * rows, (r + 1) * rows) (the last block ragged or empty).  Held to 128
// registers a thread, so that two CTAs share an SM where their shared
// memory allows.
__global__ void __launch_bounds__(kThreads, 2)
routing_cluster_kernel(const float* __restrict__ u_hat,
                       float* __restrict__ out, int I, int J, int D,
                       int iters, int resident, int block_i) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int smp = blockIdx.x / cs;
  const int jd = J * D, ld = jd + 1;
  const SplitLayout L = split_layout(I, J, D, cs, resident, block_i);
  const int i0 = min(I, rank * L.rows);
  const int n = min(I, i0 + L.rows) - i0;
  const OwnedRows own{n, i0, max(n, 1), 0};
  ClusterScratch sc;
  sc.uh = smem;                                 // [vrows][J*D + 1]
  sc.c = sc.uh + L.vrows * ld;                  // [vrows][J]
  sc.b = sc.c + L.vrows * J;                    // [rows][J]
  sc.s = sc.b + L.rows * J;
  sc.v = sc.s + jd;
  sc.part = sc.v + jd;                          // [2][J*D]
  route_cluster(cl, sc, VotesRead{u_hat + (size_t)smp * I * jd, own}, own, J,
                D, iters, resident != 0, resident ? max(n, 1) : block_i,
                nullptr, nullptr, nullptr);
  if (rank == 0)
    for (int e = threadIdx.x; e < jd; e += blockDim.x)
      out[(size_t)smp * jd + e] = sc.v[e];
  cl.sync();                      // no CTA leaves while a peer reads it
}

}  // namespace repro

// K14b's shared-memory layout in bytes (execplan models it).
REPRO_EXPORT int routing_cluster_smem_bytes(int I, int J, int D, int cs,
                                            int resident, int block_i) {
  return repro::split_layout(I, J, D, cs, resident, block_i).total *
         (int)sizeof(float);
}

// u_hat [B, I, J*D] -> v [B, J*D] on B clusters of cs CTAs (1, 2, 4, 8 or
// 16), the rows' u_hat copied once (resident != 0) or block_i rows a pass.
// smem_bytes is the plan's footprint (execplan.routing_split_cluster_smem),
// which must equal the kernel's layout.  A refused launch returns the
// runtime's error, never another schedule.
REPRO_EXPORT int routing_cluster_f32(const float* u_hat, float* out, int B,
                                     int I, int J, int D, int iters,
                                     int resident, int block_i, int cs,
                                     int smem_bytes, void* stream) {
  using namespace repro;
  if (B < 1 || I < 1 || iters < 0 || block_i < 1 || cs < 1 || cs > 16 ||
      split_layout(I, J, D, cs, resident, block_i).total *
              (int)sizeof(float) != smem_bytes)
    return cudaErrorInvalidValue;
  return launch_clusters(routing_cluster_kernel, B, cs, smem_bytes,
                         (cudaStream_t)stream, u_hat, out, I, J, D, iters,
                         resident, block_i);
}

// out = {max active clusters, static shared bytes, max dynamic shared
// bytes, registers a thread} of K14b at these sizes.
REPRO_EXPORT int routing_cluster_occupancy(int I, int J, int D, int cs,
                                           int resident, int block_i,
                                           int* out) {
  using namespace repro;
  return cluster_occupancy(
      routing_cluster_kernel, cs,
      split_layout(I, J, D, cs, resident, block_i).total * (int)sizeof(float),
      out);
}
