// K5 primary_routing: the PrimaryCaps conv (im2col GEMM + bias + squash)
// and the votes + routing of the next layer in ONE kernel, each sample on a
// thread-block cluster of cs CTAs, with the inter-layer activation u kept in
// the cluster's shared memory.
//
// Replaces src/repro/kernels/primary_routing.py: _produce_u with
// _pipe_resident_kernel / _pipe_streamed_kernel, dispatched through
// _pr_apply.
//
// Grid: B clusters of cs CTAs (cs divides the G capsule groups).  CTA rank r
// owns the groups [r G/cs, (r+1) G/cs) at every one of the P positions: the
// N/cs output channels [r N/cs, (r+1) N/cs) of the PrimaryCaps conv, and so
// the capsule rows i = p * G + g of those groups.
//
// Produce: the cluster splits the sample's GEMM [P, K] x [K, N] (36 x
// 20,736 x 256 at MNIST, 64 x 5,184 x 96 at the published SVHN net) along
// K.  CTA rank r computes the whole P x N tile over its slab of K (a
// multiple of kBK, the last ragged) from the sample's patches (written by
// K1) and W_pc, through a ring of cp.async stages, as deep as the region
// the consumer needs anyway and at least 64 KB: the stream comes from L2,
// and the bytes in flight set its rate.  A stage holds stage_rows(P) patch
// rows and kBK rows of W_pc, whatever the thread tile.  The partial
// tiles then meet through distributed shared memory: each CTA adds its own
// N/cs columns of all cs partials in rank order, adds the bias and squashes
// each capsule, so u lands in the CTA that routes it; the slice's
// [P][N/cs] layout is exactly the CTA's [rows][C] capsule rows.  (A split
// of N instead would leave each CTA a 36 x 32 slice: 4.5 outputs a thread,
// too few to hide the shared-memory reads, and every CTA would read the
// whole patch tile.)
//
// The thread tile is fitted to P x N (tile_for; execplan.pipe_tile): the
// 256 threads form 256 / cg row groups, which span the stage's rows, and cg
// column groups, which split N whole, each thread tr rows x tc columns;
// of the built tiles the kernel runs the one on which the most threads own
// outputs.  A thread reads its rows as one float4 of 4 k (a warp spans one
// to four row groups, so the reads are broadcasts) and its columns in the
// widest loads their alignment allows.  N = 256 (MNIST, the repo's deep
// SVHN and CIFAR-10 stacks) keeps 4 row groups x 64 groups of 4 columns:
// 9 x 4 at P = 36, 16 x 4 at 64.  At SVHN's N = 96 that tile left 160 of
// the 256 threads idle; 16 x 16 groups of 4 x 6 (24 accumulators, W_pc in
// three float2 a k, conflict-free) employ all 8 warps.  Of 16 x 2, 8 x 3,
// 4 x 6 and 2 x 12 at 64 x 96, 4 x 6 ran fastest on the H100.  Any N no
// narrower built tile splits (the smoke configs' 16 and 24) runs the
// 4-column tile, some threads idle.  Each output still sums its rank's
// slab in ascending k with fmaf, so any tile gives the same bits.
// Consume: routing_cluster.cuh routes the sample over the cluster on those
// rows (votes resident or streamed, the plan's mode), so neither u nor
// u_hat goes to device memory; only s crosses CTAs.  The producer's ring,
// its partial tile and the consumer's votes rows share one region.
//
// What bounds it on the H100: the producer's 2 P K N fp32 operations a
// sample (382 M at MNIST, 64 M at SVHN; the votes are 2.9 M and 1.6 M a
// pass) over 67 TFLOP/s -- if every SM works.  Clusters spread a batch
// over the SMs (8 CTAs a sample at MNIST batch 64, 2 at SVHN batch 512:
// 512 and 1024 CTAs, 5 and 8 waves of one CTA an SM).  There the producer
// alone (with the ranks' sum and the squash) runs at ~28% of the fp32
// peak at both shapes, its shared-memory reads and a barrier a stage
// against 24 or 36 FMAs a thread a k; at SVHN batch 512 the routing of a
// CTA's 512 capsule rows through the passes then takes more time than the
// producer (~2.6 of 4.35 ms), at MNIST batch 64 a third (144 rows).

#include "gemm_sm90.cuh"
#include "routing_cluster.cuh"

namespace repro {
namespace k5 {

using gemm::cp_async16;
using gemm::cp_async4;
using gemm::cp_async_commit;
constexpr int kBK = 16;            // K per ring stage (execplan.PIPE_BLOCK_K)
constexpr int kLda = kBK + 4;      // a patch row in a stage, padded
constexpr int kMinStages = 3;
constexpr int kMaxStages = 16;
constexpr int kRingFloats = 16384; // 64 KB at least in the ring

// cp.async.wait_group with a count known only at run time (< kMaxStages).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
#define REPRO_WAIT(N)         \
  case N:                     \
    gemm::cp_async_wait<N>(); \
    break;
    REPRO_WAIT(1) REPRO_WAIT(2) REPRO_WAIT(3) REPRO_WAIT(4) REPRO_WAIT(5)
    REPRO_WAIT(6) REPRO_WAIT(7) REPRO_WAIT(8) REPRO_WAIT(9) REPRO_WAIT(10)
    REPRO_WAIT(11) REPRO_WAIT(12) REPRO_WAIT(13) REPRO_WAIT(14)
#undef REPRO_WAIT
    default:
      gemm::cp_async_wait<0>();
  }
}

// Patch rows of a ring stage: 4 x the smallest of {1, 2, 3, 4, 6, 8, 9, 12,
// 16} that is >= P / 4 (execplan.pipe_rows; 0 past the kernel's 64
// positions).
__host__ __device__ inline int stage_rows(int P) {
  const int need = (P + 3) / 4;
  const int built[] = {1, 2, 3, 4, 6, 8, 9, 12, 16};
  for (int tr : built)
    if (tr >= need) return 4 * tr;
  return 0;
}

// The producer's thread tile: the 256 threads as kThreads / cg row groups x
// cg column groups, each thread tr rows x tc columns of the P x N tile.
// The built tiles, in execplan.PIPE_TILES_BUILT's order: the 4-column
// tiles over 64 column groups (N = 256), then 4 x 6 over 16 (N = 96).
struct Tile {
  int tr, tc, cg;
};
#define REPRO_K5_TILES(X)                                                \
  X(1, 4, 64) X(2, 4, 64) X(3, 4, 64) X(4, 4, 64) X(6, 4, 64) X(8, 4, 64) \
  X(9, 4, 64) X(12, 4, 64) X(16, 4, 64) X(4, 6, 16)

// The tile a launch at P x N runs (execplan.pipe_tile): of the built tiles
// whose row groups span the stage's rows and whose column groups split N
// whole, the one on which the most threads own outputs, the first built
// on a tie; {0, 0, 0} where none fits.
inline Tile tile_for(int P, int N) {
  const Tile built[] = {
#define REPRO_K5_TILE(TR, TC, CG) {TR, TC, CG},
      REPRO_K5_TILES(REPRO_K5_TILE)
#undef REPRO_K5_TILE
  };
  Tile best{0, 0, 0};
  int most = 0;
  for (const Tile& t : built) {
    const int rg = kThreads / t.cg;
    if (rg * t.tr != stage_rows(P) || N % t.tc || t.cg * t.tc < N) continue;
    const int busy = min(rg, (P + t.tr - 1) / t.tr) * (N / t.tc);
    if (busy > most) {
      best = t;
      most = busy;
    }
  }
  return best;
}

// The shared memory of one CTA, in floats (execplan.primary_routing_smem
// models the same sum): the region (the producer's ring of `stages` stages
// of stage_rows(P) patch rows and kBK rows of W_pc, and then its P x N
// partial tile, then the consumer's votes rows and couplings), u, the
// logits, and s, v and the two partials of s.
struct Layout {
  int ns, rows, vrows, stage, stages, region, total;
};

__host__ __device__ inline Layout layout(int P, int N, int C, int J, int D,
                                         int cs, int resident, int block_i) {
  Layout L;
  const int jd = J * D;
  L.ns = N / cs;
  L.rows = P * L.ns / C;
  L.vrows = resident ? L.rows : min(block_i, L.rows);
  L.stage = stage_rows(P) * kLda + kBK * N;
  const int consume = L.vrows * (jd + 1 + J);
  L.stages = max(kMinStages,
                 min(kMaxStages, max(consume, kRingFloats) / L.stage));
  L.region = max(L.stages * L.stage, max(P * N, consume));
  L.total = L.region + L.rows * C + L.rows * J + 4 * jd;
  return L;
}

struct Args {
  const float* patches;   // [B, P, K]
  const float* wpc;       // [K, N]
  const float* bias;      // [N]
  const float* W;         // [I, J*D, C]
  float* out;             // [B, J*D]
  int P, K, N, C, J, D, iters, resident, block_i;
};

// Floats a load of a thread's TC columns moves: the widest vector whose
// alignment TC floats a thread (from a 16-byte aligned row) keeps.
template <int TC>
constexpr int kColVec = TC % 4 == 0 ? 4 : TC % 2 == 0 ? 2 : 1;

// v[0..TC) = the TC floats at p.
template <int TC>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[TC]) {
#pragma unroll
  for (int j = 0; j < TC; j += kColVec<TC>) {
    if constexpr (kColVec<TC> == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    } else if constexpr (kColVec<TC> == 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + j);
      v[j] = q.x, v[j + 1] = q.y;
    } else {
      v[j] = p[j];
    }
  }
}

// The TC floats at p = v[0..TC).
template <int TC>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[TC]) {
#pragma unroll
  for (int j = 0; j < TC; j += kColVec<TC>) {
    if constexpr (kColVec<TC> == 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    else if constexpr (kColVec<TC> == 2)
      *reinterpret_cast<float2*>(p + j) = make_float2(v[j], v[j + 1]);
    else
      p[j] = v[j];
  }
}

// The P x N partial tile of the K slab [k_begin, k_end) into part ([P][N]),
// on the thread tile <TR, TC, CG> (tile_for): thread t holds rows
// [(t / CG) TR, +TR) and columns [(t % CG) TC, +TC); the row groups span
// the stage's PP = (256 / CG) TR patch rows.  Each output sums the slab in
// ascending k with fmaf, whatever the tile.
template <int TR, int TC, int CG>
__device__ void produce_partial(const Args& a, const Layout& L,
                                const float* pa, int k_begin, int k_end,
                                float* ring, float* part) {
  constexpr int PP = kThreads / CG * TR;   // patch rows of a stage
  const int tid = threadIdx.x;
  const int rg = tid / CG, c0 = (tid % CG) * TC;
  const bool cols = c0 < a.N;
  const bool vec_a = a.K % 4 == 0;
  const int steps = (k_end - k_begin + kBK - 1) / kBK;
  const int stage = L.stage, nst = L.stages;
  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  auto load = [&](int slot, int step) {
    float* As = ring + slot * stage;
    float* Bs = As + PP * kLda;
    const int k0 = k_begin + step * kBK;
    if (vec_a) {                  // 16-byte patch rows: 4 k a copy
      for (int c = tid; c < PP * (kBK / 4); c += kThreads) {
        const int p = c / (kBK / 4), kq = (c % (kBK / 4)) * 4, k = k0 + kq;
        const bool in = p < a.P && k < k_end;
        cp_async16(As + p * kLda + kq, in ? pa + (size_t)p * a.K + k : pa,
                   in);
      }
    } else {                      // unaligned rows: one float a copy
      for (int c = tid; c < PP * kBK; c += kThreads) {
        const int p = c / kBK, kk = c % kBK, k = k0 + kk;
        const bool in = p < a.P && k < k_end;
        cp_async4(As + p * kLda + kk, in ? pa + (size_t)p * a.K + k : pa,
                  in);
      }
    }
    const int nq = a.N / 4;
    for (int c = tid; c < kBK * nq; c += kThreads) {
      const int kk = c / nq, cc = (c % nq) * 4, k = k0 + kk;
      const bool in = k < k_end;
      cp_async16(Bs + kk * a.N + cc,
                 in ? a.wpc + (size_t)k * a.N + cc : a.wpc, in);
    }
  };

  for (int s = 0; s < nst - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait_n(nst - 2);
    __syncthreads();              // stage st landed; stage st-1 is consumed
    if (st + nst - 1 < steps) load((st + nst - 1) % nst, st + nst - 1);
    cp_async_commit();
    const float* As = ring + (st % nst) * stage + rg * TR * kLda;
    const float* Bs = ring + (st % nst) * stage + PP * kLda + c0;
    if (cols) {
#pragma unroll
      for (int k4 = 0; k4 < kBK; k4 += 4) {
        float4 av[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          av[i] = *reinterpret_cast<const float4*>(As + i * kLda + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[TC];
          load_cols<TC>(Bs + (k4 + kk) * a.N, bv);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float x = gemm::lane_of(av[i], kk);
#pragma unroll
            for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
  gemm::cp_async_wait<0>();
  __syncthreads();                // the ring is free for the partial tile
  if (cols) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int p = rg * TR + i;
      if (p < a.P) store_cols<TC>(part + p * a.N + c0, acc[i]);
    }
  }
}

// One sample on a cluster: produce u on the thread tile <TR, TC, CG>, then
// route it.
template <int TR, int TC, int CG>
__device__ __forceinline__ void primary_routing(const Args& a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int smp = blockIdx.x / cs;
  const int jd = a.J * a.D;
  const Layout L = layout(a.P, a.N, a.C, a.J, a.D, cs, a.resident,
                          a.block_i);
  float* region = smem;
  float* u_s = region + L.region;               // [rows][C]
  ClusterScratch sc;
  sc.b = u_s + L.rows * a.C;                    // [rows][J]
  sc.s = sc.b + L.rows * a.J;
  sc.v = sc.s + jd;
  sc.part = sc.v + jd;                          // [2][J*D]
  sc.uh = region;                               // after the producer
  sc.c = region + L.vrows * (jd + 1);

  // Produce: this rank's slab of K, then its columns of every partial.
  const int slab = ((a.K + cs - 1) / cs + kBK - 1) / kBK * kBK;
  const int k_begin = min(a.K, rank * slab);
  produce_partial<TR, TC, CG>(a, L, a.patches + (size_t)smp * a.P * a.K,
                              k_begin, min(a.K, k_begin + slab), region,
                              region);
  cl.sync();                      // every partial tile is written
  const int n0 = rank * L.ns;
  for (int e = threadIdx.x; e < a.P * L.ns; e += kThreads) {
    const int p = e / L.ns, n = e % L.ns;
    float s = 0.f;
    for (int r = 0; r < cs; ++r)
      s += cl.map_shared_rank(region, r)[p * a.N + n0 + n];
    u_s[e] = s + a.bias[n0 + n];
  }
  cl.sync();                      // no peer reads the partials any more
  for (int l = threadIdx.x; l < L.rows; l += kThreads)
    squash_into(u_s + l * a.C, u_s + l * a.C, a.C);
  __syncthreads();

  const int groups = a.N / a.C, gs = L.ns / a.C;
  const OwnedRows own{L.rows, rank * gs, gs, cs > 1 ? groups : 0};
  route_cluster(cl, sc, VotesOfW{u_s, a.W, own, a.C}, own, a.J, a.D,
                a.iters, a.resident != 0, a.block_i, nullptr, nullptr,
                nullptr);
  if (rank == 0)
    for (int n = threadIdx.x; n < jd; n += blockDim.x)
      a.out[(size_t)smp * jd + n] = sc.v[n];
  cl.sync();                      // no CTA leaves while a peer reads it
}

// The 4-column tiles over 64 column groups, TR rows a thread (N = 256)...
template <int TR>
__global__ void __launch_bounds__(kThreads, 1)
primary_routing_kernel(Args a) {
  primary_routing<TR, 4, 64>(a);
}

// ... and the tiles of narrower N.
template <int TR, int TC, int CG>
__global__ void __launch_bounds__(kThreads, 1)
primary_routing_kernel_tiled(Args a) {
  primary_routing<TR, TC, CG>(a);
}

using KernelFn = void (*)(Args);

template <int TR, int TC, int CG>
KernelFn instance() {
  if constexpr (TC == 4 && CG == 64)
    return primary_routing_kernel<TR>;
  else
    return primary_routing_kernel_tiled<TR, TC, CG>;
}

// The template instance of a built tile (nullptr for any other).
inline KernelFn kernel_for(Tile t) {
#define REPRO_K5_KERNEL(TR, TC, CG) \
  if (t.tr == TR && t.tc == TC && t.cg == CG) return instance<TR, TC, CG>();
  REPRO_K5_TILES(REPRO_K5_KERNEL)
#undef REPRO_K5_KERNEL
  return nullptr;
}

}  // namespace k5
}  // namespace repro

// The kernel's own shared-memory layout in bytes (execplan models it).
REPRO_EXPORT int primary_routing_smem_bytes(int P, int N, int C, int J, int D,
                                            int cs, int resident,
                                            int block_i) {
  return repro::k5::layout(P, N, C, J, D, cs, resident, block_i).total *
         (int)sizeof(float);
}

// out = {the votes computations of a sample's CTA over the W stream
// (route_votes), its blocks of rows (1 where the votes come in whole)} at
// a K5 launch's sizes, for python -m repro_torch.verify.
REPRO_EXPORT int primary_routing_passes(int P, int N, int C, int J, int D,
                                        int cs, int resident, int block_i,
                                        int iters, int* out) {
  if (P < 1 || cs < 1 || N % cs || block_i < 1 || iters < 1)
    return cudaErrorInvalidValue;
  const repro::k5::Layout L =
      repro::k5::layout(P, N, C, J, D, cs, resident, block_i);
  out[0] = repro::route_votes(resident != 0, false, iters);
  out[1] = resident ? 1 : (L.rows + block_i - 1) / block_i;
  return cudaSuccess;
}

// patches [B, P, K], W_pc [K, N], bias [N], W [I, J*D, C] -> v [B, J*D], on
// B clusters of cs CTAs.  smem_bytes is the plan's footprint
// (execplan.primary_routing_smem), which must equal the kernel's layout.
REPRO_EXPORT int primary_routing_f32(const float* patches, const float* wpc,
                                     const float* bias, const float* W,
                                     float* out, int B, int P, int K, int N,
                                     int C, int J, int D, int iters,
                                     int resident, int block_i, int cs,
                                     int smem_bytes, void* stream) {
  using namespace repro;
  if (B < 1 || P < 1 || K < 1 || cs < 1 || cs > 16 || N % 4 || N > 256 ||
      N % cs || (N / cs) % C || (N / cs) % 4 || iters < 1 || block_i < 1)
    return cudaErrorInvalidValue;
  const k5::Layout L = k5::layout(P, N, C, J, D, cs, resident, block_i);
  const k5::KernelFn kernel = k5::kernel_for(k5::tile_for(P, N));
  if (!kernel || L.total * (int)sizeof(float) != smem_bytes)
    return cudaErrorInvalidValue;
  const k5::Args a{patches, wpc, bias, W, out, P, K, N, C, J, D, iters,
                   resident, block_i};
  return launch_clusters(kernel, B, cs, smem_bytes, (cudaStream_t)stream, a);
}

// out = {max active clusters, static shared bytes, max dynamic shared
// bytes, registers a thread} of the instance a launch at these sizes runs.
REPRO_EXPORT int primary_routing_occupancy(int P, int N, int C, int J, int D,
                                           int cs, int resident, int block_i,
                                           int* out) {
  using namespace repro;
  const k5::Layout L = k5::layout(P, N, C, J, D, cs, resident, block_i);
  const k5::KernelFn kernel = k5::kernel_for(k5::tile_for(P, N));
  if (!kernel) return cudaErrorInvalidValue;
  return cluster_occupancy(kernel, cs, L.total * (int)sizeof(float), out);
}

// out = {rows, columns a thread, row groups, column groups} of the thread
// tile a launch at P x N runs (execplan.pipe_tile mirrors the choice).
REPRO_EXPORT int primary_routing_tile(int P, int N, int* out) {
  const repro::k5::Tile t = repro::k5::tile_for(P, N);
  if (!t.tr) return cudaErrorInvalidValue;
  out[0] = t.tr;
  out[1] = t.tc;
  out[2] = repro::kThreads / t.cg;
  out[3] = t.cg;
  return cudaSuccess;
}
