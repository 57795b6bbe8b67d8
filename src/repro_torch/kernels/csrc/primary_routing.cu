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
// 20,736 x 256 at MNIST) along K.  CTA rank r computes the whole P x N
// tile over its slab of K (a multiple of kBK, the last ragged) from the
// sample's patches (written by K1) and W_pc, through a ring of cp.async
// stages, as deep as the region the consumer needs anyway and at least 64
// KB: the stream comes from L2, and the bytes in flight set its rate.  Each
// of the 256 threads holds a TR x 4 block of the tile (TR = ceil(P / 4)
// rows, 4 columns; 36 or 64 accumulators at MNIST / SVHN), reading the
// patch rows as one float4 of 4 k (broadcast across the warp) and W_pc as
// one float4 a k.  The partial tiles then meet through distributed shared
// memory: each CTA adds its own N/cs columns of all cs partials in rank
// order, adds the bias and squashes each capsule, so u lands in the CTA
// that routes it; the slice's [P][N/cs] layout is exactly the CTA's
// [rows][C] capsule rows.  (A split of N instead would leave each CTA a
// 36 x 32 slice: 4.5 outputs a thread, too few to hide the shared-memory
// reads, and every CTA would read the whole patch tile.)
// Consume: routing_cluster.cuh routes the sample over the cluster on those
// rows (votes resident or streamed, the plan's mode), so neither u nor
// u_hat goes to device memory; only s crosses CTAs.  The producer's ring,
// its partial tile and the consumer's votes rows share one region.
//
// What bounds it on the H100: the producer's 2*36*20,736*256 = 382 M fp32
// operations a sample (MNIST; the votes are 2.9 M a pass) over 67 TFLOP/s,
// 0.046 ms at batch 8 -- if every SM works.  One CTA a sample (the earlier
// design) kept B of 132 SMs busy; clusters of 8 spread a batch of 8 over 64
// SMs, of 16 over 128 (in two waves: an H100 runs 7 clusters of 16 at once).

#include "gemm_sm90.cuh"
#include "routing_cluster.cuh"

namespace repro {
namespace k5 {

using gemm::cp_async16;
using gemm::cp_async4;
using gemm::cp_async_commit;
constexpr int kBK = 16;            // K per ring stage (execplan.PIPE_BLOCK_K)
constexpr int kLda = kBK + 4;      // a patch row in a stage, padded
constexpr int kColGroups = 64;     // 4-column groups: N <= 256
constexpr int kRowGroups = kThreads / kColGroups;
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

// Rows a thread holds of the P x N tile: the smallest built TR with
// 4 TR >= P (0 past the kernel's 64 positions).
__host__ __device__ inline int rows_per_thread(int P) {
  const int need = (P + 3) / 4;
  const int built[] = {1, 2, 3, 4, 6, 8, 9, 12, 16};
  for (int tr : built)
    if (tr >= need) return tr;
  return 0;
}

// The shared memory of one CTA, in floats (execplan.primary_routing_smem
// models the same sum): the region (the producer's ring of `stages` stages
// and then its P x N partial tile, then the consumer's votes rows and
// couplings), u, the logits, and s, v and the two partials of s.
struct Layout {
  int ns, rows, vrows, tr, stage, stages, region, total;
};

__host__ __device__ inline Layout layout(int P, int N, int C, int J, int D,
                                         int cs, int resident, int block_i) {
  Layout L;
  const int jd = J * D;
  L.ns = N / cs;
  L.rows = P * L.ns / C;
  L.vrows = resident ? L.rows : min(block_i, L.rows);
  L.tr = rows_per_thread(P);
  L.stage = kRowGroups * L.tr * kLda + kBK * N;
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

// The P x N partial tile of the K slab [k_begin, k_end) into part ([P][N]).
template <int TR>
__device__ void produce_partial(const Args& a, const Layout& L,
                                const float* pa, int k_begin, int k_end,
                                float* ring, float* part) {
  constexpr int PP = kRowGroups * TR;   // padded rows of a stage
  const int tid = threadIdx.x;
  const int rg = tid / kColGroups, cg4 = (tid % kColGroups) * 4;
  const bool cols = cg4 < a.N;
  const bool vec_a = a.K % 4 == 0;
  const int steps = (k_end - k_begin + kBK - 1) / kBK;
  const int stage = L.stage, nst = L.stages;
  float acc[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

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
    const float* Bs = ring + (st % nst) * stage + PP * kLda + cg4;
    if (cols) {
#pragma unroll
      for (int k4 = 0; k4 < kBK; k4 += 4) {
        float4 av[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          av[i] = *reinterpret_cast<const float4*>(As + i * kLda + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 bv =
              *reinterpret_cast<const float4*>(Bs + (k4 + kk) * a.N);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float x = gemm::lane_of(av[i], kk);
            acc[i][0] = fmaf(x, bv.x, acc[i][0]);
            acc[i][1] = fmaf(x, bv.y, acc[i][1]);
            acc[i][2] = fmaf(x, bv.z, acc[i][2]);
            acc[i][3] = fmaf(x, bv.w, acc[i][3]);
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
      if (p < a.P)
        *reinterpret_cast<float4*>(part + p * a.N + cg4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <int TR>
__global__ void __launch_bounds__(kThreads, 1)
primary_routing_kernel(Args a) {
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
  produce_partial<TR>(a, L, a.patches + (size_t)smp * a.P * a.K, k_begin,
                      min(a.K, k_begin + slab), region, region);
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

// The template instance that holds tr rows a thread.
inline void (*kernel_for(int tr))(Args) {
  switch (tr) {
    case 1: return primary_routing_kernel<1>;
    case 2: return primary_routing_kernel<2>;
    case 3: return primary_routing_kernel<3>;
    case 4: return primary_routing_kernel<4>;
    case 6: return primary_routing_kernel<6>;
    case 8: return primary_routing_kernel<8>;
    case 9: return primary_routing_kernel<9>;
    case 12: return primary_routing_kernel<12>;
    case 16: return primary_routing_kernel<16>;
    default: return nullptr;
  }
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
  if (B < 1 || P < 1 || K < 1 || cs < 1 || cs > 16 || N % 4 ||
      N > 4 * k5::kColGroups || N % cs || (N / cs) % C || (N / cs) % 4 ||
      iters < 1 || block_i < 1)
    return cudaErrorInvalidValue;
  const k5::Layout L = k5::layout(P, N, C, J, D, cs, resident, block_i);
  void (*kernel)(k5::Args) = k5::kernel_for(L.tr);
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
  void (*kernel)(k5::Args) = k5::kernel_for(L.tr);
  if (!kernel) return cudaErrorInvalidValue;
  return cluster_occupancy(kernel, cs, L.total * (int)sizeof(float), out);
}
