// K14a caps_votes: the split path's ClassCaps-FC, u_hat written to device
// memory.  u_hat[b, i, n] = sum_c W[i, n, c] * u[b, i, c].
//
// Replaces src/repro/kernels/caps_votes.py: _votes_kernel, one grid step
// per i-block of the sequential TPU grid.  It is the paper's baseline:
// the fused votes_routing (K3/K4) never writes u_hat, this kernel writes
// all of it (B * I * J*D floats) for routing.cu (K14b) to read back.
//
// What bounds it: bytes.  W (I * N * C floats, 5.9 MB at MNIST width) is
// reuse-free across CTAs -- each element serves only the batch -- and
// u_hat (B * I * N floats, 5.9 MB at batch 8) is written once: ~12 MB
// against 2 * B * C flops per u_hat element.  An earlier design staged
// each CTA's whole W block in shared memory behind a barrier, with
// integer divisions on every staged float: each CTA's serial chain, not
// the bytes, set its time.  This one streams W through registers:
//   - a CTA takes `block_i` rows of I, their block_i * N (i, n) columns;
//     a thread takes a column at a time (execplan.caps_votes_grid: one
//     column a thread at the plan's block_i), neighbouring threads on
//     neighbouring columns;
//   - the thread reads its W row [C] once, straight into registers (two
//     float4 at C = 8), issued first, so it is in flight while the CTA
//     stages u: a warp reads 32 consecutive rows, one contiguous stretch;
//   - the CTA copies its rows of u for up to kSampleChunk samples into
//     shared memory at once (execplan.caps_votes_smem), so a thread's
//     samples cost one round trip a chunk, not one each;
//   - for every sample the thread reads u[b, i, :] from shared memory (a
//     broadcast: a warp's columns mostly share one i) and writes
//     u_hat[b, i, n]: a warp writes 128 contiguous bytes a sample;
//   - no division on the load paths: the thread's (row, column) and the
//     staging's (sample, float) advance by adds.  C = 8, every model's
//     width, is compiled for; any other C re-reads W's row from L1.  Loads
//     are float4 where C % 4 == 0 and both inputs are 16-byte aligned,
//     else scalars.
// The sum runs c = 0..C-1 in fmaf from 0, as the earlier kernel's did,
// so u_hat keeps its bits.  The ragged last i-block is masked.  Forward
// only, as in the reference.

#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kSampleChunk = 64;   // execplan.CAPS_VOTES_CHUNK

// C floats at p (global or shared memory) into registers.
template <int C, bool kVec>
__device__ inline void load_row(const float* p, float (&r)[C]) {
  if constexpr (kVec) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      r[c] = v.x;
      r[c + 1] = v.y;
      r[c + 2] = v.z;
      r[c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = p[c];
  }
}

// Elements e = start, start + step, ... of a [rows][len] span, with e's
// (row, col) advanced by adds: one division when the walk starts.
struct Walk {
  int e, row, col, drow, dcol;
};

__device__ inline Walk walk_from(int start, int step, int len) {
  return Walk{start, start / len, start % len, step / len, step % len};
}

__device__ inline void advance(Walk& w, int step, int len) {
  w.e += step;
  w.row += w.drow;
  w.col += w.dcol;
  if (w.col >= len) {
    w.col -= len;
    ++w.row;
  }
}

// kC = 0: any C (given at run time), W's row re-read for each sample.
// At C = 8, 40 registers a thread: the MNIST plan's 1152 CTAs of 160
// threads then fit the card at once (at 48, a tenth waited).
template <int kC, bool kVec>
__global__ void __launch_bounds__(kThreads, kC == 8 ? 6 : 1)
caps_votes_kernel(const float* __restrict__ u, const float* __restrict__ W,
                  float* __restrict__ out, int B, int I, int Cr, int N,
                  int block_i) {
  extern __shared__ float4 u_s4[];        // [chunk samples][rows][C]
  float* u_s = reinterpret_cast<float*>(u_s4);
  constexpr int V = kVec ? 4 : 1;         // floats a load
  const int C = kC ? kC : Cr;
  const int i0 = blockIdx.x * block_i;
  const int rows = min(block_i, I - i0);
  const int cols = rows * N;
  const long long plane = (long long)I * N;   // one sample of u_hat
  const long long base = (long long)i0 * N;   // the CTA's first column
  const int step = blockDim.x;
  const Walk first = walk_from(threadIdx.x, step, N);
  const bool one_col = first.e + step >= cols;
  float wr[kC ? kC : 1];
  if constexpr (kC > 0)
    if (first.e < cols) load_row<kC, kVec>(W + (base + first.e) * kC, wr);
  const int q = rows * C / V;             // loads of one sample's u rows
  for (int b0 = 0; b0 < B; b0 += kSampleChunk) {
    const int nb = min(kSampleChunk, B - b0);
    if (b0) __syncthreads();              // the last chunk is read
    for (Walk s = walk_from(threadIdx.x, step, q); s.e < nb * q;
         advance(s, step, q)) {
      const long long at =
          ((long long)(b0 + s.row) * I + i0) * C / V + s.col;
      if constexpr (kVec)
        u_s4[s.e] = __ldg(reinterpret_cast<const float4*>(u) + at);
      else
        u_s[s.e] = __ldg(u + at);
    }
    __syncthreads();
    for (Walk w = first; w.e < cols; advance(w, step, N)) {
      const float* wg = W + (base + w.e) * C;
      if constexpr (kC > 0)
        if (w.e != first.e || (b0 && !one_col)) load_row<kC, kVec>(wg, wr);
      const float* us = u_s + w.row * C;  // sample b at us + b * rows * C
      float* o = out + base + w.e + b0 * plane;
#pragma unroll 4
      for (int b = 0; b < nb; ++b) {
        const float* ub = us + b * rows * C;
        float acc = 0.f;
        if constexpr (kC > 0) {
          float x[kC];
          load_row<kC, kVec>(ub, x);
#pragma unroll
          for (int c = 0; c < kC; ++c) acc = fmaf(wr[c], x[c], acc);
        } else {
          for (int c = 0; c < C; ++c) acc = fmaf(__ldg(wg + c), ub[c], acc);
        }
        o[b * plane] = acc;
      }
    }
  }
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int kC>
void launch(const float* u, const float* W, float* out, int B, int I, int C,
            int N, int block_i, int threads, int smem, cudaStream_t s) {
  const int grid = (I + block_i - 1) / block_i;
  if (C % 4 == 0 && aligned16(u) && aligned16(W))
    caps_votes_kernel<kC, true><<<grid, threads, smem, s>>>(u, W, out, B, I,
                                                            C, N, block_i);
  else
    caps_votes_kernel<kC, false><<<grid, threads, smem, s>>>(u, W, out, B,
                                                             I, C, N,
                                                             block_i);
}

template <int kC>
cudaError_t allow_smem(int smem) {
  cudaError_t err = cudaSuccess;
  for (auto fn : {caps_votes_kernel<kC, true>, caps_votes_kernel<kC, false>})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err;
}

}  // namespace repro

// u [B, I, C], W [I, N, C] -> u_hat [B, I, N]: ceil(I / block_i) CTAs of
// `threads` threads (execplan.caps_votes_grid), `smem_bytes` of shared
// memory each (execplan.caps_votes_smem).
REPRO_EXPORT int caps_votes_f32(const float* u, const float* W, float* out,
                                int B, int I, int C, int N, int block_i,
                                int threads, int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (smem_bytes > 48 * 1024) {           // above the default: opt in
    const cudaError_t err = C == 8 ? repro::allow_smem<8>(smem_bytes)
                                   : repro::allow_smem<0>(smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (C == 8)
    repro::launch<8>(u, W, out, B, I, C, N, block_i, threads, smem_bytes, s);
  else
    repro::launch<0>(u, W, out, B, I, C, N, block_i, threads, smem_bytes, s);
  return (int)cudaGetLastError();
}
