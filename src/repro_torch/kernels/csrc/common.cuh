// Shared by every kernel library of the port: the export macro of the plain
// C interface (bound from Python through ctypes) and the capsule squash.
#pragma once

#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr int kThreads = 256;      // threads of every CTA of the port
constexpr float kSquashEps = 1e-7f;

// v = ||s||^2 / (1 + ||s||^2) * s / ||s||, written as the reference does:
// (sq / (1 + sq)) * s * rsqrt(sq + eps), over the D floats at x.
__device__ inline void squash_into(const float* x, float* y, int D) {
  float sq = 0.f;
  for (int d = 0; d < D; ++d) sq = fmaf(x[d], x[d], sq);
  const float a = sq / (1.f + sq);
  const float r = rsqrtf(sq + kSquashEps);
  for (int d = 0; d < D; ++d) y[d] = a * x[d] * r;
}

// What the card says of a plain (non-cluster) kernel launched with kThreads
// threads and smem bytes of dynamic shared memory, for the plan auditor
// (python -m repro_torch.verify): out = {CTAs of it an SM holds at once,
// static shared bytes, smem, registers a thread}.  A kernel above 48 KB
// opts in first, as its launch does.
inline cudaError_t kernel_attributes(const void* kernel, int smem, int* out) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = smem;
  out[3] = fa.numRegs;
  return cudaSuccess;
}

}  // namespace repro

// Message of a CUDA error code returned by one of the library's entries.
REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
