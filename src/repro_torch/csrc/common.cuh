// Shared by the kernels of repro_torch: the rectifier rules of the paper
// (Eq. 3-5) and the packed-residual bit reads used by the fused backward
// kernels' prologues and epilogues.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Every C entry point: device pointers, sizes and a cudaStream_t in, the
// launch's cudaGetLastError() out.
#define REPRO_API extern "C" __attribute__((visibility("default")))

namespace repro {

// Method codes, as repro_torch.kernels.METHOD_CODES numbers them.
enum Method { kSaliency = 0, kDeconvnet = 1, kGuided = 2 };

// The method's rectifier rule on one gradient value; `bit` is the stored
// 1-bit ReLU mask (x > 0 in the forward), unread by deconvnet (Eq. 4).
__device__ __forceinline__ float gate(float g, bool bit, int method) {
  if (method == kDeconvnet) return g > 0.f ? g : 0.f;          // Eq. 4
  if (method == kGuided) return (bit && g > 0.f) ? g : 0.f;    // Eq. 5
  return bit ? g : 0.f;                                        // Eq. 3
}

// Bit `c` of a row of packed 1-bit masks (LSB first: channel 8b+j is bit j
// of byte b); false for a null mask.
__device__ __forceinline__ bool mask_bit(const uint8_t* row, int c) {
  return row != nullptr && ((row[c >> 3] >> (c & 7)) & 1);
}

// Crumb `c` of a row of packed 2-bit pool indices (channel 4b+j is crumb j
// of byte b).
__device__ __forceinline__ int crumb(const uint8_t* row, int c) {
  return (row[c >> 2] >> (2 * (c & 3))) & 3;
}

}  // namespace repro
