// Shared by the kernels of repro_torch: the rectifier rules of the paper
// (Eq. 3-5), the packed-residual bit reads used by the fused backward
// kernels' prologues and epilogues, and the cp.async copies of the tiled
// convolutions.
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

// The same rule on an int16 (Q7.8) gradient of the fxp16 path.
__device__ __forceinline__ int gate(int g, bool bit, int method) {
  if (method == kDeconvnet) return g > 0 ? g : 0;
  if (method == kGuided) return (bit && g > 0) ? g : 0;
  return bit ? g : 0;
}

// fxp16 numeric contract, as repro_torch.core.fixedpoint states it.
constexpr int kWgtFrac = 14;       // fixedpoint.WGT_FRAC: Q1.14 weights
constexpr int kInt16Lim = 32767;   // fixedpoint.INT16_LIM: symmetric rails

__device__ __forceinline__ int sat16(int v) {
  return max(-kInt16Lim, min(kInt16Lim, v));
}

// int32 accumulator -> Q7.8 value: clip((acc + 2^13) >> 14, ±32767).  The
// accumulator is kept as uint32_t so that sums and the rounding add wrap
// modulo 2^32 as XLA's and NumPy's int32 do (signed overflow is undefined
// in C++); the shift is then arithmetic, on the int32 value.
__device__ __forceinline__ int requantize(uint32_t acc) {
  const int32_t v = static_cast<int32_t>(acc + (1u << (kWgtFrac - 1)));
  return sat16(v >> kWgtFrac);
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

// Asynchronous global -> shared copy of N = 4, 8 or 16 bytes (both
// addresses aligned to N); ok == false zero-fills them (source size 0).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 B");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0));
  } else if constexpr (N == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 8 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace repro
