// Fused ReLU + 1-bit packed mask (paper §III.D, Fig. 4).
//
// Replaces: src/repro/kernels/relu_mask/relu_mask.py, relu_fwd_pallas.
//
// Computes y = max(x, 0) over [R, C] and m [R, ceil(C/8)] with bit j of
// byte b = (x[:, 8b+j] > 0), strictly; bits past C are 0.
//
// Bound on an H100: bytes.  It reads 4 bytes and writes 4 + 1/8 per element
// and does one compare per element, far below the card's compute rate.
// Design: one thread per output mask byte reads its eight inputs (two
// 16-byte loads when C is a multiple of 8 and the pointers are aligned, so
// a warp streams 1 KB contiguously), writes eight outputs and one byte.
// No shared memory, no atomics: each byte has exactly one writer.

#include "common.cuh"

namespace {

__global__ void relu_fwd_kernel(const float* __restrict__ x,
                                float* __restrict__ y,
                                uint8_t* __restrict__ m, int rows, int c,
                                int cb, int vec) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * cb) return;
  const int r = t / cb, c0 = 8 * (t - r * cb);
  const float* xr = x + static_cast<size_t>(r) * c;
  float* yr = y + static_cast<size_t>(r) * c;
  uint32_t byte = 0;
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(xr + c0);
    const float4 a = p[0], b = p[1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j] = v[j] > 0.f ? v[j] : 0.f;
      byte |= static_cast<uint32_t>(v[j] > 0.f) << j;
    }
    float4* q = reinterpret_cast<float4*>(yr + c0);
    q[0] = make_float4(o[0], o[1], o[2], o[3]);
    q[1] = make_float4(o[4], o[5], o[6], o[7]);
  } else {
    for (int j = 0; j < 8 && c0 + j < c; ++j) {
      const float v = xr[c0 + j];
      yr[c0 + j] = v > 0.f ? v : 0.f;
      byte |= static_cast<uint32_t>(v > 0.f) << j;
    }
  }
  m[t] = static_cast<uint8_t>(byte);
}

}  // namespace

REPRO_API const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The library links its own CUDA runtime, whose current device is not
// PyTorch's: every launch first selects the operands' device.
REPRO_API int repro_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

REPRO_API int repro_relu_fwd(const float* x, float* y, uint8_t* m, int rows,
                             int c, cudaStream_t stream) {
  const int cb = (c + 7) / 8;
  const int vec = (c % 8 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const int total = rows * cb, threads = 256;
  relu_fwd_kernel<<<(total + threads - 1) / threads, threads, 0, stream>>>(
      x, y, m, rows, c, cb, vec);
  return static_cast<int>(cudaGetLastError());
}
