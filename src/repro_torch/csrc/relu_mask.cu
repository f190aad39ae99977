// Fused ReLU + 1-bit packed mask (paper §III.D, Fig. 4), on f32, on bf16
// (the bf16 path) and on the int16 (Q7.8) feature maps of the fxp16 path,
// and its masked backward on f32 and bf16 gradients.
//
// Replaces: src/repro/kernels/relu_mask/relu_mask.py, relu_fwd_pallas (the
// fxp16 path calls the same Pallas kernel on int16 blocks), and
// relu_bwd_pallas (the backward of the standalone ReLU of
// src/repro/kernels/relu_mask/ops.py).
//
// Forward: y = max(x, 0) over [R, C] and m [R, ceil(C/8)] with bit j of
// byte b = (x[:, 8b+j] > 0), strictly; bits past C are 0.
// Backward: r [R, C] from the gradient g [R, C] and m by the method's rule
// (Eq. 3-5): saliency m ? g : 0, guided m && g > 0 ? g : 0, deconvnet
// g > 0 ? g : 0 with no mask read; bits past C are never read.
//
// Bound on an H100: bytes.  The forward reads sizeof(T) bytes and writes
// sizeof(T) + 1/8 per element, the backward reads sizeof(T) + 1/8 (no mask
// byte for deconvnet) and writes sizeof(T); each does one compare or select
// per element, far below the card's compute rate.  The forward runs the
// B2 instance of relu_pool.cuh's template; relu_fwd_kernel below is its
// first design, kept as the general route (threads == 0), against which
// the card tests and chip_smoke.py hold and time the template.  Design of
// both it and the backward: one thread per mask byte covers its eight
// elements (two 16-byte loads and stores for f32, one for int16 and bf16,
// when C is a multiple of 8 and the pointers are 16-byte aligned, so a warp
// streams contiguous runs) and reads or writes the one byte.  No shared
// memory, no atomics: each output has exactly one writer.

#include "relu_pool.cuh"

namespace {

template <typename T>
__global__ void relu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                                uint8_t* __restrict__ m, int rows, int c,
                                int cb, int vec) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * cb) return;
  const int r = t / cb, c0 = 8 * (t - r * cb);
  const T* xr = x + static_cast<size_t>(r) * c;
  T* yr = y + static_cast<size_t>(r) * c;
  const T zero = T(0);
  uint32_t byte = 0;
  if (vec) {
    T v[8], o[8];
    Vec8<T>::load(xr + c0, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j] = v[j] > zero ? v[j] : zero;
      byte |= static_cast<uint32_t>(v[j] > zero) << j;
    }
    Vec8<T>::store(yr + c0, o);
  } else {
    for (int j = 0; j < 8 && c0 + j < c; ++j) {
      const T v = xr[c0 + j];
      yr[c0 + j] = v > zero ? v : zero;
      byte |= static_cast<uint32_t>(v > zero) << j;
    }
  }
  m[t] = static_cast<uint8_t>(byte);
}

// threads == 0: the general kernel (256-thread blocks); else the template's
// B2 instance in blocks of `threads`, with programmatic dependent launch.
template <typename T>
int relu_fwd(const T* x, T* y, uint8_t* m, int rows, int c, int threads,
             cudaStream_t stream) {
  if (threads != 0)
    return rp::launch<T, false, true, true>(x, y, m, nullptr, rows, 1, 1, c,
                                            threads, stream);
  const int cb = (c + 7) / 8;
  const int vec = (c % 8 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const int total = rows * cb, general_threads = 256;
  relu_fwd_kernel<T><<<(total + general_threads - 1) / general_threads,
                       general_threads, 0, stream>>>(x, y, m, rows, c, cb,
                                                     vec);
  return static_cast<int>(cudaGetLastError());
}

// The rectifier rule of method M on eight gradients of one mask byte; the
// method is a template parameter, so the deconvnet instance reads no mask.
template <typename T, int M>
__global__ void relu_bwd_kernel(const uint8_t* __restrict__ m,
                                const T* __restrict__ g, T* __restrict__ r,
                                int rows, int c, int cb, int vec) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * cb) return;
  const int row = t / cb, c0 = 8 * (t - row * cb);
  const size_t off = static_cast<size_t>(row) * c + c0;
  const uint32_t byte = M == repro::kDeconvnet ? 0u : m[t];
  if (vec) {
    T v[8];
    Vec8<T>::load(g + off, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = repro::gate(v[j], (byte >> j) & 1, M);
    Vec8<T>::store(r + off, v);
  } else {
    for (int j = 0; j < 8 && c0 + j < c; ++j)
      r[off + j] = repro::gate(g[off + j], (byte >> j) & 1, M);
  }
}

template <typename T>
int relu_bwd(const uint8_t* m, const T* g, T* r, int rows, int c,
             int method, cudaStream_t stream) {
  const int cb = (c + 7) / 8;
  const int vec = (c % 8 == 0) &&
                  (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(r) % 16 == 0);
  const int total = rows * cb, threads = 256;
  const int blocks = (total + threads - 1) / threads;
  switch (method) {
    case repro::kSaliency:
      relu_bwd_kernel<T, repro::kSaliency><<<blocks, threads, 0, stream>>>(
          m, g, r, rows, c, cb, vec);
      break;
    case repro::kDeconvnet:
      relu_bwd_kernel<T, repro::kDeconvnet><<<blocks, threads, 0, stream>>>(
          m, g, r, rows, c, cb, vec);
      break;
    case repro::kGuided:
      relu_bwd_kernel<T, repro::kGuided><<<blocks, threads, 0, stream>>>(
          m, g, r, rows, c, cb, vec);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
                             int c, int threads, cudaStream_t stream) {
  return relu_fwd<float>(x, y, m, rows, c, threads, stream);
}

REPRO_API int repro_relu_fwd_bf16(const __nv_bfloat16* x, __nv_bfloat16* y,
                                  uint8_t* m, int rows, int c, int threads,
                                  cudaStream_t stream) {
  return relu_fwd<__nv_bfloat16>(x, y, m, rows, c, threads, stream);
}

REPRO_API int repro_relu_fwd_i16(const int16_t* x, int16_t* y, uint8_t* m,
                                 int rows, int c, int threads,
                                 cudaStream_t stream) {
  return relu_fwd<int16_t>(x, y, m, rows, c, threads, stream);
}

// m may be null for deconvnet (method 1), which reads no mask.
REPRO_API int repro_relu_bwd(const uint8_t* m, const float* g, float* r,
                             int rows, int c, int method,
                             cudaStream_t stream) {
  return relu_bwd<float>(m, g, r, rows, c, method, stream);
}

// The gate on a bf16 gradient (the bf16 autograd paths): selects, so the
// bits are the plain version's.
REPRO_API int repro_relu_bwd_bf16(const uint8_t* m, const __nv_bfloat16* g,
                                  __nv_bfloat16* r, int rows, int c,
                                  int method, cudaStream_t stream) {
  return relu_bwd<__nv_bfloat16>(m, g, r, rows, c, method, stream);
}
