// 2x2/2 max pool + 2-bit argmax (paper §III.D, Fig. 5), on f32, on bf16
// (the bf16 path) and on the int16 (Q7.8) feature maps of the fxp16 path,
// and its unpool backward on each of the three.
//
// Replaces: src/repro/kernels/pool/pool.py, maxpool_fwd_pallas and
// unpool_bwd_pallas, and their int16 instances pinned by
// src/repro/kernels/pool/fxp.py, maxpool_fwd_fxp and unpool_bwd_fxp.
//
// Forward: x [N, H, W, C] -> y [N, H/2, W/2, C] and idx [N, H/2, W/2,
// ceil(C/4)], crumb j of byte b = argmax of channel 4b+j over the window
// candidates in the order (0,0), (0,1), (1,0), (1,1).  The scan replaces
// only on a strictly greater value, so ties go to the first candidate, as
// jnp.argmax does; ties are the common case (all-zero post-ReLU windows,
// and more so on the int16 grid), so this is what keeps the crumbs bitwise
// equal to the reference.
// Backward (unpool): g [N, H/2, W/2, C] and idx -> out [N, H, W, C], the
// pooled gradient at the stored argmax candidate of its window and 0 at
// the other three; crumbs past C are never read.
//
// Bound on an H100: bytes.  The forward reads sizeof(T) B and writes
// sizeof(T)/4 B + 1/16 B per input element (three compares); the backward
// reads sizeof(T)/4 B + 1/16 B and writes sizeof(T) B per output element
// (one select).  Design, both ways: one thread per crumb byte covers four
// channels of one window, so neighbouring threads read and write
// neighbouring runs of each candidate row; the backward writes all four
// candidates itself, zeros included, so every output element has exactly
// one writer (no memset, no scatter, no atomics) and is written once, with
// one 4-element vector per candidate when C % 4 == 0 and the pointers are
// aligned to it.  No shared memory.  The forward runs the B3 instance of
// relu_pool.cuh's template, and the fused ReLU+mask+pool instances of the
// pooled layers enter here too; maxpool_fwd_kernel below is the first
// design of the forward, kept as the general route (threads == 0), against
// which the card tests and chip_smoke.py hold and time the template.

#include "relu_pool.cuh"

namespace {

template <typename T>
__global__ void maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   uint8_t* __restrict__ idx, int n, int h,
                                   int w, int c, int cb) {
  const int ho = h / 2, wo = w / 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * ho * wo * cb) return;
  const int b = t % cb, pix = t / cb;            // pix = (nn*ho + i)*wo + j
  const int j = pix % wo, i = (pix / wo) % ho, nn = pix / (wo * ho);
  const T* c00 = x + ((static_cast<size_t>(nn) * h + 2 * i) * w + 2 * j) * c;
  const size_t row = static_cast<size_t>(w) * c;
  const T* cand[4] = {c00, c00 + c, c00 + row, c00 + row + c};
  T* yp = y + static_cast<size_t>(pix) * c;
  uint32_t byte = 0;
  for (int q = 0; q < 4; ++q) {
    const int ch = 4 * b + q;
    if (ch >= c) break;
    T best = cand[0][ch];
    int k = 0;
#pragma unroll
    for (int kk = 1; kk < 4; ++kk) {
      const T v = cand[kk][ch];
      if (v > best) {          // strict: the first maximum wins
        best = v;
        k = kk;
      }
    }
    yp[ch] = best;
    byte |= static_cast<uint32_t>(k) << (2 * q);
  }
  idx[t] = static_cast<uint8_t>(byte);
}

// threads == 0: the general kernel (256-thread blocks); else the template's
// B3 instance in blocks of `threads`, with programmatic dependent launch.
template <typename T>
int maxpool_fwd(const T* x, T* y, uint8_t* idx, int n, int h, int w, int c,
                int threads, cudaStream_t stream) {
  if (threads != 0)
    return rp::launch<T, true, false, false>(x, y, nullptr, idx,
                                             n * (h / 2) * (w / 2), h, w, c,
                                             threads, stream);
  const int cb = (c + 3) / 4;
  const int total = n * (h / 2) * (w / 2) * cb, general_threads = 256;
  maxpool_fwd_kernel<T>
      <<<(total + general_threads - 1) / general_threads, general_threads,
         0, stream>>>(x, y, idx, n, h, w, c, cb);
  return static_cast<int>(cudaGetLastError());
}

// The fused ReLU (+ mask where m is not null) + pool of a pooled layer:
// the template's <T, true, true, true> or <T, true, true, false>.
template <typename T>
int relu_pool_fwd(const T* x, T* y, uint8_t* m, uint8_t* idx, int n, int h,
                  int w, int c, int threads, cudaStream_t stream) {
  const int pixels = n * (h / 2) * (w / 2);
  if (m == nullptr)
    return rp::launch<T, true, true, false>(x, y, m, idx, pixels, h, w, c,
                                            threads, stream);
  return rp::launch<T, true, true, true>(x, y, m, idx, pixels, h, w, c,
                                         threads, stream);
}

// Four consecutive elements as one vector (16 bytes of f32, 8 of int16 or
// bf16).
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  __device__ static void load(const float* p, float v[4]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ static void store(float* p, const float v[4]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec4<int16_t> {
  union U {
    uint2 q;
    int16_t h[4];
  };
  __device__ static void load(const int16_t* p, int16_t v[4]) {
    U u;
    u.q = reinterpret_cast<const uint2*>(p)[0];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = u.h[j];
  }
  __device__ static void store(int16_t* p, const int16_t v[4]) {
    U u;
#pragma unroll
    for (int j = 0; j < 4; ++j) u.h[j] = v[j];
    reinterpret_cast<uint2*>(p)[0] = u.q;
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, __nv_bfloat16 v[4]) {
    const uint2 q = reinterpret_cast<const uint2*>(p)[0];
    v[0] = __ushort_as_bfloat16(static_cast<unsigned short>(q.x));
    v[1] = __ushort_as_bfloat16(static_cast<unsigned short>(q.x >> 16));
    v[2] = __ushort_as_bfloat16(static_cast<unsigned short>(q.y));
    v[3] = __ushort_as_bfloat16(static_cast<unsigned short>(q.y >> 16));
  }
  __device__ static void store(__nv_bfloat16* p, const __nv_bfloat16 v[4]) {
    uint2 q;
    q.x = static_cast<uint32_t>(__bfloat16_as_ushort(v[0])) |
          static_cast<uint32_t>(__bfloat16_as_ushort(v[1])) << 16;
    q.y = static_cast<uint32_t>(__bfloat16_as_ushort(v[2])) |
          static_cast<uint32_t>(__bfloat16_as_ushort(v[3])) << 16;
    reinterpret_cast<uint2*>(p)[0] = q;
  }
};

template <typename T>
__global__ void unpool_bwd_kernel(const uint8_t* __restrict__ idx,
                                  const T* __restrict__ g,
                                  T* __restrict__ out, int n, int hp, int wp,
                                  int c, int cb, int vec) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * hp * wp * cb) return;
  const int b = t % cb, pix = t / cb;            // pix = (nn*hp + i)*wp + j
  const int j = pix % wp, i = (pix / wp) % hp, nn = pix / (wp * hp);
  const uint32_t byte = idx[t];
  const T* gp = g + static_cast<size_t>(pix) * c + 4 * b;
  const size_t row = static_cast<size_t>(2 * wp) * c;
  T* c00 = out + ((static_cast<size_t>(nn) * 2 * hp + 2 * i) * (2 * wp)
                  + 2 * j) * c + 4 * b;
  T* cand[4] = {c00, c00 + c, c00 + row, c00 + row + c};
  const T zero = T(0);
  if (vec) {
    T v[4];
    Vec4<T>::load(gp, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      T o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = static_cast<int>((byte >> (2 * q)) & 3) == k ? v[q] : zero;
      Vec4<T>::store(cand[k], o);
    }
  } else {
    for (int q = 0; q < 4 && 4 * b + q < c; ++q) {
      const T v = gp[q];
      const int sel = (byte >> (2 * q)) & 3;
#pragma unroll
      for (int k = 0; k < 4; ++k) cand[k][q] = sel == k ? v : zero;
    }
  }
}

template <typename T>
int unpool_bwd(const uint8_t* idx, const T* g, T* out, int n, int hp,
               int wp, int c, cudaStream_t stream) {
  const int cb = (c + 3) / 4;
  const uintptr_t vbytes = 4 * sizeof(T);
  const int vec = (c % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(g) % vbytes == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % vbytes == 0);
  const int total = n * hp * wp * cb, threads = 256;
  unpool_bwd_kernel<T>
      <<<(total + threads - 1) / threads, threads, 0, stream>>>(
          idx, g, out, n, hp, wp, c, cb, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_API int repro_maxpool_fwd(const float* x, float* y, uint8_t* idx, int n,
                                int h, int w, int c, int threads,
                                cudaStream_t stream) {
  return maxpool_fwd<float>(x, y, idx, n, h, w, c, threads, stream);
}

REPRO_API int repro_maxpool_fwd_bf16(const __nv_bfloat16* x,
                                     __nv_bfloat16* y, uint8_t* idx, int n,
                                     int h, int w, int c, int threads,
                                     cudaStream_t stream) {
  return maxpool_fwd<__nv_bfloat16>(x, y, idx, n, h, w, c, threads, stream);
}

REPRO_API int repro_maxpool_fwd_i16(const int16_t* x, int16_t* y,
                                    uint8_t* idx, int n, int h, int w, int c,
                                    int threads, cudaStream_t stream) {
  return maxpool_fwd<int16_t>(x, y, idx, n, h, w, c, threads, stream);
}

// m may be null: the no-mask instance (deconvnet stores no ReLU mask).
REPRO_API int repro_relu_pool_fwd(const float* x, float* y, uint8_t* m,
                                  uint8_t* idx, int n, int h, int w, int c,
                                  int threads, cudaStream_t stream) {
  return relu_pool_fwd<float>(x, y, m, idx, n, h, w, c, threads, stream);
}

REPRO_API int repro_relu_pool_fwd_bf16(const __nv_bfloat16* x,
                                       __nv_bfloat16* y, uint8_t* m,
                                       uint8_t* idx, int n, int h, int w,
                                       int c, int threads,
                                       cudaStream_t stream) {
  return relu_pool_fwd<__nv_bfloat16>(x, y, m, idx, n, h, w, c, threads,
                                      stream);
}

REPRO_API int repro_relu_pool_fwd_i16(const int16_t* x, int16_t* y,
                                      uint8_t* m, uint8_t* idx, int n, int h,
                                      int w, int c, int threads,
                                      cudaStream_t stream) {
  return relu_pool_fwd<int16_t>(x, y, m, idx, n, h, w, c, threads, stream);
}

REPRO_API int repro_unpool_bwd(const uint8_t* idx, const float* g, float* out,
                               int n, int hp, int wp, int c,
                               cudaStream_t stream) {
  return unpool_bwd<float>(idx, g, out, n, hp, wp, c, stream);
}

REPRO_API int repro_unpool_bwd_i16(const uint8_t* idx, const int16_t* g,
                                   int16_t* out, int n, int hp, int wp,
                                   int c, cudaStream_t stream) {
  return unpool_bwd<int16_t>(idx, g, out, n, hp, wp, c, stream);
}

// The unpool of a bf16 gradient (the bf16 autograd paths): a scatter, so
// the bits are the plain version's (+0 at the three other candidates).
REPRO_API int repro_unpool_bwd_bf16(const uint8_t* idx,
                                    const __nv_bfloat16* g,
                                    __nv_bfloat16* out, int n, int hp,
                                    int wp, int c, cudaStream_t stream) {
  return unpool_bwd<__nv_bfloat16>(idx, g, out, n, hp, wp, c, stream);
}
