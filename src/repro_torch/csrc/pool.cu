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
// (one select).  Design, both ways: one thread covers a run of channels
// of one window, so neighbouring threads read and write neighbouring runs
// of each candidate row; the backward writes all four candidates itself,
// zeros included, so every output element has exactly one writer (no
// memset, no scatter, no atomics) and is written once.  Every access of the
// backward is 16 bytes where C and the pointers allow it: on f32 a thread
// takes one crumb byte (4 channels, one float4 a candidate, C % 4 == 0);
// on bf16 and int16 two crumb bytes (8 channels, one 16-byte word a
// candidate, C % 8 == 0), selecting each element's 16 bits by a mask, so
// one kernel serves both types.  Elsewhere a thread takes one crumb byte
// with scalar accesses.  No shared memory.  The forward runs the B3 instance of
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

// One thread a crumb byte (4 channels), T float or, for a bf16 or int16
// element routed as its 16 bits, uint16_t: on f32 one float4 a candidate
// where C % 4 == 0 and g and out are 16-byte aligned (vec), else scalars.
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
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      const float4 a = reinterpret_cast<const float4*>(gp)[0];
      const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          o[q] = static_cast<int>((byte >> (2 * q)) & 3) == k ? v[q] : 0.f;
        reinterpret_cast<float4*>(cand[k])[0] = make_float4(o[0], o[1], o[2],
                                                            o[3]);
      }
      return;
    }
  }
  for (int q = 0; q < 4 && 4 * b + q < c; ++q) {
    const T v = gp[q];
    const int sel = (byte >> (2 * q)) & 3;
#pragma unroll
    for (int k = 0; k < 4; ++k) cand[k][q] = sel == k ? v : T(0);
  }
}

// The low (q = 0) or high (q = 1) half of a 32-bit word of two 2-byte
// elements, kept where crumb `sel` routes its channel to candidate k.
__device__ __forceinline__ uint32_t keep_half(uint32_t sel, int k, int q) {
  return static_cast<int>(sel & 3) == k ? 0xffffu << (16 * q) : 0u;
}

// 2-byte elements (bf16, int16: routed as their 16 bits, +0 elsewhere, so
// a -0.0 at the argmax keeps its sign): one thread two crumb bytes (8
// channels), one 16-byte load of g and one 16-byte store a candidate, C %
// 8 == 0 and g, out 16-byte aligned.  w8 counts 8-channel words a pixel.
__global__ void unpool_bwd16_vec_kernel(const uint8_t* __restrict__ idx,
                                        const uint4* __restrict__ g,
                                        uint4* __restrict__ out, int n,
                                        int hp, int wp, int w8) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * hp * wp * w8) return;
  const int b = t % w8, pix = t / w8;            // pix = (nn*hp + i)*wp + j
  const int j = pix % wp, i = (pix / wp) % hp, nn = pix / (wp * hp);
  const uint32_t sel = idx[2 * static_cast<size_t>(t)] |
                       static_cast<uint32_t>(idx[2 * static_cast<size_t>(t)
                                                 + 1]) << 8;
  const uint4 v = g[t];
  const size_t row = static_cast<size_t>(2 * wp) * w8;
  uint4* c00 = out + ((static_cast<size_t>(nn) * 2 * hp + 2 * i) * (2 * wp)
                      + 2 * j) * w8 + b;
  uint4* cand[4] = {c00, c00 + w8, c00 + row, c00 + row + w8};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint4 o;
    o.x = v.x & (keep_half(sel, k, 0) | keep_half(sel >> 2, k, 1));
    o.y = v.y & (keep_half(sel >> 4, k, 0) | keep_half(sel >> 6, k, 1));
    o.z = v.z & (keep_half(sel >> 8, k, 0) | keep_half(sel >> 10, k, 1));
    o.w = v.w & (keep_half(sel >> 12, k, 0) | keep_half(sel >> 14, k, 1));
    cand[k][0] = o;
  }
}

int unpool_bwd(const uint8_t* idx, const float* g, float* out, int n,
               int hp, int wp, int c, cudaStream_t stream) {
  const int cb = (c + 3) / 4;
  const int vec = (c % 4 == 0) && (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int total = n * hp * wp * cb, threads = 256;
  unpool_bwd_kernel<float>
      <<<(total + threads - 1) / threads, threads, 0, stream>>>(
          idx, g, out, n, hp, wp, c, cb, vec);
  return static_cast<int>(cudaGetLastError());
}

// g and out hold 2-byte elements (bf16 or int16).
int unpool_bwd16(const uint8_t* idx, const void* g, void* out, int n, int hp,
                 int wp, int c, cudaStream_t stream) {
  const int threads = 128;
  if (c % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const int w8 = c / 8, total = n * hp * wp * w8;
    unpool_bwd16_vec_kernel<<<(total + threads - 1) / threads, threads, 0,
                              stream>>>(idx, static_cast<const uint4*>(g),
                                        static_cast<uint4*>(out), n, hp, wp,
                                        w8);
  } else {
    const int cb = (c + 3) / 4, total = n * hp * wp * cb;
    unpool_bwd_kernel<uint16_t>
        <<<(total + threads - 1) / threads, threads, 0, stream>>>(
            idx, static_cast<const uint16_t*>(g),
            static_cast<uint16_t*>(out), n, hp, wp, c, cb, 0);
  }
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
  return unpool_bwd(idx, g, out, n, hp, wp, c, stream);
}

REPRO_API int repro_unpool_bwd_i16(const uint8_t* idx, const int16_t* g,
                                   int16_t* out, int n, int hp, int wp,
                                   int c, cudaStream_t stream) {
  return unpool_bwd16(idx, g, out, n, hp, wp, c, stream);
}

// The unpool of a bf16 gradient (the bf16 autograd paths): a scatter, so
// the bits are the plain version's (+0 at the three other candidates).
REPRO_API int repro_unpool_bwd_bf16(const uint8_t* idx,
                                    const __nv_bfloat16* g,
                                    __nv_bfloat16* out, int n, int hp,
                                    int wp, int c, cudaStream_t stream) {
  return unpool_bwd16(idx, g, out, n, hp, wp, c, stream);
}
