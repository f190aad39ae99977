// ReLU + 1-bit mask (B2), 2x2/2 max pool + 2-bit argmax (B3), and the two
// fused into one pass at the pooled layers, on f32, on the bf16 maps of the
// bf16 path and on the int16 (Q7.8) feature maps of the fxp16 path: one
// template for the card.  Compares and selects only, so every element type
// is exact (bf16 compares as bf16: -0.0 is not > 0, NaN is not > anything).
//
// Replaces: src/repro/kernels/relu_mask/relu_mask.py, relu_fwd_pallas, and
// src/repro/kernels/pool/pool.py, maxpool_fwd_pallas (int16: pinned by
// src/repro/kernels/pool/fxp.py, maxpool_fwd_fxp); the fused instance is
// maxpool_fwd_pallas(relu_fwd_pallas(x)) of the JAX package's pooled conv
// blocks (src/repro/models/cnn.py, _conv_block_fwd_res) in one launch.
//
// relu_pool_fwd_kernel<T, POOL, RELU, MASK> over NHWC x:
//   B2             <T, false, true,  true>   [R, C] as 1x1 windows
//   B3             <T, true,  false, false>
//   fused          <T, true,  true,  true>
//   fused, no mask <T, true,  true,  false>  (deconvnet: Table II)
// RELU maps every candidate v to v > 0 ? v : 0 (+0 for -0 and NaN, as
// relu_mask.cu's general kernel does); MASK writes bit j of byte b of each
// candidate pixel = x[.., 8b + j] > 0, LSB first, [.., ceil(C/8)], bits past
// C 0; POOL writes the window's maximum and its crumb, channel 4b + j =
// crumb j of byte b, [.., ceil(C/4)]: the candidates (0,0), (0,1), (1,0),
// (1,1) in that order, a later one replacing the best only when strictly
// greater (the first maximum wins, as jnp.argmax; an all-negative window
// is all zeros after the ReLU, so its crumb is 0).  Every output is
// bitwise pool/ref.maxpool_fwd(relu_mask/ref.relu_fwd(x)).
//
// Bound on an H100: bytes.  No reuse, a few compares an element.  The
// fused pass reads x once and writes y, the mask and the crumbs, where B2
// then B3 write the ReLU'd map and read it back.  Design: one thread takes
// one output pixel x 8 channels.  When C % 8 == 0 and the pointers are 16-
// byte aligned it issues every candidate's 16-byte loads before the first
// compare (8 LDG.128 in flight a thread in f32, 4 in int16), stores the 8
// results as 16-byte vectors, the two crumb bytes of its 8 channels as one
// 16-bit store, and one mask byte per candidate pixel (neighbouring
// threads, neighbouring bytes).  Ragged C or misaligned views take a
// scalar path.  No shared memory: the input is warm in L2 behind the conv
// that wrote it.  The block size is the caller's (relu_pool_threads).

#pragma once

#include "common.cuh"

namespace {

// Eight consecutive elements as one or two 16-byte vectors.
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  __device__ static void load(const float* p, float v[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ static void store(float* p, const float v[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Vec8<int16_t> {
  union U {
    int4 q;
    int16_t h[8];
  };
  __device__ static void load(const int16_t* p, int16_t v[8]) {
    U u;
    u.q = reinterpret_cast<const int4*>(p)[0];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = u.h[j];
  }
  __device__ static void store(int16_t* p, const int16_t v[8]) {
    U u;
#pragma unroll
    for (int j = 0; j < 8; ++j) u.h[j] = v[j];
    reinterpret_cast<int4*>(p)[0] = u.q;
  }
};

template <>
struct Vec8<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, __nv_bfloat16 v[8]) {
    const uint4 q = reinterpret_cast<const uint4*>(p)[0];
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __ushort_as_bfloat16(static_cast<unsigned short>(u[j]));
      v[2 * j + 1] =
          __ushort_as_bfloat16(static_cast<unsigned short>(u[j] >> 16));
    }
  }
  __device__ static void store(__nv_bfloat16* p, const __nv_bfloat16 v[8]) {
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      u[j] = static_cast<uint32_t>(__bfloat16_as_ushort(v[2 * j])) |
             static_cast<uint32_t>(__bfloat16_as_ushort(v[2 * j + 1])) << 16;
    reinterpret_cast<uint4*>(p)[0] = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

namespace rp {

constexpr int kMaxThreads = 512;   // RELU_POOL_THREADS' largest

template <typename T, bool POOL, bool RELU, bool MASK>
__global__ void __launch_bounds__(kMaxThreads)
relu_pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                     uint8_t* __restrict__ m, uint8_t* __restrict__ idx,
                     int pixels, int h, int w, int c, int groups, int vec) {
  // launched with programmatic stream serialization, the grid may start
  // while the kernel before it drains: wait for its writes before a load
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pixels * groups) return;
  const int g = t % groups, pix = t / groups;
  constexpr int NC = POOL ? 4 : 1;           // candidates a window
  size_t in[NC];                             // their input pixels
  if constexpr (POOL) {
    const int wo = w >> 1, ho = h >> 1;
    const int j = pix % wo, r = pix / wo;
    const int i = r % ho, nn = r / ho;
    const size_t p00 = (static_cast<size_t>(nn) * h + 2 * i) * w + 2 * j;
    in[0] = p00;
    in[1] = p00 + 1;
    in[2] = p00 + w;
    in[3] = p00 + w + 1;
  } else {
    in[0] = pix;
  }
  const int c0 = 8 * g;
  const T zero = T(0);
  T v[NC][8];
  if (vec) {
#pragma unroll
    for (int k = 0; k < NC; ++k) Vec8<T>::load(x + in[k] * c + c0, v[k]);
  } else {
    const int cnt = min(8, c - c0);
#pragma unroll
    for (int k = 0; k < NC; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[k][j] = j < cnt ? x[in[k] * c + c0 + j] : zero;
  }
  uint32_t bits[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    bits[k] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const T a = v[k][j];
      if constexpr (MASK) bits[k] |= static_cast<uint32_t>(a > zero) << j;
      if constexpr (RELU) v[k][j] = a > zero ? a : zero;
    }
  }
  T best[8];
  uint32_t crumbs = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    best[j] = v[0][j];
    uint32_t arg = 0;
#pragma unroll
    for (int k = 1; k < NC; ++k) {
      if (v[k][j] > best[j]) {               // strict: the first max wins
        best[j] = v[k][j];
        arg = k;
      }
    }
    crumbs |= arg << (2 * j);
  }
  if constexpr (MASK) {
#pragma unroll
    for (int k = 0; k < NC; ++k)
      m[in[k] * groups + g] = static_cast<uint8_t>(bits[k]);
  }
  T* yp = y + static_cast<size_t>(pix) * c + c0;
  if (vec) {
    Vec8<T>::store(yp, best);
  } else {
    const int cnt = min(8, c - c0);
    for (int j = 0; j < cnt; ++j) yp[j] = best[j];
  }
  if constexpr (POOL) {
    const int cq = (c + 3) / 4;
    uint8_t* ip = idx + static_cast<size_t>(pix) * cq + 2 * g;
    if (vec) {                                 // cq even, ip 2-byte aligned
      *reinterpret_cast<uint16_t*>(ip) = static_cast<uint16_t>(crumbs);
    } else {
      ip[0] = static_cast<uint8_t>(crumbs);
      if (2 * g + 1 < cq) ip[1] = static_cast<uint8_t>(crumbs >> 8);
    }
  }
}

// One launch of an instance over `pixels` output pixels (rows for B2;
// N*H/2*W/2 windows of an [N, H, W, C] map for the pooled instances), in
// blocks of `threads`, with programmatic dependent launch.
template <typename T, bool POOL, bool RELU, bool MASK>
int launch(const T* x, T* y, uint8_t* m, uint8_t* idx, int pixels, int h,
           int w, int c, int threads, cudaStream_t stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (c + 7) / 8;
  const int vec = (c % 8 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(idx) % 2 == 0);
  const long long total = static_cast<long long>(pixels) * groups;
  return static_cast<int>(repro::launch_pdl(
      relu_pool_fwd_kernel<T, POOL, RELU, MASK>,
      dim3(static_cast<unsigned>((total + threads - 1) / threads)),
      dim3(threads), 0, stream, 0, x, y, m, idx, pixels, h, w, c, groups,
      vec));
}

}  // namespace rp
}  // namespace
