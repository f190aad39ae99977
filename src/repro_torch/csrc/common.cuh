// Shared by the kernels of repro_torch: the rectifier rules of the paper
// (Eq. 3-5), the packed-residual bit reads used by the fused backward
// kernels' prologues and epilogues, and, for the tiled convolutions
// (conv_fwd.cuh, conv_bwd.cuh) and the tiled FC backward (vmm_bwd.cuh),
// their cp.async copies and the element traits that let one template serve
// f32, bf16 and int16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Every C entry point: device pointers, sizes and a cudaStream_t in, the
// launch's cudaGetLastError() out.
#define REPRO_API extern "C" __attribute__((visibility("default")))

namespace repro {

// Images one conv forward launch covers: gridDim.z holds at most 65,535,
// and a multiple of 16 images keeps each chunk's base pointers as aligned
// as the whole batch's, so the copy widths and vector stores chosen for the
// batch stay legal (kernels/conv2d/conv2d.py CONV_BATCH_CHUNK mirrors it).
constexpr int kBatchChunk = 65520;

// Call launch(n0, nb) for the batch in chunks of nb <= kBatchChunk images
// from image n0, in order, and stop at the first error.  A batch of 0 makes
// one call with nb = 0.  Every image of a convolution is computed alone, so
// a chunked launch writes the bits of one launch over the whole batch.
template <typename F>
cudaError_t for_batch_chunks(int n, F&& launch) {
  int n0 = 0;
  do {
    const int nb = n - n0 < kBatchChunk ? n - n0 : kBatchChunk;
    const cudaError_t e = launch(n0, nb);
    if (e != cudaSuccess) return e;
    n0 += nb;
  } while (n0 < n);
  return cudaSuccess;
}

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

// The same rule on a bf16 gradient: it selects g or +0, never rounds, and
// compares g widened to f32 (exact), so -0.0 and NaN are not > 0, as
// jnp.where(g > 0, g, 0) has it.
__device__ __forceinline__ __nv_bfloat16 gate(__nv_bfloat16 g, bool bit,
                                              int method) {
  const __nv_bfloat16 zero = __ushort_as_bfloat16(0);
  const bool pos = __bfloat162float(g) > 0.f;
  if (method == kDeconvnet) return pos ? g : zero;
  if (method == kGuided) return (bit && pos) ? g : zero;
  return bit ? g : zero;
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

// Wait until at most N groups of this thread's cp.async copies are in
// flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One copy of `vb` bytes (16, 8 or 4) into a ring stage, or of one element
// with an ordinary load where vb == 0; ok == false writes zeros.
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, bool ok,
                                           int vb) {
  if (vb == 16) {
    cp_async<16>(dst, src, ok);
  } else if (vb == 8) {
    cp_async<8>(dst, src, ok);
  } else if (vb == 4) {
    cp_async<4>(dst, src, ok);
  } else {
    *dst = ok ? *src : T(0);
  }
}

// Call f(std::integral_constant<int, VB>{}) for the copy width vb (16, 8,
// 4, or 0 for ordinary loads), so a loop of copies inside f branches on
// the width at compile time, not once per copy.
template <typename F>
__device__ __forceinline__ void with_copy_bytes(int vb, F&& f) {
  switch (vb) {
    case 16: f(std::integral_constant<int, 16>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    default: f(std::integral_constant<int, 0>{}); break;
  }
}

// Bytes per copy of `count`-element rows staged `chunk` elements at a time
// from `p`: the widest of 16, 8, 4 whose element count divides both and
// whose alignment `p` has; 0 (ordinary loads) where none does.
template <typename T>
int copy_bytes(const void* p, int count, int chunk) {
  for (int vb = 16; vb >= 4; vb /= 2) {
    const int e = vb / static_cast<int>(sizeof(T));
    if (count % e == 0 && chunk % e == 0 &&
        reinterpret_cast<uintptr_t>(p) % vb == 0)
      return vb;
  }
  return 0;
}

// The element type of a tiled kernel: f32; bf16, whose operands are
// widened to f32 words and summed as f32 is; or int16, whose operands are
// widened to 32-bit words before the multiply-add (IMAD on uint32_t, so the
// sum wraps modulo 2^32 as the reference's int32 dot does) and whose
// accumulator is requantized to Q7.8 before the epilogue.
template <typename T>
struct Traits;

template <>
struct Traits<float> {
  using Word = float;  // compute-buffer element and accumulator
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float prologue(float g, bool bit,
                                                   int gate_in, int method) {
    return gate_in ? gate(g, bit, method) : g;
  }
  static __device__ __forceinline__ void weights4(const float* p,
                                                  float (&w)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
  static __device__ __forceinline__ void words4(const float* p,
                                                float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
  static __device__ __forceinline__ float mac(float acc, float x, float w) {
    return fmaf(x, w, acc);
  }
  static __device__ __forceinline__ float finish(float acc) { return acc; }
  static __device__ __forceinline__ float add_bias(float r, float b) {
    return r + b;
  }
  static __device__ __forceinline__ void store4(float* dst, const float* r) {
    *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
  }
};

template <>
struct Traits<int16_t> {
  using Word = uint32_t;
  // ld.shared.s16 sign-extends: the widening costs no instruction
  static __device__ __forceinline__ uint32_t widen(int16_t v) {
    return static_cast<uint32_t>(static_cast<int>(v));
  }
  static __device__ __forceinline__ uint32_t prologue(int16_t g, bool bit,
                                                      int gate_in,
                                                      int method) {
    int v = g;
    if (gate_in) v = gate(v, bit, method);
    return static_cast<uint32_t>(v);
  }
  static __device__ __forceinline__ void weights4(const int16_t* p,
                                                  uint32_t (&w)[4]) {
    const short4 v = *reinterpret_cast<const short4*>(p);
    w[0] = static_cast<uint32_t>(static_cast<int>(v.x));
    w[1] = static_cast<uint32_t>(static_cast<int>(v.y));
    w[2] = static_cast<uint32_t>(static_cast<int>(v.z));
    w[3] = static_cast<uint32_t>(static_cast<int>(v.w));
  }
  static __device__ __forceinline__ void words4(const uint32_t* p,
                                                uint32_t* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
  // |x * w| <= 2^30 as int32; the unsigned product is the same modulo 2^32
  static __device__ __forceinline__ uint32_t mac(uint32_t acc, uint32_t x,
                                                 uint32_t w) {
    return acc + x * w;
  }
  static __device__ __forceinline__ int finish(uint32_t acc) {
    return requantize(acc);
  }
  // the reference's sat_add of the Q7.8 bias, after the requantize
  static __device__ __forceinline__ int add_bias(int r, int16_t b) {
    return sat16(r + b);
  }
  static __device__ __forceinline__ void store4(int16_t* dst, const int* r) {
    *reinterpret_cast<short4*>(dst) =
        make_short4(static_cast<short>(r[0]), static_cast<short>(r[1]),
                    static_cast<short>(r[2]), static_cast<short>(r[3]));
  }
};

// bf16 to f32 is exact: the 16 bits become the high half of the word.
__device__ __forceinline__ float bf16_lo(uint32_t pair) {
  return __uint_as_float(pair << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

// Two f32 values rounded to nearest even, packed as two bf16 (a first).
__device__ __forceinline__ uint32_t bf16_pack(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
             << 16;
}

// bf16: operands widened to f32 exactly where they are read from shared
// memory, the f32 instance's chain of FFMA (the same order), and one
// rounding to nearest even where the result is stored.  finish keeps the
// f32 sum, so the backward's epilogue gate acts on it before the rounding,
// as the reference gates its f32 accumulator before .astype(bf16); the
// forward's bias is added after the rounding, bf16(f32(bf16(acc)) + f32(b)),
// as the reference computes conv2d_pallas(x, w) + b and vmm_pallas(x, w) + b
// with a bf16 kernel output.
template <>
struct Traits<__nv_bfloat16> {
  using Word = float;
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float prologue(__nv_bfloat16 g, bool bit,
                                                   int gate_in, int method) {
    const float v = __bfloat162float(g);
    return gate_in ? gate(v, bit, method) : v;
  }
  static __device__ __forceinline__ void weights4(const __nv_bfloat16* p,
                                                  float (&w)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = bf16_lo(v.x), w[1] = bf16_hi(v.x);
    w[2] = bf16_lo(v.y), w[3] = bf16_hi(v.y);
  }
  static __device__ __forceinline__ void words4(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
  static __device__ __forceinline__ float mac(float acc, float x, float w) {
    return fmaf(x, w, acc);
  }
  static __device__ __forceinline__ float finish(float acc) { return acc; }
  static __device__ __forceinline__ float add_bias(float r, __nv_bfloat16 b) {
    return __bfloat162float(__float2bfloat16_rn(r)) + __bfloat162float(b);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                                const float* r) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(bf16_pack(r[0], r[1]), bf16_pack(r[2], r[3]));
  }
};

// The cluster barrier in two halves: arrive (relaxed: it orders no memory;
// or release: this thread's earlier accesses, also to other blocks' shared
// memory, happen before the wait of any thread of the cluster returns) and
// wait (acquire), so the wait for the cluster's blocks to have started, or
// to have pushed their partials, overlaps other work.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Launch kernel<<<grid, block, smem, stream>>>(args...) with programmatic
// dependent launch: the grid may be scheduled while the kernel before it on
// the stream drains, and waits for that kernel's writes (griddepcontrol.wait
// in the kernel) before its first load.  cluster > 0 also groups the blocks
// into thread-block clusters of that many along x.
template <typename... Params, typename... Vals>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       size_t smem, cudaStream_t stream, int cluster,
                       Vals... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.numAttrs = 1;
  if (cluster > 0) {
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = cluster;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    cfg.numAttrs = 2;
  }
  cfg.attrs = attr;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace repro
