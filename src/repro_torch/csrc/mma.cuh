// The bf16 tensor-core path (B1, B4, B5 and B6 in bf16): Hopper's
// warp-level mma.sync.m16n8k16 on bf16 with f32 accumulation, its operand
// fragments loaded from shared memory by ldmatrix, the backward's gate on
// eight staged bf16 values, and the launchers of the four kernels built on
// them (conv_fwd_mma.cu, vmm_fwd_bf16.cu, conv_bwd_mma.cu, vmm_bwd_bf16.cu),
// which the bf16 entry points (conv_fwd_bf16.cu, vmm.cu, conv_bwd_bf16.cu)
// call.
//
// Fragments of one m16n8k16 product, per lane of the warp (PTX ISA,
// "Matrix Fragments for mma.m16n8k16"): A (16 x 16, row-major) is 4 words
// of two bf16 each, B (16 x 8, k-major) 2 words, C/D (16 x 8 f32) 4 floats
// at rows lane/4 and lane/4 + 8, columns 2 * (lane % 4) and the next.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8j..8j+7 give the
// 16-byte rows of matrix j, r[j] is this lane's word of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: rows of a [k][n] tile become the
// k-major B fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8 x 8 bf16 matrices, transposed: lanes 0-15 give the rows (k 0-7,
// then 8-15) of one n8 column of a [k][n] tile, the k-major B fragment of
// one n8 tile (lanes 16-31's addresses are not read).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d = a @ b + d on the tensor cores: bf16 products, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x / d for 0 <= x < 2^31 by a multiply-high, an add and a shift, d fixed
// for a launch (the magic is computed on the host): the tensor-core
// backwards' copy and prologue loops index their work by runtime
// divisors, and an integer division costs some twenty instructions.
struct FastDiv {
  uint32_t m = 1;
  int l = 0;
  FastDiv() = default;
  explicit FastDiv(uint32_t d) {
    while ((1ull << l) < d) ++l;
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int x) const {
    const uint32_t u = static_cast<uint32_t>(x);
    return static_cast<int>((__umulhi(u, m) + u) >> l);
  }
};

// The backward's unpool and Eq. 3-5 gate on eight consecutive channels of
// one staged position, as bits: element j keeps its bf16 value where bit j
// of `keep` is set (the unpool routes the gradient here, and, for the
// saliency and guided rules, the mask bit is set) and, for the deconvnet
// and guided rules (`positive`), the value is above 0; every other element
// becomes +0.  A bf16 value is above 0 as f32 exactly where its bits, as a
// signed 16-bit integer, lie in (0, 0x7f81): positive, not zero, not NaN.
// So a kept value is the stored one, -0.0 included, as the FFMA instances
// keep it.
__device__ __forceinline__ uint4 gate8(uint4 v, unsigned keep,
                                       bool positive) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // the two elements' keep bits, spread over their 16-bit halves
    uint32_t m = ((keep >> (2 * i)) & 1) * 0xffffu |
                 ((keep >> (2 * i + 1)) & 1) * 0xffff0000u;
    if (positive)
      m &= __vcmpgts2(w[i], 0u) & __vcmpgts2(0x7f817f81u, w[i]);
    w[i] &= m;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The tensor-core conv forward (conv_fwd_mma.cu) for the plan (th, mt,
// tco, cin_t) of kernels/conv2d/conv2d.py ConvMmaPlan; Cin a multiple of
// 16, K in {1, 3, 5, 7}.
cudaError_t conv_fwd_mma_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                              const __nv_bfloat16* bias, __nv_bfloat16* y,
                              int n, int h, int wd, int cin, int cout, int k,
                              int th, int mt, int tco, int cin_t,
                              cudaStream_t stream);

// The tensor-core FC forward (vmm_fwd_bf16.cu): bn columns a block, K cut
// into `cluster` slices of ks, one a block of a thread-block cluster
// (kernels/vmm/vmm.py VmmMmaPlan).
cudaError_t vmm_fwd_mma_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                             const __nv_bfloat16* bias, __nv_bfloat16* y,
                             int m, int k, int n, int cluster, int ks, int bn,
                             cudaStream_t stream);

// The tensor-core fused conv backward (conv_bwd_mma.cu) for the plan (th,
// mt, tco, cin_t, sg, st) of kernels/conv2d/conv2d.py ConvBwdMmaPlan; C a
// multiple of 16, K in {1, 3, 5, 7}.
cudaError_t conv_bwd_mma_bf16(const __nv_bfloat16* g, const __nv_bfloat16* wt,
                              const uint8_t* pool_idx, const uint8_t* mask,
                              const uint8_t* omask, __nv_bfloat16* out, int s,
                              int n, int h, int wd, int c, int cout, int k,
                              int gate_in, int gate_out, int method, int th,
                              int mt, int tco, int cin_t, int sg, int st,
                              cudaStream_t stream);

// The tensor-core fused FC backward (vmm_bwd_bf16.cu) for the plan (br, bn,
// kc, mf, nt) of kernels/vmm/vmm.py VmmBwdMmaPlan.
cudaError_t vmm_bwd_mma_bf16(const __nv_bfloat16* g, const __nv_bfloat16* wt,
                             const uint8_t* mask, const uint8_t* omask,
                             __nv_bfloat16* out, int s, int m, int k, int n,
                             int gate_in, int gate_out, int method, int br,
                             int bn, int kc, int mf, int nt,
                             cudaStream_t stream);

}  // namespace repro
