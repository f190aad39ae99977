// The bf16 tensor-core path of the forwards (B1 and B4 in bf16): Hopper's
// warp-level mma.sync.m16n8k16 on bf16 with f32 accumulation, its operand
// fragments loaded from shared memory by ldmatrix, and the launchers of the
// two kernels built on them (conv_fwd_mma.cu, vmm_fwd_bf16.cu), which the
// bf16 entry points (conv_fwd_bf16.cu, vmm.cu) call.
//
// Fragments of one m16n8k16 product, per lane of the warp (PTX ISA,
// "Matrix Fragments for mma.m16n8k16"): A (16 x 16, row-major) is 4 words
// of two bf16 each, B (16 x 8, k-major) 2 words, C/D (16 x 8 f32) 4 floats
// at rows lane/4 and lane/4 + 8, columns 2 * (lane % 4) and the next.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// d = a @ b + d on the tensor cores: bf16 products, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

}  // namespace repro
