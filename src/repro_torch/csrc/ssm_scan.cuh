// The arithmetic of one step of the mamba-1 selective scan (B13), shared by
// the forward (ssm_scan.cu) and the backward (ssm_scan_bwd.cu), so that the
// backward's recomputed states are the forward's bit for bit.
//
// Lane layout of both kernels: a channel (b, d) is kLanes consecutive
// lanes of a warp, lane q of the group holding states n = kSpl*q .. kSpl*q
// + kSpl-1 (those below N).  The grouping is a constant of the kernels, not
// a launch knob, so every knob gives the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {
namespace scan {

constexpr int kMaxN = 16;            // states of a channel
constexpr int kLanes = 4;            // lanes of a channel
constexpr int kSpl = kMaxN / kLanes;  // states of a lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The decay rate a kernel keeps for A[d,n]: A * log2(e), so that
// abar = exp(dt * A) = 2^(dt * rate) is one product and one ex2.approx
// (MUFU.EX2, relative error about 2^-22) in place of precise expf's ten
// instructions.  Forward and backward evaluate the same operations, so
// the backward's recomputed states are the forward's bits.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float decay_rate(float av) {
  return __fmul_rn(av, kLog2e);
}

__device__ __forceinline__ float decay(float dtv, float rate) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fmul_rn(dtv, rate)));
  return r;
}

// h = abar * h + (dt * x) * B, one fused multiply-add after the product.
__device__ __forceinline__ float update(float abar, float h, float dtx,
                                        float bv) {
  return __fmaf_rn(abar, h, __fmul_rn(dtx, bv));
}

// Sum of one value over the kLanes lanes of a channel, in a fixed tree:
// (v0 + v1) + (v2 + v3) on every lane of the group (addition commutes, so
// each lane ends with the same bits).
__device__ __forceinline__ float group_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(kFull, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(kFull, v, 2));
}

}  // namespace scan
}  // namespace repro
