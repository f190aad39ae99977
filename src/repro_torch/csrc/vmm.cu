// FC matmul, forward and fused backward (paper §III.C, §III.E, Fig. 4).
//
// Replaces: src/repro/kernels/vmm/vmm.py, vmm_pallas (repro_vmm_fwd) and
// vmm_bwd_fused_pallas (repro_vmm_bwd_fused).
//
//   forward:  y[M, N] = x[M, K] @ w[K, N] (+ b[N] in the epilogue)
//   backward: out[s] = gate_out(gate_in(g[s]) @ wt),  g [S, M, K],
//             wt [K, N] = W^T made contiguous once by the caller; the 1-bit
//             masks [M, ceil(K/8)] and [M, ceil(N/8)] have no seeds axis.
//
// Bound on an H100: near the ridge of f32 CUDA cores against HBM
// (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte).  The forward [32, 4096] @
// [4096, 128] moves the 2 MB weight once for 33.5 MFLOP (16 FLOP/byte:
// bytes); the backward at S=3 seeds, [96, 128] @ [128, 4096], does 100
// MFLOP on 3.6 MB (28 FLOP/byte: operations).  Design: a plain
// 16x16 shared-memory SGEMM, f32 FMA on the CUDA cores, no tensor cores (no
// TF32) and no atomics, so every output is one deterministic sum.  The
// backward's gate is applied to the g tile as it is staged into shared
// memory (the gated gradient never goes to device memory) and the seeds
// are the grid's z axis, all reading the same mask bytes.  Known limit: at
// M=32, N=128 the forward has only 16 blocks for K=4096, so it runs far
// from the byte bound; a split-K second pass is the next step.

#include "common.cuh"

namespace {

constexpr int T = 16;

__global__ void __launch_bounds__(T * T)
vmm_kernel(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ bias, const uint8_t* __restrict__ mask,
           const uint8_t* __restrict__ omask, float* __restrict__ out, int m,
           int k, int n, int gate_in, int gate_out, int method) {
  __shared__ float as[T][T + 1];
  __shared__ float bs[T][T + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * T + ty, col = blockIdx.x * T + tx;
  a += static_cast<size_t>(blockIdx.z) * m * k;
  out += static_cast<size_t>(blockIdx.z) * m * n;
  const uint8_t* mrow =
      mask ? mask + static_cast<size_t>(row) * ((k + 7) / 8) : nullptr;
  float acc = 0.f;
  for (int k0 = 0; k0 < k; k0 += T) {
    const int ka = k0 + tx;
    float v = 0.f;
    if (row < m && ka < k) {
      v = a[static_cast<size_t>(row) * k + ka];
      if (gate_in) v = repro::gate(v, repro::mask_bit(mrow, ka), method);
    }
    as[ty][tx] = v;
    const int kb = k0 + ty;
    bs[ty][tx] = (kb < k && col < n) ? b[static_cast<size_t>(kb) * n + col]
                                     : 0.f;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < T; ++q) acc = fmaf(as[ty][q], bs[q][tx], acc);
    __syncthreads();
  }
  if (row < m && col < n) {
    float o = acc;
    if (bias) o += bias[col];
    if (gate_out) {
      const uint8_t* orow =
          omask ? omask + static_cast<size_t>(row) * ((n + 7) / 8) : nullptr;
      o = repro::gate(o, repro::mask_bit(orow, col), method);
    }
    out[static_cast<size_t>(row) * n + col] = o;
  }
}

}  // namespace

REPRO_API int repro_vmm_fwd(const float* x, const float* w, const float* bias,
                            float* y, int m, int k, int n,
                            cudaStream_t stream) {
  const dim3 grid((n + T - 1) / T, (m + T - 1) / T, 1), block(T, T);
  vmm_kernel<<<grid, block, 0, stream>>>(x, w, bias, nullptr, nullptr, y, m,
                                         k, n, 0, 0, repro::kSaliency);
  return static_cast<int>(cudaGetLastError());
}

REPRO_API int repro_vmm_bwd_fused(const float* g, const float* wt,
                                  const uint8_t* mask, const uint8_t* omask,
                                  float* out, int s, int m, int k, int n,
                                  int gate_in, int gate_out, int method,
                                  cudaStream_t stream) {
  const dim3 grid((n + T - 1) / T, (m + T - 1) / T, s), block(T, T);
  vmm_kernel<<<grid, block, 0, stream>>>(g, wt, nullptr, mask, omask, out, m,
                                         k, n, gate_in, gate_out, method);
  return static_cast<int>(cudaGetLastError());
}
