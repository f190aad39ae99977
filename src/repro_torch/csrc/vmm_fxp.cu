// True-int16 FC matmul, forward and fused backward (paper §IV: the 16-bit
// fixed-point datapath).
//
// Replaces: src/repro/kernels/vmm/fxp.py, vmm_fxp_pallas (repro_vmm_fxp_fwd)
// and vmm_bwd_fused_fxp_pallas (repro_vmm_bwd_fused_fxp).
//
//   forward:  y[M, N] = sat_add(requantize(x[M, K] @ w[K, N]), b[N])
//   backward: out[s] = gate_out(requantize(gate_in(g[s]) @ wt)),
//             g [S, M, K], wt [K, N] = W^T made contiguous once by the
//             caller; the 1-bit masks [M, ceil(K/8)] and [M, ceil(N/8)]
//             have no seeds axis.
//
// Operands are int16 (Q7.8 activations and gradients, Q1.14 weights);
// products accumulate in a uint32_t so the sum wraps modulo 2^32 as the
// reference's int32 dot does (4096 products of up to 2^30 can pass 2^31 in
// FC0).  One requantize narrows the accumulator; the bias is added with
// saturation after it (forward), the epilogue gate runs after it
// (backward, fxp.py:106-112).
//
// Bound on an H100: integer multiply-adds, IMAD on the CUDA cores (Hopper
// has no int16 tensor-core MMA; 64 per SM per clock, about 16.7 T/s at
// 132 SMs and 1.98 GHz).  The forward [32, 4096] @ [4096, 128] does 16.8 M
// of them on 1.3 MB, about 1.0 us against 0.4 us of HBM traffic; the
// backward at S=3 seeds, [96, 128] @ [128, 4096], up to 50 M on 1.8 MB.
// Design: the 16x16 shared-memory tile of the f32 kernel (vmm.cu) with
// int16 tiles and 32-bit accumulators; the gate is applied to the g tile
// as it is staged (the gated gradient never goes to device memory) and the
// seeds are the grid's z axis, all reading the same mask bytes.  No
// atomics: every output is one deterministic sum.

#include "common.cuh"

namespace {

constexpr int T = 16;

__global__ void __launch_bounds__(T * T)
vmm_fxp_kernel(const int16_t* __restrict__ a, const int16_t* __restrict__ b,
               const int16_t* __restrict__ bias,
               const uint8_t* __restrict__ mask,
               const uint8_t* __restrict__ omask, int16_t* __restrict__ out,
               int m, int k, int n, int gate_in, int gate_out, int method) {
  __shared__ int16_t as[T][T + 2];
  __shared__ int16_t bs[T][T + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * T + ty, col = blockIdx.x * T + tx;
  a += static_cast<size_t>(blockIdx.z) * m * k;
  out += static_cast<size_t>(blockIdx.z) * m * n;
  const uint8_t* mrow =
      mask ? mask + static_cast<size_t>(row) * ((k + 7) / 8) : nullptr;
  uint32_t acc = 0u;
  for (int k0 = 0; k0 < k; k0 += T) {
    const int ka = k0 + tx;
    int v = 0;
    if (row < m && ka < k) {
      v = a[static_cast<size_t>(row) * k + ka];
      if (gate_in) v = repro::gate(v, repro::mask_bit(mrow, ka), method);
    }
    as[ty][tx] = static_cast<int16_t>(v);
    const int kb = k0 + ty;
    bs[ty][tx] = (kb < k && col < n) ? b[static_cast<size_t>(kb) * n + col]
                                     : int16_t(0);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < T; ++q) {
      // |a * b| <= 2^30: the product fits; the sum wraps.
      acc += static_cast<uint32_t>(static_cast<int>(as[ty][q]) *
                                   static_cast<int>(bs[q][tx]));
    }
    __syncthreads();
  }
  if (row < m && col < n) {
    int o = repro::requantize(acc);
    if (bias) o = repro::sat16(o + bias[col]);
    if (gate_out) {
      const uint8_t* orow =
          omask ? omask + static_cast<size_t>(row) * ((n + 7) / 8) : nullptr;
      o = repro::gate(o, repro::mask_bit(orow, col), method);
    }
    out[static_cast<size_t>(row) * n + col] = static_cast<int16_t>(o);
  }
}

}  // namespace

REPRO_API int repro_vmm_fxp_fwd(const int16_t* x, const int16_t* w,
                                const int16_t* bias, int16_t* y, int m, int k,
                                int n, cudaStream_t stream) {
  const dim3 grid((n + T - 1) / T, (m + T - 1) / T, 1), block(T, T);
  vmm_fxp_kernel<<<grid, block, 0, stream>>>(x, w, bias, nullptr, nullptr, y,
                                             m, k, n, 0, 0, repro::kSaliency);
  return static_cast<int>(cudaGetLastError());
}

REPRO_API int repro_vmm_bwd_fused_fxp(const int16_t* g, const int16_t* wt,
                                      const uint8_t* mask,
                                      const uint8_t* omask, int16_t* out,
                                      int s, int m, int k, int n, int gate_in,
                                      int gate_out, int method,
                                      cudaStream_t stream) {
  const dim3 grid((n + T - 1) / T, (m + T - 1) / T, s), block(T, T);
  vmm_fxp_kernel<<<grid, block, 0, stream>>>(g, wt, nullptr, mask, omask, out,
                                             m, k, n, gate_in, gate_out,
                                             method);
  return static_cast<int>(cudaGetLastError());
}
