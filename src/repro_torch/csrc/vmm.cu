// FC matmul, forward and fused backward (paper §III.C, §III.E, Fig. 4).
//
// Replaces: src/repro/kernels/vmm/vmm.py, vmm_pallas (repro_vmm_fwd; bf16:
// repro_vmm_fwd_bf16) and vmm_bwd_fused_pallas (repro_vmm_bwd_fused, the
// template of vmm_bwd.cuh; bf16: repro_vmm_bwd_fused_bf16, the tensor-core
// kernel of vmm_bwd_bf16.cu).
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
// MFLOP on 3.6 MB (28 FLOP/byte: operations).  f32 FMA on the CUDA cores
// both ways, no tensor cores (no TF32) and no float atomics, so every
// output is one deterministic sum.
//
// Forward design: split-K.  A block owns a 32 x 32 output tile and one
// slice of K (a multiple of 32 long; the caller picks the number of
// slices and their length, kernels/vmm/vmm.py vmm_splits and vmm_slice):
// at FC0 64 slices x 4 column tiles = 256 blocks, so the 2 MB weight
// streams through every SM instead of 16.  Each 32-deep chunk of the
// slice is staged in shared memory, the weight rows as 16-byte vectors
// (each weight byte is read once in all), the x rows likewise; each of
// the 128 threads keeps a 2-row x 4-column register tile and reads 4
// weights as one float4 and its 2 x values as broadcasts, 8 FMAs per 3
// shared loads, summing its K in order.  The next
// chunk is loaded into registers while the current one is summed.  With
// one slice the block adds the bias and writes y.  With more it writes its
// partial tile to a workspace [splits, M, N] (torch.empty in the wrapper),
// and a second kernel launched by the same entry point,
// vmm_splitk_sum_kernel, sums the slices in slice order and adds the
// bias, so the result is bitwise the same from run to run.
//
// bf16: repro_vmm_fwd_bf16 runs the tensor-core kernel of vmm_fwd_bf16.cu
// (one launch, split-K reduced inside a thread-block cluster, no
// workspace) for the plans kernels/vmm/vmm.py vmm_mma_plan gives.  It
// rounds the sum to bf16, then adds the bias in f32 and rounds again,
// bf16(f32(bf16(acc)) + f32(b)): the reference's vmm_pallas(x, w) + b,
// whose kernel output is bf16.

// Backward design: the tiled template of vmm_bwd.cuh
// (vmm_bwd_tiled_kernel<float, RM>, shared with the int16 backward): the
// seeds folded into rows, a cp.async ring of K chunks gated once into a
// transposed compute buffer, an RM x 4 register tile a thread, tiled by
// kernels/vmm/vmm.py vmm_bwd_plan.  The plan of zeros runs the general
// kernel, vmm_kernel (the forward's before the split-K redesign, and the
// backward's until the tiled one): a plain 16x16 shared-memory SGEMM, the
// gate applied to the g tile as it is staged and the seeds the grid's z
// axis.  Both sum each output over k ascending with fmaf, so the tiled
// kernel equals vmm_kernel bit for bit; vmm_kernel stays as its bitwise
// reference.

#include "common.cuh"
#include "mma.cuh"
#include "vmm_bwd.cuh"

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

// Split-K forward: tile, chunk and block shape.  kernels/vmm/vmm.py
// mirrors SK_BM, SK_BN and SK_KC to choose the split.
constexpr int SK_BM = 32, SK_BN = 32, SK_KC = 32, SK_THREADS = 128;
constexpr int SK_XS = SK_KC + 4;  // x row stride: 16-byte rows, no conflict

// One block: output rows [m0, m0 + 32) x columns [n0, n0 + 32) over the K
// slice [kb, ke).  part == nullptr: write y (+ bias); else write the
// partial tile to part[blockIdx.z].
__global__ void __launch_bounds__(SK_THREADS)
vmm_splitk_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y,
                  float* __restrict__ part, int m, int k, int n, int ks,
                  int vec_x, int vec_w) {
  __shared__ __align__(16) float xs[SK_BM * SK_XS];
  __shared__ __align__(16) float ws[SK_KC * SK_BN];
  const int tid = threadIdx.x, tc = tid % (SK_BN / 4), tr = tid / (SK_BN / 4);
  const int n0 = blockIdx.x * SK_BN, m0 = blockIdx.y * SK_BM;
  const int kb = blockIdx.z * ks, ke = min(k, kb + ks);

  // This thread's share of one chunk: 2 float4 of w, 2 of x.
  constexpr int WV = SK_KC * SK_BN / 4 / SK_THREADS;   // 2
  constexpr int XV = SK_BM * SK_KC / 4 / SK_THREADS;   // 2
  float4 wr[WV], xr[XV];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int e = tid + i * SK_THREADS;
      const int kk = k0 + e / (SK_BN / 4), c = n0 + 4 * (e % (SK_BN / 4));
      const float* src = w + static_cast<size_t>(kk) * n + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kk < ke) {
        if (vec_w && c < n) {
          v = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (c < n) v.x = __ldg(src);
          if (c + 1 < n) v.y = __ldg(src + 1);
          if (c + 2 < n) v.z = __ldg(src + 2);
          if (c + 3 < n) v.w = __ldg(src + 3);
        }
      }
      wr[i] = v;
    }
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int e = tid + i * SK_THREADS;
      const int r = m0 + e / (SK_KC / 4), kk = k0 + 4 * (e % (SK_KC / 4));
      const float* src = x + static_cast<size_t>(r) * k + kk;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < m) {
        if (vec_x && kk < ke) {   // vec_x: K % 4 == 0, so kk + 3 < ke
          v = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (kk < ke) v.x = __ldg(src);
          if (kk + 1 < ke) v.y = __ldg(src + 1);
          if (kk + 2 < ke) v.z = __ldg(src + 2);
          if (kk + 3 < ke) v.w = __ldg(src + 3);
        }
      }
      xr[i] = v;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int e = tid + i * SK_THREADS;
      reinterpret_cast<float4*>(ws)[e] = wr[i];
    }
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int e = tid + i * SK_THREADS;
      *reinterpret_cast<float4*>(
          &xs[(e / (SK_KC / 4)) * SK_XS + 4 * (e % (SK_KC / 4))]) = xr[i];
    }
  };

  float acc[2][4] = {};
  if (kb < ke) fetch(kb);
  for (int k0 = kb; k0 < ke; k0 += SK_KC) {
    stash();
    __syncthreads();
    if (k0 + SK_KC < ke) fetch(k0 + SK_KC);   // in flight while we sum
#pragma unroll
    for (int kk = 0; kk < SK_KC; ++kk) {
      const float4 b4 = reinterpret_cast<const float4*>(ws)[kk * (SK_BN / 4)
                                                            + tc];
      const float a0 = xs[(2 * tr) * SK_XS + kk];
      const float a1 = xs[(2 * tr + 1) * SK_XS + kk];
      acc[0][0] = fmaf(a0, b4.x, acc[0][0]);
      acc[0][1] = fmaf(a0, b4.y, acc[0][1]);
      acc[0][2] = fmaf(a0, b4.z, acc[0][2]);
      acc[0][3] = fmaf(a0, b4.w, acc[0][3]);
      acc[1][0] = fmaf(a1, b4.x, acc[1][0]);
      acc[1][1] = fmaf(a1, b4.y, acc[1][1]);
      acc[1][2] = fmaf(a1, b4.z, acc[1][2]);
      acc[1][3] = fmaf(a1, b4.w, acc[1][3]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + 2 * tr + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tc + j;
      if (c >= n) continue;
      if (part) {
        part[(static_cast<size_t>(blockIdx.z) * m + r) * n + c] = acc[i][j];
      } else {
        float o = acc[i][j];
        if (bias) o += bias[c];
        y[static_cast<size_t>(r) * n + c] = o;
      }
    }
  }
}

// Second pass of the split-K forward: y = sum of the slices in slice order
// (+ bias), one thread per output.
__global__ void vmm_splitk_sum_kernel(const float* __restrict__ part,
                                      const float* __restrict__ bias,
                                      float* __restrict__ y, int m, int n,
                                      int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * n) return;
  const size_t mn = static_cast<size_t>(m) * n;
  float s = part[i];
#pragma unroll 8
  for (int z = 1; z < splits; ++z) s += part[z * mn + i];
  if (bias) s += bias[i % n];
  y[i] = s;
}

}  // namespace

REPRO_API int repro_vmm_fwd(const float* x, const float* w, const float* bias,
                            float* y, int m, int k, int n, float* part,
                            int splits, int ks, cudaStream_t stream) {
  // splits slices of K, each ks long (a whole number of chunks), none
  // empty: kernels/vmm/vmm.py vmm_with_splits chooses both.
  if (splits < 1 || ks < SK_KC || ks % SK_KC != 0 ||
      static_cast<long long>(splits) * ks < k ||
      (splits > 1 && (part == nullptr || (splits - 1) * ks >= k)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_x = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((n + SK_BN - 1) / SK_BN, (m + SK_BM - 1) / SK_BM, splits);
  vmm_splitk_kernel<<<grid, SK_THREADS, 0, stream>>>(
      x, w, bias, y, splits > 1 ? part : nullptr, m, k, n, ks, vec_x, vec_w);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int threads = 256, blocks = (m * n + threads - 1) / threads;
    vmm_splitk_sum_kernel<<<blocks, threads, 0, stream>>>(part, bias, y, m, n,
                                                          splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 operands and output: the tensor-core kernel of vmm_fwd_bf16.cu, bn
// columns a block, K in `cluster` slices of ks, one a block of a
// thread-block cluster; no workspace.
REPRO_API int repro_vmm_fwd_bf16(const __nv_bfloat16* x,
                                 const __nv_bfloat16* w,
                                 const __nv_bfloat16* bias, __nv_bfloat16* y,
                                 int m, int k, int n, int cluster, int ks,
                                 int bn, cudaStream_t stream) {
  return static_cast<int>(repro::vmm_fwd_mma_bf16(x, w, bias, y, m, k, n,
                                                  cluster, ks, bn, stream));
}

REPRO_API int repro_vmm_bwd_fused(const float* g, const float* wt,
                                  const uint8_t* mask, const uint8_t* omask,
                                  float* out, int s, int m, int k, int n,
                                  int gate_in, int gate_out, int method,
                                  int br, int bn, int kc, int rm,
                                  cudaStream_t stream) {
  // the plan (br, bn, kc, rm) of kernels/vmm/vmm.py vmm_bwd_plan; all 0:
  // the general kernel
  if (br != 0 || bn != 0 || kc != 0 || rm != 0)
    return static_cast<int>(vbwd::launch_tiled<float>(
        g, wt, mask, omask, out, s, m, k, n, gate_in, gate_out, method, br,
        bn, kc, rm, stream));
  const dim3 grid((n + T - 1) / T, (m + T - 1) / T, s), block(T, T);
  vmm_kernel<<<grid, block, 0, stream>>>(g, wt, nullptr, mask, omask, out, m,
                                         k, n, gate_in, gate_out, method);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the tensor-core kernel of vmm_bwd_bf16.cu, the plan (br, bn, kc, mf,
// nt) of kernels/vmm/vmm.py VmmBwdMmaPlan; there is no general bf16 kernel.
REPRO_API int repro_vmm_bwd_fused_bf16(const __nv_bfloat16* g,
                                       const __nv_bfloat16* wt,
                                       const uint8_t* mask,
                                       const uint8_t* omask,
                                       __nv_bfloat16* out, int s, int m, int k,
                                       int n, int gate_in, int gate_out,
                                       int method, int br, int bn, int kc,
                                       int mf, int nt, cudaStream_t stream) {
  return static_cast<int>(repro::vmm_bwd_mma_bf16(
      g, wt, mask, omask, out, s, m, k, n, gate_in, gate_out, method, br, bn,
      kc, mf, nt, stream));
}
