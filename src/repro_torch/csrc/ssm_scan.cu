// The mamba-1 selective scan (B13): the SSM hot spot of LM token
// attribution over falcon-mamba's stack, one launch per mamba layer of an
// explain forward.
//
// Replaces: src/repro/kernels/ssm_scan/ssm_scan.py, selective_scan_pallas
// (body _scan_kernel).
//
// Per batch row b, channel d and state n, over t = 0 .. S-1:
//   h  = exp(dt[b,t,d] * A[d,n]) * h + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//   y[b,t,d] = sum_n h * C[b,t,n]          (n = 0 .. N-1, in that order)
// from h = h0[b,d,:]; y in x's type (f32 or bf16), h_last[b,d,:] f32.
// dt, B, C, A and h0 are f32.
//
// Bound on an H100: operations, narrowly.  At falcon-mamba-7b's explain
// shape (B = 4, S = 72, D = 8192, N = 16, bf16 x) one launch moves ~23.6 MB
// (7.0 us at 3.35 TB/s) and evaluates B*S*D*N = 37.7 M exponentials on the
// SFU (MUFU.EX2, 16 per SM per clock: ~9.0 us).
//
// Design: one thread per (b, d) channel keeps its N <= 16 states and its
// N decay rates A[d,:] in registers and walks t in order, so nothing is
// carried between blocks and no [B,S,D,N] tensor exists anywhere.  A block
// covers `threads` consecutive channels of one batch row (the wrapper
// takes min(d_tile, 128)).  Time is staged in chunks: each chunk's B and C
// rows (read by every channel of the block) and the block's dt and x
// columns go to shared memory first, every load of the chunk in flight at
// once and coalesced along d; then each thread runs the chunk's steps out
// of shared memory and stores y coalesced along d.  The chunk length is
// min(chunk, S, what fits the shared-memory budget).  The kernel stops at
// S: no padding (a zero-padded step, dt = 0, would leave h unchanged).
//
// The knobs change the grid and the staging, never the arithmetic of an
// element: every step is the same sequence of correctly rounded
// operations (__fmul_rn / __fmaf_rn, expf, no fast math), and the sum over
// n runs in index order.  So any (d_tile, chunk) pair gives the same bits.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kMaxN = 16;             // states kept in registers
constexpr int kMaxThreads = 128;      // channels per block
constexpr int kSmemBudget = 96 * 1024;

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

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) selective_scan_kernel(
    const float* __restrict__ dt, const T* __restrict__ x,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ h0,
    T* __restrict__ y, float* __restrict__ h_last, int s, int d, int n,
    int ck) {
  extern __shared__ float smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  float* sb = smem;                   // [ck, n]   B rows of the chunk
  float* sc = sb + ck * n;            // [ck, n]   C rows
  float* sdt = sc + ck * n;           // [ck, nt]  dt columns of the block
  T* sx = reinterpret_cast<T*>(sdt + ck * nt);   // [ck, nt]  x columns

  const int b = blockIdx.y;
  const int ch = blockIdx.x * nt + tid;
  const bool live = ch < d;
  const size_t row = static_cast<size_t>(b) * s;   // (b, t = 0)

  float h[kMaxN], av[kMaxN];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    h[j] = 0.f;
    av[j] = 0.f;
    if (live && j < n) {
      h[j] = h0[(static_cast<size_t>(b) * d + ch) * n + j];
      av[j] = a[static_cast<size_t>(ch) * n + j];
    }
  }

  for (int t0 = 0; t0 < s; t0 += ck) {
    const int len = min(ck, s - t0);
    __syncthreads();                  // the previous chunk's rows are read
    const float* bsrc = bm + (row + t0) * n;
    const float* csrc = cm + (row + t0) * n;
    for (int i = tid; i < len * n; i += nt) {
      sb[i] = bsrc[i];
      sc[i] = csrc[i];
    }
    if (live) {                       // each thread stages its own column
      const size_t base = (row + t0) * d + ch;
#pragma unroll 8
      for (int t = 0; t < len; ++t) {
        sdt[t * nt + tid] = dt[base + static_cast<size_t>(t) * d];
        sx[t * nt + tid] = x[base + static_cast<size_t>(t) * d];
      }
    }
    __syncthreads();
    if (!live) continue;
    T* yout = y + (row + t0) * d + ch;
    for (int t = 0; t < len; ++t) {
      const float dtv = sdt[t * nt + tid];
      const float dtx = __fmul_rn(dtv, to_f32(sx[t * nt + tid]));
      const float* bt = sb + t * n;
      const float* ct = sc + t * n;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        if (j < n) {
          const float abar = expf(__fmul_rn(dtv, av[j]));
          h[j] = __fmaf_rn(abar, h[j], __fmul_rn(dtx, bt[j]));
          acc = __fmaf_rn(h[j], ct[j], acc);
        }
      }
      yout[static_cast<size_t>(t) * d] = from_f32<T>(acc);
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < kMaxN; ++j)
      if (j < n) h_last[(static_cast<size_t>(b) * d + ch) * n + j] = h[j];
  }
}

template <typename T>
int selective_scan(const float* dt, const T* x, const float* bm,
                   const float* cm, const float* a, const float* h0, T* y,
                   float* h_last, int batch, int s, int d, int n, int threads,
                   int chunk, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || threads < 1 || threads > kMaxThreads ||
      chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // staging: per timestep 2n floats of B/C plus the block's dt and x
  const int per_step = 2 * n * 4 + threads * (4 + static_cast<int>(sizeof(T)));
  const int ck = max(1, min(min(chunk, max(s, 1)), kSmemBudget / per_step));
  const int smem = ck * per_step;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        selective_scan_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((d + threads - 1) / threads, batch);
  selective_scan_kernel<T><<<grid, threads, smem, stream>>>(
      dt, x, bm, cm, a, h0, y, h_last, s, d, n, ck);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_API int repro_selective_scan(const float* dt, const float* x,
                                   const float* bm, const float* cm,
                                   const float* a, const float* h0, float* y,
                                   float* h_last, int batch, int s, int d,
                                   int n, int threads, int chunk,
                                   cudaStream_t stream) {
  return selective_scan<float>(dt, x, bm, cm, a, h0, y, h_last, batch, s, d,
                               n, threads, chunk, stream);
}

REPRO_API int repro_selective_scan_bf16(
    const float* dt, const __nv_bfloat16* x, const float* bm,
    const float* cm, const float* a, const float* h0, __nv_bfloat16* y,
    float* h_last, int batch, int s, int d, int n, int threads, int chunk,
    cudaStream_t stream) {
  return selective_scan<__nv_bfloat16>(dt, x, bm, cm, a, h0, y, h_last,
                                       batch, s, d, n, threads, chunk,
                                       stream);
}
