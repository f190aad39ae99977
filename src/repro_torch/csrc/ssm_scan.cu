// The mamba-1 selective scan (B13): the SSM hot spot of LM token
// attribution over falcon-mamba's stack, one launch per mamba layer of an
// explain forward.
//
// Replaces: src/repro/kernels/ssm_scan/ssm_scan.py, selective_scan_pallas
// (body _scan_kernel).
//
// Per batch row b, channel d and state n, over t = 0 .. S-1:
//   h  = exp(dt[b,t,d] * A[d,n]) * h + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//   y[b,t,d] = sum_n h * C[b,t,n]
// from h = h0[b,d,:]; y in x's type (f32 or bf16), h_last[b,d,:] f32.
// dt, B, C, A and h0 are f32.
//
// Bound on an H100: operations, narrowly.  At falcon-mamba-7b's explain
// shape (B = 4, S = 72, D = 8192, N = 16, bf16 x) one launch moves ~23.6 MB
// (7.0 us at 3.35 TB/s) and evaluates B*S*D*N = 37.7 M exponentials on the
// SFU (MUFU.EX2, 16 per SM per clock: ~9.0 us).  What a step costs besides
// the exponential (the products, the update, the y sum and its shuffles,
// the shared-memory reads) runs on the other pipes, so the kernel is
// issue-bound in practice: its design is about keeping enough warps in
// flight and few instructions a step.  The decay is one ex2.approx on a
// rate pre-scaled by log2(e) (ssm_scan.cuh decay_rate / decay), not the
// precise expf, whose range reduction costs about 8 more instructions a
// state and step; it moves y by about 1e-6 relative, well inside the
// tolerance the JAX package holds this kernel to (atol 2e-4, rtol 2e-3).
//
// Design: a channel (b, d) is a group of kLanes = 4 lanes, each keeping 4
// of its N <= 16 f32 states and their decay rates A[d,:] in registers and
// walking t in order; nothing is carried between blocks and no [B,S,D,N]
// tensor exists anywhere.  y's sum over n is each lane's 4 states in
// index order, then the fixed shuffle tree of ssm_scan.cuh (group_sum).
// A block covers `channels` (8 to 32, from the wrapper's d_tile)
// consecutive channels of one batch row, so the explain's shape runs
// 4 x 256 blocks of 128 threads: ~31 warps an SM where one thread per
// channel gave 7.8.  Time is staged in chunks of at most kMaxChunk steps,
// double-buffered: while a chunk is computed out of shared memory, the
// next one lands there by cp.async (its B and C rows, padded to 16 states,
// and the block's dt and x columns, coalesced along d), so loads overlap
// arithmetic.  The kernel stops at S: no padding (a zero-padded step,
// dt = 0, would leave h unchanged).
//
// The knobs change the grid and the staging, never the arithmetic of an
// element: every step is the same sequence of operations (ssm_scan.cuh:
// __fmul_rn / __fmaf_rn / ex2.approx, no fast math) and the y sum has one
// fixed order.  So any (d_tile, chunk) pair gives the same bits.

#include "common.cuh"
#include "ssm_scan.cuh"

namespace {

using namespace repro::scan;

constexpr int kMaxChannels = 32;  // channels a block: 128 threads
constexpr int kMaxChunk = 16;     // steps a staging chunk

// One staging chunk in shared memory: the block's dt columns [ck, cpb],
// the B and C rows [ck, kMaxN] (zeros past N) and the x columns [ck, cpb].
template <typename T>
struct Chunk {
  float* dt;
  float* b;
  float* c;
  T* x;
  __device__ Chunk(unsigned char* base, int ck, int cpb)
      : dt(reinterpret_cast<float*>(base)),
        b(dt + ck * cpb),
        c(b + ck * kMaxN),
        x(reinterpret_cast<T*>(c + ck * kMaxN)) {}
  __host__ __device__ static int bytes(int ck, int cpb) {
    return ck * (cpb * (4 + static_cast<int>(sizeof(T))) + 2 * kMaxN * 4);
  }
};

// Issue the copies of steps row0 .. row0+len-1 (row0 = b*S + t0) into `st`;
// steps past len and channels past d are zero-filled.  Every copy is a
// 4-byte cp.async, except a bf16 pair that straddles d or sits off a
// 4-byte boundary, which is read by ordinary loads.
template <typename T>
__device__ void stage(const Chunk<T>& st, const float* __restrict__ dt,
                      const T* __restrict__ x, const float* __restrict__ bm,
                      const float* __restrict__ cm, size_t row0, int len,
                      int ck, int d, int d0, int cpb, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < ck * cpb; e += nt) {
    const int tt = e / cpb, ch = d0 + e - tt * cpb;
    const bool ok = tt < len && ch < d;
    const size_t g = (row0 + tt) * d + ch;
    repro::cp_async<4>(st.dt + e, ok ? dt + g : dt, ok);
    if constexpr (sizeof(T) == 4) {
      repro::cp_async<4>(st.x + e, ok ? x + g : x, ok);
    }
  }
  if constexpr (sizeof(T) == 2) {
    const int half = cpb / 2;
    for (int e = tid; e < ck * half; e += nt) {
      const int tt = e / half, c = 2 * (e - tt * half), ch = d0 + c;
      const size_t g = (row0 + tt) * d + ch;
      T* dst = st.x + tt * cpb + c;
      if (tt < len && ch + 1 < d &&
          reinterpret_cast<uintptr_t>(x + g) % 4 == 0) {
        repro::cp_async<4>(dst, x + g, true);
      } else {
        const T zero = from_f32<T>(0.f);
        dst[0] = tt < len && ch < d ? x[g] : zero;
        dst[1] = tt < len && ch + 1 < d ? x[g + 1] : zero;
      }
    }
  }
  for (int e = tid; e < ck * kMaxN; e += nt) {
    const int tt = e / kMaxN, j = e - tt * kMaxN;
    const bool ok = tt < len && j < n;
    const size_t g = (row0 + tt) * n + j;
    repro::cp_async<4>(st.b + e, ok ? bm + g : bm, ok);
    repro::cp_async<4>(st.c + e, ok ? cm + g : cm, ok);
  }
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kMaxChannels, 8)
    selective_scan_kernel(const float* __restrict__ dt,
                          const T* __restrict__ x,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ a,
                          const float* __restrict__ h0, T* __restrict__ y,
                          float* __restrict__ h_last, int s, int d, int n,
                          int cpb, int ck) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int q = tid % kLanes, c = tid / kLanes, n0 = kSpl * q;
  const int b = blockIdx.y, d0 = blockIdx.x * cpb, ch = d0 + c;
  const bool live = ch < d;
  const size_t row = static_cast<size_t>(b) * s;   // (b, t = 0)

  float h[kSpl], av[kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    h[j] = 0.f;
    av[j] = 0.f;
    if (live && n0 + j < n) {
      h[j] = h0[(static_cast<size_t>(b) * d + ch) * n + n0 + j];
      av[j] = decay_rate(a[static_cast<size_t>(ch) * n + n0 + j]);
    }
  }

  const int buf = Chunk<T>::bytes(ck, cpb);
  const int chunks = (s + ck - 1) / ck;
  if (chunks > 0) {
    stage(Chunk<T>(smem, ck, cpb), dt, x, bm, cm, row, min(ck, s), ck, d,
          d0, cpb, n);
    repro::cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * ck, len = min(ck, s - t0);
    if (k + 1 < chunks) {             // the next chunk lands meanwhile
      const int t1 = t0 + ck;
      stage(Chunk<T>(smem + ((k + 1) & 1) * buf, ck, cpb), dt, x, bm, cm,
            row + t1, min(ck, s - t1), ck, d, d0, cpb, n);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();                  // chunk k has landed for every thread
    const Chunk<T> st(smem + (k & 1) * buf, ck, cpb);
    T* yout = y + (row + t0) * d + ch;
#pragma unroll 4
    for (int tt = 0; tt < len; ++tt) {
      const float dtv = st.dt[tt * cpb + c];
      const float dtx = __fmul_rn(dtv, to_f32(st.x[tt * cpb + c]));
      const float4 bv = *reinterpret_cast<const float4*>(st.b + tt * kMaxN
                                                         + n0);
      const float4 cv = *reinterpret_cast<const float4*>(st.c + tt * kMaxN
                                                         + n0);
      const float bq[kSpl] = {bv.x, bv.y, bv.z, bv.w};
      const float cq[kSpl] = {cv.x, cv.y, cv.z, cv.w};
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        if (n0 + j < n) {
          h[j] = update(decay(dtv, av[j]), h[j], dtx, bq[j]);
          acc = __fmaf_rn(h[j], cq[j], acc);
        }
      }
      acc = group_sum(acc);
      if (q == 0 && live) yout[static_cast<size_t>(tt) * d] = from_f32<T>(acc);
    }
    __syncthreads();                  // chunk k is read: its buffer is free
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < kSpl; ++j)
      if (n0 + j < n)
        h_last[(static_cast<size_t>(b) * d + ch) * n + n0 + j] = h[j];
  }
}

template <typename T>
int selective_scan(const float* dt, const T* x, const float* bm,
                   const float* cm, const float* a, const float* h0, T* y,
                   float* h_last, int batch, int s, int d, int n, int channels,
                   int chunk, cudaStream_t stream) {
  static_assert(kSpl == 4, "a lane reads its B and C states as one float4");
  if (n < 1 || n > kMaxN || channels < 8 || channels > kMaxChannels ||
      channels % 8 != 0 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ck = max(1, min(min(chunk, kMaxChunk), s));
  const int smem = 2 * Chunk<T>::bytes(ck, channels);
  const dim3 grid((d + channels - 1) / channels, batch);
  selective_scan_kernel<T><<<grid, kLanes * channels, smem, stream>>>(
      dt, x, bm, cm, a, h0, y, h_last, s, d, n, channels, ck);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_API int repro_selective_scan(const float* dt, const float* x,
                                   const float* bm, const float* cm,
                                   const float* a, const float* h0, float* y,
                                   float* h_last, int batch, int s, int d,
                                   int n, int channels, int chunk,
                                   cudaStream_t stream) {
  return selective_scan<float>(dt, x, bm, cm, a, h0, y, h_last, batch, s, d,
                               n, channels, chunk, stream);
}

REPRO_API int repro_selective_scan_bf16(
    const float* dt, const __nv_bfloat16* x, const float* bm,
    const float* cm, const float* a, const float* h0, __nv_bfloat16* y,
    float* h_last, int batch, int s, int d, int n, int channels, int chunk,
    cudaStream_t stream) {
  return selective_scan<__nv_bfloat16>(dt, x, bm, cm, a, h0, y, h_last,
                                       batch, s, d, n, channels, chunk,
                                       stream);
}
