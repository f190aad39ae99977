// The backward of the mamba-1 selective scan (B13 bwd): the vjp of
// ssm_scan.cu's recurrence, one launch per mamba layer of an explain's
// backward.
//
// Replaces: src/repro/kernels/ssm_scan/ops.py, _bwd (jax.vjp of the
// reference loop; the JAX package has no Pallas kernel for it).
//
// Per batch row b and channel d, with abar_t = exp(dt_t A) and h_t the
// forward's states, the adjoint state lam (dL/dh_t) walks t = S-1 .. 0 from
// lam = gh[b,d,:]:
//   lam   += gy_t * C_t
//   dC_t  += h_t * gy_t          dB_t += lam * (dt_t x_t)   (summed over d)
//   dx_t   = dt_t * sum_n lam * B_t
//   u      = lam * abar_t * h_{t-1}
//   ddt_t  = sum_n A * u + x_t * sum_n lam * B_t
//   dA    += dt_t * u                                     (over b and t)
//   lam    = abar_t * lam
// and dh0 = lam at the end.  dt, B, C, A, h0, gh and the gradients of dt,
// B, C, A, h0 are f32; x, gy and dx are f32 or bf16.  A null output
// pointer skips that gradient (and its reductions).
//
// Bound on an H100: bytes.  At falcon-mamba-7b's explain shape (B = 4,
// S = 72, D = 8192, N = 16, bf16 x and gy; the explain asks for dt, x, B
// and C, and h_last is unused, so there is no gh) one launch must read dt,
// x, gy, B, C, A and h0 and write ddt, dx, dB and dC: 35.7 MB, 0.0107 ms
// at 3.35 TB/s; its 37.7 M exponentials take 0.009 ms on the SFU.  The kernel evaluates three per element-step
// (the checkpoint pass, the segment's recompute, the adjoint), each next
// to the updates and, in the adjoint, the butterflies of dB and dC: it is
// issue- and latency-bound, far above the bytes.
//
// Design.  Lanes as in the forward (ssm_scan.cuh): a channel is 4 lanes of
// 4 states.  A block is kChannels = 32 channels of one batch row (128
// threads), a fixed count: the block is also the group whose dB/dC
// partial sums it writes, so no knob can change a sum's order.
// * h_{t-1} in reverse order is recomputed, never inverted (abar can be
//   tiny).  The steps are cut into segments of kSeg = 8; a forward pass
//   from h0 keeps the state entering each segment of a window (up to
//   kMaxSlots segments) in shared memory.  Then, segment by segment in
//   reverse, the segment's 9 states are recomputed into registers (same
//   operations as the forward kernel, so the same bits) and the adjoint
//   walks back over them, evaluating each decay once more (one ex2.approx,
//   ssm_scan.cuh: cheaper than 32 more registers a thread).  Sequences
//   longer than a window run windows from the last to the first, each
//   re-running the forward from h0 to its start.  The wrapper sets the
//   window from `chunk`.  Registers bind (128 a thread, 4 blocks = 16
//   warps an SM); the grid at the explain's shape is 256 x 4 blocks.
// * Reductions with no float atomics, so every run gives the same bits.
//   The sums over n (dx, ddt) are each lane's states in order, then the
//   fixed shuffle tree of group_sum.  dB_t and dC_t, sums over d, are
//   reduced per step over a warp's 8 channels by a butterfly (each lane
//   ends with one state's sum), summed over the block's 4 warps in warp
//   order at the end of each segment and written as the block's partial,
//   workspace [B, S, G, N] (G = ceil(D / 32)); a second kernel,
//   selective_scan_bwd_sum_kernel, sums the G partials in a fixed order.
//   dA's per-(b, d) sums over t stay in registers and are written to
//   [B, D, N]; selective_scan_bwd_sum_a_kernel sums them over b in order.
//   Both run under the same entry point, one launch of the wrapper.

#include "common.cuh"
#include "ssm_scan.cuh"

namespace {

using namespace repro::scan;

constexpr int kSeg = 8;                        // steps a register segment
constexpr int kChannels = 32;                  // channels a block / group
constexpr int kThreads = kLanes * kChannels;   // 128
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 16;                  // segments a window
constexpr int kSumThreads = 256;               // the partial-sum kernels
constexpr int kSumParts = kSumThreads / kMaxN;

// Sum of v[0..3] over the 8 channels of a warp (lane = 4 * channel + q):
// a butterfly over the channel bits that leaves one state's sum on each
// lane, stored to dst[kSpl * q + j] by the lanes of even channels.  The
// tree is fixed, so the bits are the same on every run.
__device__ __forceinline__ void warp_channel_sum(const float (&v)[kSpl],
                                                 float* dst, int lane) {
  const int q = lane & 3, c0 = (lane >> 2) & 1, c1 = (lane >> 3) & 1,
            c2 = (lane >> 4) & 1;
  // channel bit 2: keep states 2*c2, 2*c2 + 1, send the other two
  const float w0 = __fadd_rn(c2 ? v[2] : v[0],
                             __shfl_xor_sync(kFull, c2 ? v[0] : v[2], 16));
  const float w1 = __fadd_rn(c2 ? v[3] : v[1],
                             __shfl_xor_sync(kFull, c2 ? v[1] : v[3], 16));
  // channel bit 1: keep state 2*c2 + c1
  float u = __fadd_rn(c1 ? w1 : w0, __shfl_xor_sync(kFull, c1 ? w0 : w1, 8));
  // channel bit 0: both lanes of the pair hold the sum
  u = __fadd_rn(u, __shfl_xor_sync(kFull, u, 4));
  if (c0 == 0) dst[kSpl * q + 2 * c2 + c1] = u;
}

template <typename T>
struct Step {   // the per-step operands of one channel
  float dtv, xv, dtx;
  float bq[kSpl];
  __device__ __forceinline__ Step(const float* __restrict__ dt,
                                  const T* __restrict__ x,
                                  const float* __restrict__ bm, size_t rt,
                                  size_t g, bool live, int q, int n,
                                  bool vec4) {
    dtv = live ? __ldg(dt + g) : 0.f;
    xv = live ? to_f32(x[g]) : 0.f;
    dtx = __fmul_rn(dtv, xv);
    load_states(bm + rt * n, q, n, vec4, bq);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 4) selective_scan_bwd_kernel(
    const float* __restrict__ dt, const T* __restrict__ x,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ h0,
    const T* __restrict__ gy, const float* __restrict__ gh,
    float* __restrict__ ddt, T* __restrict__ dx, float* __restrict__ ws_b,
    float* __restrict__ ws_c, float* __restrict__ ws_a,
    float* __restrict__ dh0, int s, int d, int n, int wsegs, int vec4) {
  extern __shared__ __align__(16) float smem[];
  float4* ckpt = reinterpret_cast<float4*>(smem);   // [wsegs, kThreads]
  float* part = smem + wsegs * kThreads * 4;         // [2, kWarps, kSeg, N]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q = tid % kLanes, n0 = kSpl * q;
  const int b = blockIdx.y, ch = blockIdx.x * kChannels + tid / kLanes;
  const bool live = ch < d;
  const size_t row = static_cast<size_t>(b) * s;
  const size_t chn = (static_cast<size_t>(b) * d + ch) * n;   // [b, ch, :]
  const bool need_u = ddt != nullptr || ws_a != nullptr;
  const bool need_bc = ws_b != nullptr || ws_c != nullptr;

  float av[kSpl], lam[kSpl], da[kSpl];
  bool ok[kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    ok[j] = live && n0 + j < n;
    av[j] = ok[j] ? decay_rate(a[static_cast<size_t>(ch) * n + n0 + j])
                  : 0.f;
    lam[j] = ok[j] && gh != nullptr ? gh[chn + n0 + j] : 0.f;
    da[j] = 0.f;
  }

  const int win = wsegs * kSeg;
  for (int w = (s + win - 1) / win - 1; w >= 0; --w) {
    const int ws0 = w * win, wend = min(s, ws0 + win);
    const int segs = (wend - ws0 + kSeg - 1) / kSeg;
    // forward from h0 to the window, then the state entering each segment
    float h[kSpl];
#pragma unroll
    for (int j = 0; j < kSpl; ++j) h[j] = ok[j] ? h0[chn + n0 + j] : 0.f;
    for (int k = 0; k < ws0 / kSeg + segs - 1; ++k) {
      if (k >= ws0 / kSeg)
        ckpt[(k - ws0 / kSeg) * kThreads + tid] =
            make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        const int t = k * kSeg + i;
        const Step<T> st(dt, x, bm, row + t, (row + t) * d + ch, live, q, n,
                         vec4);
#pragma unroll
        for (int j = 0; j < kSpl; ++j)
          if (ok[j]) h[j] = update(decay(st.dtv, av[j]), h[j], st.dtx,
                                   st.bq[j]);
      }
    }
    ckpt[(segs - 1) * kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);

    for (int k = segs - 1; k >= 0; --k) {
      const int t0 = ws0 + k * kSeg, len = min(kSeg, wend - t0);
      // the segment's states h[i] = h_{t0+i-1} and decays, recomputed
      float hs[kSeg + 1][kSpl];
      const float4 c4 = ckpt[k * kThreads + tid];
      hs[0][0] = c4.x, hs[0][1] = c4.y, hs[0][2] = c4.z, hs[0][3] = c4.w;
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
#pragma unroll
        for (int j = 0; j < kSpl; ++j) hs[i + 1][j] = 0.f;
        if (i < len) {
          const int t = t0 + i;
          const Step<T> st(dt, x, bm, row + t, (row + t) * d + ch, live, q,
                           n, vec4);
#pragma unroll
          for (int j = 0; j < kSpl; ++j) {
            if (ok[j]) {
              hs[i + 1][j] = update(decay(st.dtv, av[j]), hs[i][j], st.dtx,
                                    st.bq[j]);
            }
          }
        }
      }
      // the adjoint, back over the segment
#pragma unroll
      for (int i = kSeg - 1; i >= 0; --i) {
        if (i >= len) continue;
        const int t = t0 + i;
        const size_t g = (row + t) * d + ch;
        const Step<T> st(dt, x, bm, row + t, g, live, q, n, vec4);
        const float gv = live ? to_f32(gy[g]) : 0.f;
        float cq[kSpl], pb[kSpl], pc[kSpl];
        load_states(cm + (row + t) * n, q, n, vec4, cq);
        float sb = 0.f, sa = 0.f;
#pragma unroll
        for (int j = 0; j < kSpl; ++j) {
          pb[j] = pc[j] = 0.f;
          if (!ok[j]) continue;
          const float abar = decay(st.dtv, av[j]);   // as recomputed
          lam[j] = __fmaf_rn(gv, cq[j], lam[j]);
          pc[j] = __fmul_rn(hs[i + 1][j], gv);
          pb[j] = __fmul_rn(lam[j], st.dtx);
          sb = __fmaf_rn(lam[j], st.bq[j], sb);
          if (need_u) {
            const float u = __fmul_rn(__fmul_rn(lam[j], abar), hs[i][j]);
            sa = __fmaf_rn(av[j], u, sa);
            da[j] = __fmaf_rn(st.dtv, u, da[j]);
          }
          lam[j] = __fmul_rn(abar, lam[j]);
        }
        sb = group_sum(sb);
        sa = group_sum(sa);
        if (live && q == 0) {
          if (dx != nullptr) dx[g] = from_f32<T>(__fmul_rn(st.dtv, sb));
          if (ddt != nullptr)
            ddt[g] = __fmaf_rn(st.xv, sb, __fmul_rn(sa, kLn2));
        }
        float* pw = part + (warp * kSeg + i) * kMaxN;
        if (ws_b != nullptr) warp_channel_sum(pb, pw, lane);
        if (ws_c != nullptr)
          warp_channel_sum(pc, pw + kWarps * kSeg * kMaxN, lane);
      }
      if (!need_bc) continue;
      __syncthreads();                // the warps' partials are in place
      for (int e = tid; e < 2 * kSeg * kMaxN; e += kThreads) {
        const int which = e / (kSeg * kMaxN), i = e / kMaxN % kSeg,
                  nn = e % kMaxN;
        float* ws = which ? ws_c : ws_b;
        if (ws == nullptr || i >= len || nn >= n) continue;
        const float* p = part + which * kWarps * kSeg * kMaxN + i * kMaxN + nn;
        float v = p[0];
#pragma unroll
        for (int wp = 1; wp < kWarps; ++wp)
          v = __fadd_rn(v, p[wp * kSeg * kMaxN]);
        ws[((row + t0 + i) * gridDim.x + blockIdx.x) * n + nn] = v;
      }
      __syncthreads();                // before the next segment's partials
    }
  }

#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    if (!ok[j]) continue;
    if (ws_a != nullptr) ws_a[chn + n0 + j] = da[j];
    if (dh0 != nullptr) dh0[chn + n0 + j] = lam[j];
  }
}

// dB and dC [B*S, N]: the sum of the G block partials of each (b, t, n),
// thread p of a state summing partials p, p + kSumParts, ... in order, then
// the kSumParts sums in order.
__global__ void __launch_bounds__(kSumThreads) selective_scan_bwd_sum_kernel(
    const float* __restrict__ ws_b, const float* __restrict__ ws_c,
    float* __restrict__ db, float* __restrict__ dc, int groups, int n) {
  __shared__ float red[2][kSumParts][kMaxN];
  const int tid = threadIdx.x, nn = tid % kMaxN, p = tid / kMaxN;
  const size_t bt = blockIdx.x;
  for (int which = 0; which < 2; ++which) {
    const float* ws = which ? ws_c : ws_b;
    float v = 0.f;
    if (ws != nullptr && nn < n)
      for (int g = p; g < groups; g += kSumParts)
        v = __fadd_rn(v, ws[(bt * groups + g) * n + nn]);
    red[which][p][nn] = v;
  }
  __syncthreads();
  if (tid < 2 * kMaxN) {
    const int which = tid / kMaxN, m = tid % kMaxN;
    float* out = which ? dc : db;
    if (out != nullptr && m < n) {
      float v = red[which][0][m];
      for (int r = 1; r < kSumParts; ++r) v = __fadd_rn(v, red[which][r][m]);
      out[bt * n + m] = v;
    }
  }
}

// dA [D*N]: the per-row sums [B, D*N] summed over b in order.
__global__ void __launch_bounds__(kSumThreads)
    selective_scan_bwd_sum_a_kernel(const float* __restrict__ ws_a,
                                    float* __restrict__ da, int batch,
                                    int dn) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= dn) return;
  float v = 0.f;
  for (int b = 0; b < batch; ++b)
    v = __fadd_rn(v, ws_a[static_cast<size_t>(b) * dn + i]);
  da[i] = v;
}

template <typename T>
int selective_scan_bwd(const float* dt, const T* x, const float* bm,
                       const float* cm, const float* a, const float* h0,
                       const T* gy, const float* gh, float* ddt, T* dx,
                       float* db, float* dc, float* da, float* dh0,
                       float* ws_b, float* ws_c, float* ws_a, int batch,
                       int s, int d, int n, int window,
                       cudaStream_t stream) {
  static_assert(kSpl == 4 && kWarps * 32 == kThreads, "lane layout");
  const bool steps = batch > 0 && s > 0;   // dB and dC have elements
  if (n < 1 || n > kMaxN || window < kSeg || window % kSeg != 0 ||
      window > kMaxSlots * kSeg || (da != nullptr && ws_a == nullptr) ||
      (steps && ((db != nullptr && ws_b == nullptr) ||
                 (dc != nullptr && ws_c == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!steps) db = dc = nullptr;
  const int wsegs = window / kSeg;
  const int vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(bm) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cm) % 16 == 0;
  const int groups = (d + kChannels - 1) / kChannels;
  const int smem = (wsegs * kThreads * 4 + 2 * kWarps * kSeg * kMaxN) * 4;
  if (batch > 0 && groups > 0) {
    selective_scan_bwd_kernel<T>
        <<<dim3(groups, batch), kThreads, smem, stream>>>(
            dt, x, bm, cm, a, h0, gy, gh, ddt, dx, db ? ws_b : nullptr,
            dc ? ws_c : nullptr, da ? ws_a : nullptr, dh0, s, d, n, wsegs,
            vec4);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (db != nullptr || dc != nullptr)
    selective_scan_bwd_sum_kernel<<<batch * s, kSumThreads, 0, stream>>>(
        db ? ws_b : nullptr, dc ? ws_c : nullptr, db, dc, groups, n);
  if (da != nullptr && d > 0)
    selective_scan_bwd_sum_a_kernel<<<(d * n + kSumThreads - 1) / kSumThreads,
                                      kSumThreads, 0, stream>>>(ws_a, da,
                                                                batch, d * n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_API int repro_selective_scan_bwd(
    const float* dt, const float* x, const float* bm, const float* cm,
    const float* a, const float* h0, const float* gy, const float* gh,
    float* ddt, float* dx, float* db, float* dc, float* da, float* dh0,
    float* ws_b, float* ws_c, float* ws_a, int batch, int s, int d, int n,
    int window, cudaStream_t stream) {
  return selective_scan_bwd<float>(dt, x, bm, cm, a, h0, gy, gh, ddt, dx, db,
                                   dc, da, dh0, ws_b, ws_c, ws_a, batch, s, d,
                                   n, window, stream);
}

REPRO_API int repro_selective_scan_bwd_bf16(
    const float* dt, const __nv_bfloat16* x, const float* bm,
    const float* cm, const float* a, const float* h0,
    const __nv_bfloat16* gy, const float* gh, float* ddt, __nv_bfloat16* dx,
    float* db, float* dc, float* da, float* dh0, float* ws_b, float* ws_c,
    float* ws_a, int batch, int s, int d, int n, int window,
    cudaStream_t stream) {
  return selective_scan_bwd<__nv_bfloat16>(dt, x, bm, cm, a, h0, gy, gh, ddt,
                                           dx, db, dc, da, dh0, ws_b, ws_c,
                                           ws_a, batch, s, d, n, window,
                                           stream);
}
