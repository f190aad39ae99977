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
// at 3.35 TB/s; its 37.7 M exponentials take 0.009 ms on the SFU.  The
// kernel evaluates three per element-step (the checkpoint pass, the
// segment's recompute, the adjoint) and, in the adjoint, three fixed
// reduction trees per step: it is issue- and latency-bound, far above the
// bytes.
//
// Design.  Lanes as in the forward (ssm_scan.cuh): a channel is 4 lanes of
// 4 states.  A block is kChannels = 32 channels of one batch row (128
// threads); kCluster = 4 neighbouring blocks form a thread-block cluster,
// the group of kGroup = 128 channels whose dB/dC partial sums leave the
// chip.  Both counts are constants, so no knob changes a sum's order.
// * Every operand of a step comes from shared memory.  Time is cut into
//   segments of kSeg = 8 steps.  A block's work is a list of jobs, each
//   one segment: the forward from h0 over the segments before the
//   window's last (the checkpoint pass), then the window's segments in
//   reverse (recompute and adjoint).  While job j runs, jobs j + 1 .. j +
//   3 land in a four-stage cp.async ring (a checkpoint job is short: three
//   of them cover a load's latency), 16-byte copies where D % 8 == 0, N %
//   4 == 0 and the operands are 16-byte aligned: the block's dt and x
//   columns and the B row for a forward job, and also gy and the C row
//   for a reverse one.  No step waits on a device load, and one barrier a
//   job both publishes its stage and frees the stage the job three ahead
//   takes.
// * A step has no branch.  States past N (zero B, C, rate, h0 and gh) and
//   the steps past S of a last, short segment (zero dt, x, gy, B, C)
//   compute exact zeros and leave lam as it was; only the stores of dx and
//   ddt are predicated.
// * h_{t-1} in reverse order is recomputed, never inverted (abar can be
//   tiny).  The checkpoint pass keeps the state entering each segment of
//   a window (up to kMaxSlots segments) in shared memory; a reverse job
//   recomputes its segment's 9 states into registers (the forward's
//   operations, so its bits) and walks the adjoint back over them,
//   evaluating each decay once more (one ex2.approx a state and step:
//   keeping the 32 decays of a segment would take 16 KB of shared memory a
//   block or 32 registers a thread, and cost a block an SM).  Sequences
//   longer than a window run windows from the last to the first, each
//   re-running the forward from h0 to its start.  The wrapper sets the
//   window from `chunk`.  Registers bind: 5 blocks (20 warps) an SM.
//   Shared memory: 42 KB a block at the explain's 72-step window in bf16;
//   windows of 11 segments or more (f32; 13 in bf16) pass 48 KB and opt
//   in, up to 60 KB.
// * Reductions with no float atomics, so every run gives the same bits.
//   The sums over n (dx, ddt) are each lane's states in order, then the
//   fixed shuffle tree of group_sum.  dB_t and dC_t, sums over d, are
//   reduced per step over a warp's 8 channels by one butterfly that leaves
//   each lane one (dB or dC, state) sum, which the lane stores straight
//   into the shared memory of the cluster rank that owns that entry of
//   the segment (the cluster's 16 warps x 256 entries of a segment spread
//   over 4 owners).  After its segment each warp arrives at the cluster
//   barrier and waits only after its next segment's adjoint (the
//   barrier's latency hidden behind it), then sums its 16 of its rank's
//   entries over the 16 warps in (rank, warp) order and writes the
//   cluster's partial, workspace [B, S, G, N] (G = ceil(D / 128)); three
//   inbox thirds take turns.  A second kernel,
//   selective_scan_bwd_sum_kernel, sums the G partials in a fixed order.
//   dA's per-(b, d) sums over t stay in registers and are written to [B,
//   D, N]; selective_scan_bwd_sum_a_kernel sums them over b in order.  All
//   run under the same entry point, one launch of the wrapper.

#include <cooperative_groups.h>

#include "common.cuh"
#include "ssm_scan.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace repro::scan;

constexpr int kSeg = 8;                        // steps a segment
constexpr int kChannels = 32;                  // channels a block
constexpr int kThreads = kLanes * kChannels;   // 128
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;                    // blocks a cluster
constexpr int kGroup = kCluster * kChannels;   // channels a dB/dC partial
constexpr int kMaxSlots = 16;                  // segments a window
constexpr int kMinBlocks = 5;                  // blocks an SM (registers)
constexpr int kAhead = 3;                      // segments in flight
constexpr int kStages = kAhead + 1;            // ring stages
constexpr int kEntries = 2 * kSeg * kMaxN;     // (dB or dC, step, state)
constexpr int kShare = kEntries / kCluster;    // entries a rank owns
constexpr int kSources = kCluster * kWarps;    // warps that push to a rank
constexpr int kBoxes = 3;                      // inbox thirds
constexpr int kSumThreads = 256;               // the partial-sum kernels
constexpr int kSumParts = kSumThreads / kMaxN;

// Sum of pb[0..3] (dB) and pc[0..3] (dC) over the 8 channels of a warp
// (lane = 4 * channel + q): a butterfly over the channel bits that halves
// the values a lane holds at each level, so lane (c2, c1, c0, q) ends with
// the sum of (c2 ? dC : dB) at state 4q + 2c1 + c0, each of the 32 on one
// lane.  The tree is fixed, so the bits are the same on every run.
__device__ __forceinline__ float warp_channel_sum(const float (&pb)[kSpl],
                                                  const float (&pc)[kSpl],
                                                  int lane) {
  const int c0 = (lane >> 2) & 1, c1 = (lane >> 3) & 1, c2 = (lane >> 4) & 1;
  float w[kSpl], u[2];
#pragma unroll
  for (int j = 0; j < kSpl; ++j)   // channel bit 2: keep dB or dC
    w[j] = __fadd_rn(c2 ? pc[j] : pb[j],
                     __shfl_xor_sync(kFull, c2 ? pb[j] : pc[j], 16));
#pragma unroll
  for (int j = 0; j < 2; ++j)      // channel bit 1: keep states 2c1, +1
    u[j] = __fadd_rn(c1 ? w[2 + j] : w[j],
                     __shfl_xor_sync(kFull, c1 ? w[j] : w[2 + j], 8));
  return __fadd_rn(c0 ? u[1] : u[0],  // channel bit 0: keep state 2c1 + c0
                   __shfl_xor_sync(kFull, c0 ? u[0] : u[1], 4));
}

// One staged segment in shared memory: the block's dt columns [kSeg,
// kChannels], the B and C rows [kSeg, kMaxN] (zeros past N), and the x and
// gy columns [kSeg, kChannels].
template <typename T>
struct Seg {
  static constexpr int kBytes =
      kSeg * (kChannels * (4 + 2 * static_cast<int>(sizeof(T))) +
              2 * kMaxN * 4);
  float* dt;
  float* b;
  float* c;
  T* x;
  T* gy;
  __device__ explicit Seg(unsigned char* base)
      : dt(reinterpret_cast<float*>(base)),
        b(dt + kSeg * kChannels),
        c(b + kSeg * kMaxN),
        x(reinterpret_cast<T*>(c + kSeg * kMaxN)),
        gy(x + kSeg * kChannels) {}
};

// The shared memory of a block: the ring [kStages, Seg], the checkpoints
// [wsegs, kThreads] float4 and the inbox [kBoxes, kSources, kShare].
template <typename T>
__host__ __device__ constexpr int smem_bytes(int wsegs) {
  return kStages * Seg<T>::kBytes + wsegs * kThreads * 16 +
         kBoxes * kSources * kShare * 4;
}

// Copy the columns [kSeg, kChannels] of v from row row0 on (channels from
// d0; steps past len and channels past d zero-filled) into dst.  VB = 16:
// 16-byte cp.async (D % 8 == 0, v 16-byte aligned); VB = 4: 4-byte ones,
// except a bf16 pair that straddles d or sits off a 4-byte boundary,
// which is read by ordinary loads.
template <int VB, typename T>
__device__ __forceinline__ void stage_columns(T* dst,
                                              const T* __restrict__ v,
                                              size_t row0, int len, int d,
                                              int d0) {
  constexpr int kPer = VB / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int kRow = kChannels / kPer;                  // copies a step
  for (int e = threadIdx.x; e < kSeg * kRow; e += kThreads) {
    const int tt = e / kRow;
    const int c = kPer * (e - tt * kRow), ch = d0 + c;
    const size_t g = (row0 + tt) * d + ch;
    T* out = dst + tt * kChannels + c;
    if constexpr (VB == 16 || kPer == 1) {
      const bool ok = tt < len && ch < d;
      repro::cp_async<VB>(out, ok ? v + g : v, ok);
    } else if (tt < len && ch + 1 < d &&
               reinterpret_cast<uintptr_t>(v + g) % 4 == 0) {
      repro::cp_async<4>(out, v + g, true);
    } else {
      const T zero = from_f32<T>(0.f);
      out[0] = tt < len && ch < d ? v[g] : zero;
      out[1] = tt < len && ch + 1 < d ? v[g + 1] : zero;
    }
  }
}

// The B or C rows [kSeg, kMaxN] of steps row0 .. row0+len-1, zeros past n
// and len: VB = 16 (N % 4 == 0, 16-byte aligned) or 4 bytes a copy.
template <int VB>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ m,
                                           size_t row0, int len, int n) {
  constexpr int kPer = VB / 4, kRow = kMaxN / kPer;
  for (int e = threadIdx.x; e < kSeg * kRow; e += kThreads) {
    const int tt = e / kRow, j = kPer * (e - tt * kRow);
    const bool ok = tt < len && j < n;
    const size_t g = (row0 + tt) * n + j;
    repro::cp_async<VB>(dst + tt * kMaxN + j, ok ? m + g : m, ok);
  }
}

// Issue the copies of steps row0 .. row0+len-1 (row0 = b*S + t0): dt, x
// and the B row, and for the adjoint (adj) gy and the C row; one cp.async
// group.
template <int VB, typename T>
__device__ __forceinline__ void stage(const Seg<T>& st,
                                      const float* __restrict__ dt,
                                      const T* __restrict__ x,
                                      const T* __restrict__ gy,
                                      const float* __restrict__ bm,
                                      const float* __restrict__ cm,
                                      size_t row0, int len, int d, int d0,
                                      int n, bool adj) {
  stage_columns<VB>(st.dt, dt, row0, len, d, d0);
  stage_columns<VB>(st.x, x, row0, len, d, d0);
  stage_rows<VB>(st.b, bm, row0, len, n);
  if (adj) {
    stage_columns<VB>(st.gy, gy, row0, len, d, d0);
    stage_rows<VB>(st.c, cm, row0, len, n);
  }
}

// Wait until at most `pending` (< kAhead) of this thread's cp.async groups
// are in flight.
__device__ __forceinline__ void wait_for_stage(int pending) {
  static_assert(kAhead == 3, "one case a pending count");
  if (pending >= 2) {
    repro::cp_async_wait<2>();
  } else if (pending == 1) {
    repro::cp_async_wait<1>();
  } else {
    repro::cp_async_wait<0>();
  }
}

// A segment whose warp sums were pushed into the owners' inboxes and whose
// cluster barrier has not been waited on yet.
struct Pushed {
  int box, t0, len;
};

// This warp's 16 of its rank's entries of a pushed segment: the cluster's
// 16 warp sums of each, added in (rank, warp) order, written to the
// workspace at cluster grp.
__device__ __forceinline__ void owner_sum(const float* inbox, Pushed p,
                                          float* __restrict__ ws_b,
                                          float* __restrict__ ws_c,
                                          size_t row, int groups, int grp,
                                          int rank, int n) {
  static_assert(kShare == 16 * kWarps, "16 entries a warp");
  const int lane = threadIdx.x % 32, e = threadIdx.x / 32 * 16 + lane;
  const int ent = rank * kShare + e, which = ent / (kSeg * kMaxN),
            i = ent / kMaxN % kSeg, nn = ent % kMaxN;
  float* ws = which ? ws_c : ws_b;
  if (lane >= 16 || ws == nullptr || i >= p.len || nn >= n) return;
  const float* v = inbox + p.box * kSources * kShare + e;
  float sum = v[0];
#pragma unroll
  for (int r = 1; r < kSources; ++r) sum = __fadd_rn(sum, v[r * kShare]);
  ws[((row + p.t0 + i) * groups + grp) * n + nn] = sum;
}

// kDA: dA is asked for (its per-(b, d) sums kept and written).  VB: the
// staging's copy width, 16 or 4 bytes.
template <typename T, bool kDA, int VB>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, kMinBlocks) selective_scan_bwd_kernel(
        const float* __restrict__ dt, const T* __restrict__ x,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ h0,
        const T* __restrict__ gy, const float* __restrict__ gh,
        float* __restrict__ ddt, T* __restrict__ dx, float* __restrict__ ws_b,
        float* __restrict__ ws_c, float* __restrict__ ws_a,
        float* __restrict__ dh0, int s, int d, int n, int wsegs) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ckpt = reinterpret_cast<float4*>(smem + kStages * Seg<T>::kBytes);
  float* inbox = reinterpret_cast<float*>(ckpt + wsegs * kThreads);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = tid / kLanes, q = tid % kLanes, n0 = kSpl * q;
  const int b = blockIdx.y, d0 = blockIdx.x * kChannels, ch = d0 + c;
  const bool live = ch < d;
  const size_t row = static_cast<size_t>(b) * s;
  const size_t chn = (static_cast<size_t>(b) * d + ch) * n;   // [b, ch, :]
  const bool need_bc = ws_b != nullptr || ws_c != nullptr;
  const bool store_dx = live && q == 0 && dx != nullptr;
  const bool store_ddt = live && q == 0 && ddt != nullptr;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int groups = gridDim.x / kCluster, grp = blockIdx.x / kCluster;
  // This lane's warp sum (warp_channel_sum) is entry (which, step i,
  // state) of the segment, owned by rank 2 * which + i / 4 at share index
  // (i % 4) * 16 + state; it lands at this warp's source row there.
  const int which = (lane >> 4) & 1;
  float* const push_to[2] = {
      cluster.map_shared_rank(inbox, 2 * which) + (rank * kWarps + warp) *
          kShare + 4 * q + 2 * ((lane >> 3) & 1) + ((lane >> 2) & 1),
      cluster.map_shared_rank(inbox, 2 * which + 1) + (rank * kWarps + warp) *
          kShare + 4 * q + 2 * ((lane >> 3) & 1) + ((lane >> 2) & 1)};
  // The cluster barrier alternates arrive and wait.  The first arrive's
  // wait (every block has started, so its inbox exists) comes before the
  // first push; the arrive after each segment's pushes is waited on after
  // the next segment's adjoint, when the owners sum the segment.
  if (need_bc) repro::cluster_arrive_relaxed();
  bool started = false, armed = need_bc;   // armed: an arrive to wait on
  Pushed pend = {0, 0, 0};
  int box = 0;   // the inbox third the next reverse job pushes into

  float av[kSpl], lam[kSpl], da[kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    const bool ok = live && n0 + j < n;
    av[j] = ok ? decay_rate(a[static_cast<size_t>(ch) * n + n0 + j]) : 0.f;
    lam[j] = ok && gh != nullptr ? gh[chn + n0 + j] : 0.f;
    da[j] = 0.f;
  }

  const int win = wsegs * kSeg;
  for (int w = (s + win - 1) / win - 1; w >= 0; --w) {
    const int ws0 = w * win, wend = min(s, ws0 + win);
    const int segs = (wend - ws0 + kSeg - 1) / kSeg;
    const int first = ws0 / kSeg;          // the window's first segment
    const int nf = first + segs - 1;       // forward jobs (whole segments)
    const int jobs = nf + segs;
    // job j < nf: the forward over segment j; else the window's segment
    // segs - 1 - (j - nf), in reverse.  Job j stages into ring stage j %
    // kStages, kAhead jobs ahead of the one that runs.
    auto start = [&](int j) {
      return j < nf ? j * kSeg : ws0 + (segs - 1 - (j - nf)) * kSeg;
    };
    auto issue = [&](int j) {
      const int t0 = start(j);
      stage<VB>(Seg<T>(smem + (j % kStages) * Seg<T>::kBytes), dt, x, gy,
                bm, cm, row + t0, min(kSeg, s - t0), d, d0, n, j >= nf);
      repro::cp_async_commit();
    };

    float h[kSpl];
#pragma unroll
    for (int j = 0; j < kSpl; ++j)
      h[j] = live && n0 + j < n ? h0[chn + n0 + j] : 0.f;
    __syncthreads();                       // the last window's stages are read
#pragma unroll 1
    for (int j = 0; j < kAhead && j < jobs; ++j) issue(j);
    for (int j = 0; j < jobs; ++j) {
      wait_for_stage(min(kAhead - 1, jobs - 1 - j));
      // job j has landed for every thread, and every warp is done with
      // job j - 1, whose stage job j + kAhead takes
      __syncthreads();
      if (j + kAhead < jobs) issue(j + kAhead);
      const Seg<T> st(smem + (j % kStages) * Seg<T>::kBytes);
      const int t0 = start(j);

      if (j < nf) {                        // checkpoint pass
        if (j >= first)
          ckpt[(j - first) * kThreads + tid] =
              make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          const float dtv = st.dt[i * kChannels + c];
          const float dtx = __fmul_rn(dtv, to_f32(st.x[i * kChannels + c]));
          const float4 bv =
              *reinterpret_cast<const float4*>(st.b + i * kMaxN + n0);
          const float bq[kSpl] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int jj = 0; jj < kSpl; ++jj)
            h[jj] = update(decay(dtv, av[jj]), h[jj], dtx, bq[jj]);
        }
        continue;
      }

      const int k = segs - 1 - (j - nf), len = min(kSeg, wend - t0);
      if (k == segs - 1)
        ckpt[k * kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
      // the segment's states hs[i] = h_{t0+i-1}, recomputed (past len:
      // zero operands, so hs stays put)
      float hs[kSeg + 1][kSpl];
      const float4 c4 = ckpt[k * kThreads + tid];
      hs[0][0] = c4.x, hs[0][1] = c4.y, hs[0][2] = c4.z, hs[0][3] = c4.w;
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        const float dtv = st.dt[i * kChannels + c];
        const float dtx = __fmul_rn(dtv, to_f32(st.x[i * kChannels + c]));
        const float4 bv =
            *reinterpret_cast<const float4*>(st.b + i * kMaxN + n0);
        const float bq[kSpl] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int jj = 0; jj < kSpl; ++jj)
          hs[i + 1][jj] = update(decay(dtv, av[jj]), hs[i][jj], dtx, bq[jj]);
      }
      if (!started && need_bc) {
        repro::cluster_wait();             // every inbox exists
        started = true;
        armed = false;
      }
      // the adjoint, back over the segment (past len: zero operands, so
      // lam stays put and nothing is stored)
      float* const inbox_box = inbox + box * kSources * kShare;
#pragma unroll
      for (int i = kSeg - 1; i >= 0; --i) {
        const float dtv = st.dt[i * kChannels + c];
        const float xv = to_f32(st.x[i * kChannels + c]);
        const float gv = to_f32(st.gy[i * kChannels + c]);
        const float dtx = __fmul_rn(dtv, xv);
        const float4 bv =
            *reinterpret_cast<const float4*>(st.b + i * kMaxN + n0);
        const float4 cv =
            *reinterpret_cast<const float4*>(st.c + i * kMaxN + n0);
        const float bq[kSpl] = {bv.x, bv.y, bv.z, bv.w};
        const float cq[kSpl] = {cv.x, cv.y, cv.z, cv.w};
        float pb[kSpl], pc[kSpl];
        float sb = 0.f, sa = 0.f;
#pragma unroll
        for (int jj = 0; jj < kSpl; ++jj) {
          const float abar = decay(dtv, av[jj]);   // as recomputed
          lam[jj] = __fmaf_rn(gv, cq[jj], lam[jj]);
          pc[jj] = __fmul_rn(hs[i + 1][jj], gv);
          pb[jj] = __fmul_rn(lam[jj], dtx);
          sb = __fmaf_rn(lam[jj], bq[jj], sb);
          lam[jj] = __fmul_rn(lam[jj], abar);     // the next step's lam
          const float u = __fmul_rn(lam[jj], hs[i][jj]);
          sa = __fmaf_rn(av[jj], u, sa);
          if (kDA) da[jj] = __fmaf_rn(dtv, u, da[jj]);
        }
        sb = group_sum(sb);
        sa = group_sum(sa);
        const size_t g = (row + t0 + i) * d + ch;
        if (store_dx && i < len) dx[g] = from_f32<T>(__fmul_rn(dtv, sb));
        if (store_ddt && i < len)
          ddt[g] = __fmaf_rn(xv, sb, __fmul_rn(sa, kLn2));
        const float v = warp_channel_sum(pb, pc, lane);
        if (need_bc)
          push_to[i / 4][(inbox_box - inbox) + (i % 4) * kMaxN] = v;
      }
      if (!need_bc) continue;
      if (armed) {                         // the last segment's pushes
        repro::cluster_wait();
        owner_sum(inbox, pend, ws_b, ws_c, row, groups, grp, rank, n);
      }
      repro::cluster_arrive();             // this segment's pushes
      armed = true;
      pend = {box, t0, len};
      box = box + 1 == kBoxes ? 0 : box + 1;
    }
    if (armed && started) {                // the window's last segment
      repro::cluster_wait();
      owner_sum(inbox, pend, ws_b, ws_c, row, groups, grp, rank, n);
      armed = false;
    }
  }
  if (armed) repro::cluster_wait();        // S = 0: the first arrive

#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    if (!live || n0 + j >= n) continue;
    if (kDA) ws_a[chn + n0 + j] = da[j];
    if (dh0 != nullptr) dh0[chn + n0 + j] = lam[j];
  }
}

// dB and dC [B*S, N]: the sum of the G cluster partials of each (b, t, n),
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
  static_assert(kEntries % kCluster == 0, "every rank owns a share");
  const bool steps = batch > 0 && s > 0;   // dB and dC have elements
  if (n < 1 || n > kMaxN || window < kSeg || window % kSeg != 0 ||
      window > kMaxSlots * kSeg || (da != nullptr && ws_a == nullptr) ||
      (steps && ((db != nullptr && ws_b == nullptr) ||
                 (dc != nullptr && ws_c == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!steps) db = dc = nullptr;
  const int wsegs = window / kSeg;
  const int groups = (d + kGroup - 1) / kGroup;
  if (batch > 0 && groups > 0) {
    const bool vec =
        d % 8 == 0 && n % 4 == 0 &&
        (reinterpret_cast<uintptr_t>(dt) | reinterpret_cast<uintptr_t>(x) |
         reinterpret_cast<uintptr_t>(gy) | reinterpret_cast<uintptr_t>(bm) |
         reinterpret_cast<uintptr_t>(cm)) % 16 == 0;
    auto kernel =
        da != nullptr ? (vec ? selective_scan_bwd_kernel<T, true, 16>
                             : selective_scan_bwd_kernel<T, true, 4>)
                      : (vec ? selective_scan_bwd_kernel<T, false, 16>
                             : selective_scan_bwd_kernel<T, false, 4>);
    const int smem = smem_bytes<T>(wsegs);
    if (smem > 48 * 1024) {   // windows of 11 segments or more (f32; 13)
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<dim3(groups * kCluster, batch), kThreads, smem, stream>>>(
        dt, x, bm, cm, a, h0, gy, gh, ddt, dx, db ? ws_b : nullptr,
        dc ? ws_c : nullptr, da ? ws_a : nullptr, dh0, s, d, n, wsegs);
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
