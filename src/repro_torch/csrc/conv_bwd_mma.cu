// The bf16 fused conv backward on the tensor cores (B5 in bf16 where C is a
// multiple of 16), called by repro_conv2d_bwd_fused_bf16 (conv_bwd_bf16.cu)
// for the plans kernels/conv2d/conv2d.py conv_bwd_bf16_plan gives such
// layers (ConvBwdMmaPlan).
//
// Replaces: src/repro/kernels/conv2d/conv2d.py, conv2d_bwd_fused_pallas on
// a bf16 gradient (the JAX package's precision="bf16" path):
//
//   out[s, n] = bf16(gate_out(conv(gate_in(unpool(g[s, n])), wt)))
//
// The unpool and the Eq. 3-5 gate select bf16 values (exact); the products
// are summed in f32; the epilogue gate acts on the f32 sum, and the result
// is rounded to nearest even once, at the store, as the reference gates its
// f32 accumulator before .astype(bf16) (conv2d.py:143-146).
//
// Bound on an H100: bytes.  The four Table III launches of a seed-batched
// explain (S = 3, N = 32) move 23.3 MB, 7.0 us at 3.35 TB/s; their 4.70
// GFLOP take 4.8 us at the 989 TFLOP/s of the bf16 tensor cores (6.4 us
// with layer 0's three output channels padded to 8), but 70 us at the
// 67 TFLOP/s of FFMA, which is where the f32 template's bf16 instance
// (conv_bwd.cuh conv_bwd_igemm_kernel<__nv_bfloat16>, route 0) stays.  So
// the products run on mma.sync.m16n8k16 (bf16 in, f32 sums), as the
// forward's conv_fwd_mma.cu does.
//
// Design: the backward is a SAME conv of the gated gradient with the
// flip-transposed weight wt [K, K, C, Cout'], so this is conv_fwd_mma.cu's
// implicit GEMM with a prologue.  A block computes a th x 16 pixel tile of
// one image for tco output channels (8: one n8 fragment, for Cout' <= 8;
// else a multiple of 32) and a group of BS = sg x st seeds; a warp holds
// mt rows x sg seeds (MF = sg x mt m16 fragments, a row of 16 pixels of one
// seed each) x 8 NT channels, so it loads each k step's B fragments (the
// weights) once for all its seeds and rows.  A k step is one tap (kh, kw)
// over 16 channels: A by ldmatrix from the compute buffer at (y + kh,
// x + kw), B by ldmatrix.trans from the [kh, kw][c][co] weight stage.
//
// Ring and prologue, as conv_bwd.cuh's: the (seed group, C chunk) pairs run
// through a two-stage ring of cp.async copies (one stage where a launch has
// one pair, as every Table III launch does).  A stage holds the raw
// gradient of the chunk for the group's seeds (the landing buffer; pooled:
// the Hg x Wg quarter of the halo tile), the chunk's weight slice, and the
// chunk's residual bytes: the mask bytes of each halo position and, pooled,
// the crumb bytes of each landing position, so the prologue reads no
// global memory.  Copies no wider than an element (layer 0's weight rows
// of Cout' = 3, misaligned views) go as ordinary loads, eight a thread in
// flight.  cp.async cannot gate, so between the pair's two barriers the
// block expands the landing buffer into the compute buffer, bf16 NHWC
// [seed][row][col][cin_t + 8], eight channels of a position a step: the
// unpool by the 2-bit crumbs, the gate by the 1-bit mask, both read once
// per position and 8 channels for all seeds of the group (the paper's
// mask reuse), 16 bytes in and out per seed (repro::gate8).  Unpooled, the
// compute buffer is the landing buffer itself, gated in place.  Position
// and weight rows are padded to an odd number of 16-byte units, so an
// ldmatrix's 8 rows fall in distinct banks.  Halo, ragged edges, missing
// seeds and weight columns past Cout' are zero-filled.  Where Cout' is a
// multiple of 8 the results go out through a tile in shared memory, a
// pixel's channels as 16-byte stores.
//
// What bounds it at the Table III shapes: neither the bytes nor the tensor
// cores.  A block's phases (issuing the copies, the prologue, the
// products, the epilogue) run one after another, at one or two blocks an
// SM (up to 255 registers a thread at 3 seeds x 4 n8 fragments a warp),
// and each is bound by the latency of its own instructions;
// tools/conv_bwd_phases.py prints their cycles (PERF.md §6).

// Fixed K order, as in conv_fwd_mma.cu: each output walks the 16-channel
// groups in order, and within a group the taps in order; a group's
// products go into a fresh accumulator that is then added to the running
// f32 sum, so the tensor cores' own accumulation never spans more than one
// group, and since a chunk holds whole groups, no plan changes a bit.  The
// FFMA instance sums in another order: the two routes agree within one
// bf16 rounding step, not bitwise.  No split of K, no atomics.

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {
namespace cbm {

using T = __nv_bfloat16;

constexpr int TW = 16;            // pixels of a tile row: one m16 fragment
constexpr int MAX_THREADS = 256;  // kernels/conv2d/conv2d.py mirrors these
constexpr int MAX_SEED_GROUP = 3;
constexpr int MAX_FRAGS = 3;      // m16 fragments a warp (sg x mt)

struct Args {
  const T* g;               // [S,N,Hg,Wg,C]
  const T* wt;              // [K,K,C,Cout]
  const uint8_t* pool_idx;  // [N,H/2,W/2,ceil(C/4)] or null (no pool)
  const uint8_t* mask;      // [N,H,W,ceil(C/8)] or null
  const uint8_t* omask;     // [N,H,W,ceil(Cout/8)] or null
  T* out;                   // [S,N,H,W,Cout]
  int s, n, h, wd, c, cout;  // h, wd: the output (full-resolution) size
  int gate_in, gate_out, method;
  int th, mt, tco, cin_t, sg, st;  // the plan
  int gh, gw;               // landing grid (pooled: the quarter tile)
  int xstride, wstride;     // elements per staged position, weight row
  int xs_elems;             // the pooled layers' compute buffer, else 0
  int land_elems, w_elems, stage_elems;
  int mstride, cstride;     // staged mask / crumb bytes per position
  int crumb_off;            // bytes from a stage's mask bytes to its crumbs
  int vb_g, vb_w, vec_y;    // bytes per copy (0: ordinary loads),
                            // 16-byte output stores
  int vb_m, vb_c;           // bytes per mask / crumb copy (0: byte loads)
  int wcols;                // weight columns copied a row by element loads
  // the loops' divisors: landing copies a position, landing positions, the
  // landing grid's width, weight copies a row, cin_t, mask and crumb
  // copies a position, 8-channel groups a chunk
  repro::FastDiv fd_gu, fd_npos, fd_gw, fd_wu, fd_cin_t, fd_mu, fd_cu, fd_nq;
  repro::FastDiv fd_per, fd_th;  // the output copy's stores a pixel; th
};

template <typename U>
struct Copy {
  U* dst;
  const U* src;
  bool ok;  // false: zero-fill
};

// The copies e in [0, n) that at(e) describes: VB bytes each by cp.async,
// or (VB = 0) one element each by ordinary loads, eight a thread in flight
// before their stores (Cout' = 3 weight rows, misaligned views).
template <int VB, typename F>
__device__ __forceinline__ void copy_all(int n, int tid, int nthr, F&& at) {
  if constexpr (VB > 0) {
    for (int e = tid; e < n; e += nthr) {
      const auto c = at(e);
      repro::cp_async<VB>(c.dst, c.src, c.ok);
    }
  } else {
    using U = std::remove_const_t<std::remove_pointer_t<decltype(at(0).src)>>;
    for (int e0 = tid; e0 < n; e0 += 8 * nthr) {
      U v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * nthr;
        if (e < n) {
          const auto c = at(e);
          v[u] = c.ok ? *c.src : U(0);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * nthr;
        if (e < n) *at(e).dst = v[u];
      }
    }
  }
}

// floor(v / 2) for negative v too (the halo's first row may be -P).
__device__ __forceinline__ int floor_half(int v) {
  return v >= 0 ? v / 2 : -((1 - v) / 2);
}

// One n8 fragment a warp (Cout' <= 8) leaves few accumulators: such blocks
// are held to half the SM's registers, so two reside (Table III's layer 0
// runs its 256 blocks in one wave).
template <int K, int MF, int NT>
__global__ void __launch_bounds__(MAX_THREADS, NT == 1 ? 2 : 1)
    conv_bwd_mma_kernel(Args a) {
  constexpr int P = (K - 1) / 2, XW = TW + K - 1, WN = 8 * NT;
  extern __shared__ float4 cbm_smem4[];
  T* smem = reinterpret_cast<T*>(cbm_smem4);
  const int th = a.th, mt = a.mt, tco = a.tco, cin_t = a.cin_t;
  const int xstride = a.xstride, wstride = a.wstride;
  const int XH = th + K - 1, npx = XH * XW;  // positions of the halo tile
  const int BS = a.sg * a.st;                // seeds of the block
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wrows = th / mt, wcols = tco / WN;
  const int wr = warp % wrows, wc = warp / wrows % wcols;
  const int ws = warp / (wrows * wcols);     // the warp's seed slice
  const int tiles_w = (a.wd + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * th;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * tco, nn = blockIdx.z;
  const bool pooled = a.pool_idx != nullptr;
  const int hg = pooled ? a.h / 2 : a.h, wg = pooled ? a.wd / 2 : a.wd;
  const int gy0 = pooled ? floor_half(y0 - P) : y0 - P;
  const int gx0 = pooled ? floor_half(x0 - P) : x0 - P;
  const int npos = a.gh * a.gw;
  const size_t gimg = static_cast<size_t>(hg) * wg * a.c;
  const int nchunks = (a.c + cin_t - 1) / cin_t;
  const int npairs = (a.s + BS - 1) / BS * nchunks;

  auto land_of = [&](int st) {
    return smem + a.xs_elems + st * a.stage_elems;
  };
  // pooled: [BS][XH][XW][xstride] before the ring; unpooled: the landing
  // buffer of the stage, gated in place
  auto xs_of = [&](int st) { return pooled ? smem : land_of(st); };

  // The residual bytes of stage st: mask bytes [npx][mstride], then crumb
  // bytes [npos][cstride].
  auto res_of = [&](int st) {
    return reinterpret_cast<uint8_t*>(land_of(st) + a.land_elems +
                                      a.w_elems);
  };

  // Stage pair t (seeds [s0, s0 + BS), channels [c0, c0 + cn)) into stage
  // st: the raw gradient of the group's seeds, the weight slice, then the
  // chunk's mask and crumb bytes.  Each loop walks whole cin_t-channel
  // rows (a short last chunk's rows past cn are zero-filled and never
  // read), so its divisors are fixed for the launch (repro::FastDiv).  A
  // copy's element count divides C and the chunk (Cout' and tco; the
  // residual rows and their chunk), so a copy is wholly inside or wholly
  // zero-filled.
  auto load = [&](int st, int t) {
    const int s0 = t / nchunks * BS, c0 = t % nchunks * cin_t;
    const int cn = min(cin_t, a.c - c0);
    T* land = land_of(st);
    T* wsg = land + a.land_elems;
    uint8_t* mk = res_of(st);
    repro::with_copy_bytes(a.vb_g, [&](auto vg) {
      constexpr int VB = decltype(vg)::value;
      constexpr int E = VB ? VB / static_cast<int>(sizeof(T)) : 1;
      copy_all<VB>(BS * npos * (cin_t / E), tid, nthr, [&](int e) {
        const int r = a.fd_gu.div(e), q = e - r * (cin_t / E);
        const int sl = a.fd_npos.div(r), pos = r - sl * npos, s = s0 + sl;
        const int gyo = a.fd_gw.div(pos), gy = gy0 + gyo;
        const int gx = gx0 + pos - gyo * a.gw;
        const bool ok = s < a.s && gy >= 0 && gy < hg && gx >= 0 &&
                        gx < wg && q * E < cn;
        return Copy<T>{land + r * xstride + q * E,
                       ok ? a.g + (static_cast<size_t>(s) * a.n + nn) * gimg +
                                (static_cast<size_t>(gy) * wg + gx) * a.c +
                                c0 + q * E
                          : a.g,
                       ok};
      });
    });
    repro::with_copy_bytes(a.vb_w, [&](auto vw) {
      constexpr int VB = decltype(vw)::value;
      constexpr int E = VB ? VB / static_cast<int>(sizeof(T)) : 1;
      // element loads (Cout' = 3) copy the wcols real columns of a row and
      // store zeros past them; copies of VB bytes zero-fill themselves
      const int wu = VB ? tco / E : a.wcols;
      copy_all<VB>(K * K * cin_t * wu, tid, nthr, [&](int e) {
        const int r = a.fd_wu.div(e), q = e - r * wu;
        const int kk = a.fd_cin_t.div(r), ci = r - kk * cin_t;
        const int o = co0 + q * E;
        const bool ok = o < a.cout && ci < cn;
        return Copy<T>{
            wsg + r * wstride + q * E,
            ok ? a.wt + (static_cast<size_t>(kk) * a.c + c0 + ci) * a.cout + o
               : a.wt,
            ok};
      });
      if constexpr (VB == 0) {
        const int zc = tco - a.wcols;
        for (int e = tid; e < K * K * cin_t * zc; e += nthr) {
          const int r = e / zc;
          wsg[r * wstride + a.wcols + e - r * zc] = T(0);
        }
      }
    });
    if (a.mask) {
      const int cb8 = (a.c + 7) / 8;
      repro::with_copy_bytes(a.vb_m, [&](auto vm) {
        constexpr int VB = decltype(vm)::value;
        constexpr int E = VB ? VB : 1;
        copy_all<VB>(npx * (a.mstride / E), tid, nthr, [&](int e) {
          const int p = a.fd_mu.div(e), q = e - p * (a.mstride / E);
          const int r = p / XW;
          const int yy = y0 - P + r, xx = x0 - P + p - r * XW;
          const bool ok = yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd &&
                          q * E < cn / 8;
          return Copy<uint8_t>{
              mk + p * a.mstride + q * E,
              ok ? a.mask +
                       ((static_cast<size_t>(nn) * a.h + yy) * a.wd + xx) *
                           cb8 +
                       c0 / 8 + q * E
                 : a.mask,
              ok};
        });
      });
    }
    if (pooled) {
      const int cb4 = (a.c + 3) / 4;
      repro::with_copy_bytes(a.vb_c, [&](auto vc) {
        constexpr int VB = decltype(vc)::value;
        constexpr int E = VB ? VB : 1;
        copy_all<VB>(npos * (a.cstride / E), tid, nthr, [&](int e) {
          const int pos = a.fd_cu.div(e), q = e - pos * (a.cstride / E);
          const int gyo = a.fd_gw.div(pos), gy = gy0 + gyo;
          const int gx = gx0 + pos - gyo * a.gw;
          const bool ok = gy >= 0 && gy < hg && gx >= 0 && gx < wg &&
                          q * E < cn / 4;
          return Copy<uint8_t>{
              mk + a.crumb_off + pos * a.cstride + q * E,
              ok ? a.pool_idx +
                       ((static_cast<size_t>(nn) * hg + gy) * wg + gx) * cb4 +
                       c0 / 4 + q * E
                 : a.pool_idx,
              ok};
        });
      });
    }
    repro::cp_async_commit();
  };

  // The prologue of pair t: unpool and gate the landing buffer of stage st
  // into the compute buffer, eight channels of one halo position a step;
  // the staged crumbs and mask byte are read once for all BS seeds.
  const unsigned rule_bits =
      a.gate_in && a.method != repro::kDeconvnet ? 0u : 0xffu;
  const bool positive = a.gate_in && a.method != repro::kSaliency;
  auto expand = [&](int st, int t) {
    const int nq = min(cin_t, a.c - t % nchunks * cin_t) / 8;
    const T* land = land_of(st);
    T* xs = xs_of(st);
    const uint8_t* mk = res_of(st);
    for (int e = tid; e < npx * (cin_t / 8); e += nthr) {
      const int p = a.fd_nq.div(e), q = e - p * (cin_t / 8);
      if (q >= nq) continue;  // past a short last chunk: never read
      const int r = p / XW, col = p - r * XW;
      const int yy = y0 - P + r, xx = x0 - P + col;
      unsigned keep = 0;
      int gpos = p;
      if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd) {
        keep = rule_bits | (a.mask ? mk[p * a.mstride + q] : 0u);
        if (pooled) {
          gpos = (yy / 2 - gy0) * a.gw + xx / 2 - gx0;
          const uint8_t* ib = mk + a.crumb_off + gpos * a.cstride + 2 * q;
          // crumb j (2 bits) equals the position's quadrant where the XOR
          // with the quadrant in every crumb leaves 0: bit 2j of `hit`
          const unsigned x = (ib[0] | static_cast<unsigned>(ib[1]) << 8) ^
                             (((yy & 1) * 2 + (xx & 1)) * 0x5555u);
          const unsigned hit = ~(x | x >> 1) & 0x5555u;
          unsigned take = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) take |= ((hit >> (2 * j)) & 1) << j;
          keep &= take;
        }
      }
      for (int sl = 0; sl < BS; ++sl) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (keep)
          v = repro::gate8(*reinterpret_cast<const uint4*>(
                               land + (sl * npos + gpos) * xstride + 8 * q),
                           keep, positive);
        *reinterpret_cast<uint4*>(xs + (sl * npx + p) * xstride + 8 * q) = v;
      }
    }
  };

  float run[MF][NT][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) run[f][j][q] = 0.f;

  // The warp's fragments: fragment f is tile row wr * mt + f % mt of seed
  // ws * sg + f / mt of the group.
  int frag[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f)
    frag[f] = ((ws * a.sg + f / mt) * XH + wr * mt + f % mt) * XW * xstride;
  // This lane's ldmatrix rows, as in conv_fwd_mma.cu: A, pixel lane % 16
  // at channel 8 * (lane / 16); B, k row (lane % 8) + 8 * (lane / 8 % 2)
  // at column 8 * (lane / 16) of the warp's (NT = 1: lanes 16-31 unread).
  const int a_off = (lane & 15) * xstride + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * wstride +
                    wc * WN + (NT > 1 ? (lane >> 4) * 8 : 0);

  if (npairs > 0) load(0, 0);
  for (int t = 0; t < npairs; ++t) {
    repro::cp_async_wait_all();
    // Pair t has landed, and every thread is done with pair t - 1: its
    // compute buffer and (since its second barrier) the stage the next
    // copies overwrite.
    __syncthreads();
    if (t + 1 < npairs) load((t + 1) & 1, t + 1);
    expand(t & 1, t);
    __syncthreads();
    const int groups = min(cin_t, a.c - t % nchunks * cin_t) / 16;
    const T* xs = xs_of(t & 1);
    const T* wsg = land_of(t & 1) + a.land_elems;
#pragma unroll 1
    for (int gi = 0; gi < groups; ++gi) {
      float acc[MF][NT][4];
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[f][j][q] = 0.f;
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          uint32_t af[MF][4];
#pragma unroll
          for (int f = 0; f < MF; ++f)
            repro::ldmatrix_x4(af[f], xs + frag[f] +
                                          (kh * XW + kw) * xstride +
                                          gi * 16 + a_off);
          const T* wb =
              wsg + ((kh * K + kw) * cin_t + gi * 16) * wstride + b_off;
          uint32_t bf[NT][2];
          if constexpr (NT == 1) {
            repro::ldmatrix_x2_trans(bf[0], wb);
          } else {
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
              uint32_t b4[4];
              repro::ldmatrix_x4_trans(b4, wb + 8 * j);
              bf[j][0] = b4[0], bf[j][1] = b4[1];
              bf[j + 1][0] = b4[2], bf[j + 1][1] = b4[3];
            }
          }
#pragma unroll
          for (int f = 0; f < MF; ++f)
#pragma unroll
            for (int j = 0; j < NT; ++j)
              repro::mma_bf16(acc[f][j], af[f], bf[j][0], bf[j][1]);
        }
      }
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) run[f][j][q] += acc[f][j][q];
    }
    if (t % nchunks != nchunks - 1) continue;

    // Epilogue of the seed group: gate the f32 sums by the previous layer's
    // mask and round once; where Cout' is a multiple of 8, write the bf16
    // results into an output tile [BS][th][16][wstride] in the stage just
    // consumed and copy it out, a pixel's tco channels as 16-byte stores,
    // else store them straight from the fragments; then start the next
    // group from 0.  D rows lane / 4 and lane / 4 + 8 are pixels of the
    // fragment's row, columns 2 * (lane % 4) and the next two channels of
    // each n8 tile.
    const int sgrp = t / nchunks * BS, cb8o = (a.cout + 7) / 8;
    const size_t plane = static_cast<size_t>(a.n) * a.h * a.wd;
    T* ot = land_of(t & 1);
    if (a.vec_y) __syncthreads();  // every warp is done with the stage
#pragma unroll
    for (int f = 0; f < MF; ++f) {
      const int sl = ws * a.sg + f / mt, rr = wr * mt + f % mt;
      const int s = sgrp + sl, yy = y0 + rr;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = (lane >> 2) + 8 * half, xx = x0 + px;
        const bool in = s < a.s && yy < a.h && xx < a.wd;
        const size_t at =
            (static_cast<size_t>(nn) * a.h + min(yy, a.h - 1)) * a.wd +
            min(xx, a.wd - 1);
        const uint8_t* orow = a.omask ? a.omask + at * cb8o : nullptr;
        T* dst = a.out + (s * plane + at) * a.cout;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int oc = wc * WN + 8 * j + 2 * (lane & 3), o = co0 + oc;
          float v0 = run[f][j][2 * half], v1 = run[f][j][2 * half + 1];
          if (a.gate_out) {
            if (o < a.cout)
              v0 = repro::gate(v0, repro::mask_bit(orow, o), a.method);
            if (o + 1 < a.cout)
              v1 = repro::gate(v1, repro::mask_bit(orow, o + 1), a.method);
          }
          if (a.vec_y) {
            *reinterpret_cast<uint32_t*>(
                ot + ((sl * th + rr) * TW + px) * wstride + oc) =
                repro::bf16_pack(v0, v1);
          } else if (in) {  // one or two elements straight to the output
            if (o < a.cout) dst[o] = __float2bfloat16_rn(v0);
            if (o + 1 < a.cout) dst[o + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
    if (a.vec_y) {  // Cout' a multiple of 8, out 16-byte aligned
      __syncthreads();
      for (int e = tid; e < BS * th * TW * (tco / 8); e += nthr) {
        const int pix = a.fd_per.div(e), oc = 8 * (e - pix * (tco / 8));
        const int px = pix % TW, rest = pix / TW;  // rest = sl * th + rr
        const int sl = a.fd_th.div(rest), rr = rest - sl * th;
        const int s = sgrp + sl, yy = y0 + rr, xx = x0 + px, o = co0 + oc;
        if (s >= a.s || yy >= a.h || xx >= a.wd || o >= a.cout) continue;
        *reinterpret_cast<uint4*>(
            a.out + (s * plane + (static_cast<size_t>(nn) * a.h + yy) *
                                     a.wd + xx) * a.cout + o) =
            *reinterpret_cast<const uint4*>(
                ot + ((sl * th + rr) * TW + px) * wstride + oc);
      }
    }
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) run[f][j][q] = 0.f;
  }
}

template <int K, int MF, int NT>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  // all of the SM's unified memory as shared memory, so as many blocks
  // reside as their registers and shared memory allow
  cudaError_t e = cudaFuncSetAttribute(
      conv_bwd_mma_kernel<K, MF, NT>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(conv_bwd_mma_kernel<K, MF, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(((a.h + a.th - 1) / a.th) * ((a.wd + TW - 1) / TW),
                  (a.cout + a.tco - 1) / a.tco, a.n);
  const int threads = 32 * (a.th / a.mt) * (a.tco / (8 * NT)) * a.st;
  conv_bwd_mma_kernel<K, MF, NT><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int K, int NT>
cudaError_t launch_mf(const Args& a, size_t smem, cudaStream_t stream) {
  switch (a.sg * a.mt) {
    case 1: return launch<K, 1, NT>(a, smem, stream);
    case 2: return launch<K, 2, NT>(a, smem, stream);
    default: return launch<K, 3, NT>(a, smem, stream);
  }
}

template <int K>
cudaError_t launch_nt(const Args& a, size_t smem, cudaStream_t stream) {
  return a.tco == 8 ? launch_mf<K, 1>(a, smem, stream)
                    : launch_mf<K, 4>(a, smem, stream);
}

}  // namespace cbm
}  // namespace

namespace repro {

// Check the plan (ConvBwdMmaPlan's rules), lay out shared memory as
// ConvBwdMmaPlan.smem_bytes does, choose the copy widths, launch.
cudaError_t conv_bwd_mma_bf16(const __nv_bfloat16* g, const __nv_bfloat16* wt,
                              const uint8_t* pool_idx, const uint8_t* mask,
                              const uint8_t* omask, __nv_bfloat16* out, int s,
                              int n, int h, int wd, int c, int cout, int k,
                              int gate_in, int gate_out, int method, int th,
                              int mt, int tco, int cin_t, int sg, int st,
                              cudaStream_t stream) {
  using cbm::T;
  const int wn = tco == 8 ? 8 : 32;
  if ((k != 1 && k != 3 && k != 5 && k != 7) || c < 16 || c % 16 != 0 ||
      cin_t < 16 || cin_t % 16 != 0 || sg < 1 || sg > cbm::MAX_SEED_GROUP ||
      st < 1 || mt < 1 || sg * mt > cbm::MAX_FRAGS || th < mt ||
      th % mt != 0 || (tco != 8 && (tco < 32 || tco % 32 != 0)) ||
      32 * (th / mt) * (tco / wn) * st > cbm::MAX_THREADS || s < 1 || n < 1 ||
      (pool_idx != nullptr && (h % 2 != 0 || wd % 2 != 0)))
    return cudaErrorInvalidValue;
  cbm::Args a{};
  a.g = g;
  a.wt = wt;
  a.pool_idx = pool_idx;
  a.mask = mask;
  a.omask = omask;
  a.out = out;
  a.s = s;
  a.n = n;
  a.h = h;
  a.wd = wd;
  a.c = c;
  a.cout = cout;
  a.gate_in = gate_in;
  a.gate_out = gate_out;
  a.method = method;
  a.th = th;
  a.mt = mt;
  a.tco = tco;
  a.cin_t = cin_t;
  a.sg = sg;
  a.st = st;
  const int xh = th + k - 1, xw = cbm::TW + k - 1, bs = sg * st;
  const bool pooled = pool_idx != nullptr;
  a.gh = pooled ? xh / 2 + 1 : xh;
  a.gw = pooled ? xw / 2 + 1 : xw;
  // rows of an odd number of 16-byte units: cin_t + 8, and tco rounded up
  // to an odd number of n8 columns
  a.xstride = cin_t + 8;
  a.wstride = 8 * ((tco / 8) | 1);
  a.xs_elems = pooled ? bs * xh * xw * a.xstride : 0;
  a.land_elems = bs * a.gh * a.gw * a.xstride;
  a.w_elems = k * k * cin_t * a.wstride;
  // residual bytes, each part rounded up to 16: the mask bytes of the xh x
  // xw halo positions, then (pooled) the crumb bytes of the landing grid
  a.mstride = cin_t / 8;
  a.cstride = cin_t / 4;
  a.crumb_off = (xh * xw * a.mstride + 15) / 16 * 16;
  const int res_bytes =
      a.crumb_off +
      (pooled ? (a.gh * a.gw * a.cstride + 15) / 16 * 16 : 0);
  // a stage also holds a group's output tile [bs][th][16][wstride] once
  // its products are summed
  a.stage_elems = std::max(a.land_elems + a.w_elems +
                          res_bytes / static_cast<int>(sizeof(T)),
                      bs * th * cbm::TW * a.wstride);
  const long long pairs =
      static_cast<long long>((s + bs - 1) / bs) * ((c + cin_t - 1) / cin_t);
  const size_t smem =
      sizeof(T) * (static_cast<size_t>(a.xs_elems) +
                   (pairs > 1 ? 2 : 1) * static_cast<size_t>(a.stage_elems));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  a.vb_g = copy_bytes<T>(g, c, cin_t);
  a.vb_w = copy_bytes<T>(wt, cout, tco);
  a.vec_y = cout % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  a.vb_m = copy_bytes<uint8_t>(mask, (c + 7) / 8, a.mstride);
  a.vb_c = copy_bytes<uint8_t>(pool_idx, (c + 3) / 4, a.cstride);
  const int elem = static_cast<int>(sizeof(T));
  a.fd_gu = FastDiv(cin_t / (a.vb_g ? a.vb_g / elem : 1));
  a.fd_npos = FastDiv(a.gh * a.gw);
  a.fd_gw = FastDiv(a.gw);
  // element loads copy only the columns below Cout' of a single column
  // tile (Table III's layer 0: 3 of 8)
  a.wcols = cout < tco ? cout : tco;
  a.fd_wu = FastDiv(a.vb_w ? tco / (a.vb_w / elem) : a.wcols);
  a.fd_cin_t = FastDiv(cin_t);
  a.fd_mu = FastDiv(a.mstride / (a.vb_m ? a.vb_m : 1));
  a.fd_cu = FastDiv(a.cstride / (a.vb_c ? a.vb_c : 1));
  a.fd_nq = FastDiv(cin_t / 8);
  a.fd_per = FastDiv(tco / 8);
  a.fd_th = FastDiv(th);
  switch (k) {
    case 1: return cbm::launch_nt<1>(a, smem, stream);
    case 3: return cbm::launch_nt<3>(a, smem, stream);
    case 5: return cbm::launch_nt<5>(a, smem, stream);
    default: return cbm::launch_nt<7>(a, smem, stream);
  }
}

}  // namespace repro
