// The tiled fused conv backward (paper §III.B, Fig. 5-6), one template for
// the f32 kernel B5 (conv2d.cu, repro_conv2d_bwd_fused), its bf16 instance
// (conv_bwd_bf16.cu, repro_conv2d_bwd_fused_bf16) and the int16 kernel B8
// (conv2d_fxp.cu, repro_conv2d_bwd_fused_fxp).
//
//   out[s, n] = gate_out(finish(conv(gate_in(unpool(g[s, n])), wt)))
//
// finish is the identity in f32 and bf16 (bf16 rounds at the store, after
// the epilogue gate) and the requantize to Q7.8 in int16 (before the
// epilogue gate, as src/repro/kernels/conv2d/fxp.py:119-125 does).
//
// Bound on an H100: multiply-adds on the CUDA cores (FFMA, or IMAD at half
// its rate: no TF32, no int16 MMA), counted on the nonzero gated inputs;
// the kernel is dense and also multiplies the zeros of the unpooled and
// gated gradient (3/4 of a pooled layer's inputs at least), which keeps the
// bits of the general kernel but leaves it several times above the bound.
//
// Design: the register-tiled implicit GEMM of conv2d.cu's forward
// (conv_igemm_kernel), with the S seeds of one image inside the block.  A
// block computes a th x 8 pixel tile of one image for tco output channels
// and a group of BS = SG x st seeds: st slices of threads, each thread with
// an SG x PX x 4 register micro-tile (PX pixels of one row x 4 channels, for
// SG = 1, 2 or 3 seeds).  For each (ci, kh) a thread reads the K float4
// (int16: 8-byte) weight rows of the tap once for its SG seeds, and per
// seed the row of PX + K - 1 gated inputs as float4s, reused across all K
// taps kw: for SG = 3, PX = 4, K = 3 that is 9 shared-memory loads per 144
// multiply-adds (the forward: 13 per 96).  Slices (st > 1) trade those
// loads for threads where a layer has too few outputs to fill the card
// with SG-seed tiles (Cout' = 3).  Each output stays one thread's chain
// over (ci, kh, kw), ci ascending, on the gated input, from 0: the order
// of conv_kernel and of the forward, so no plan (th, PX, tco, chunk, SG,
// st) changes a bit, and the f32 kernel equals conv_kernel<TCO, true> bit
// for bit.  No atomics.
//
// Ring: the (seed group, Cin chunk) pairs run through a two-stage ring of
// cp.async copies.  A stage holds the raw gradient of the chunk for the
// group's seeds (the landing buffer: for a pooled layer the Hg x Wg tile,
// about a quarter of the full-resolution halo) and the chunk's weight
// slice.  cp.async copies bytes and cannot gate, so each pair has a
// prologue step: between its two barriers the block expands the landing
// buffer into the compute buffer ([seed][ci][row][col], rows padded to a
// multiple of 4 words so a row segment is read as float4s): the unpool
// routing by the 2-bit crumb, then the Eq. 3-5 gate by the 1-bit mask,
// both read once per position and channel for all seeds of the group —
// the paper's mask reuse.  The next pair's copies are issued right after
// the pair's first barrier and land while it is expanded and summed.
// Shared memory does not grow with C: only the chunk is staged.  The
// weight slice of a chunk is staged once per seed group, so once in all
// where the group holds all S seeds (every launch of the main paths: S = 3
// seed-batched, S = 1 vjp).  A last group with fewer seeds than BS sums
// zeros for the missing ones and stores nothing for them.
//
// Copies: 16-, 8- or 4-byte cp.async where the channel count, the chunk and
// the pointer allow (halo, ragged edges and missing seeds zero-filled by
// the copy itself); otherwise ordinary loads, one element each: int16 rows
// with an odd channel count (C = 13, layer 0's wt [3,3,32,3]) or a
// misaligned view.  The int16 compute buffer holds the gated values widened
// to 32 bits, so the inner loop is the f32 one with IMAD (uint32_t: the sum
// wraps modulo 2^32 as the reference's int32 dot does) in place of FFMA;
// the landing buffer and the weights stay int16.
#pragma once

#include "common.cuh"

namespace {
namespace bwd {

constexpr int TW = 8;            // tile width in pixels
constexpr int MAX_THREADS = 256; // kernels/conv2d/conv2d.py mirrors both
constexpr int MAX_SEED_GROUP = 3;

template <typename T>
struct Args {
  const T* g;               // [S,N,Hg,Wg,C]
  const T* wt;              // [K,K,C,Cout]
  const uint8_t* pool_idx;  // [N,H/2,W/2,ceil(C/4)] or null (no pool)
  const uint8_t* mask;      // [N,H,W,ceil(C/8)] or null
  const uint8_t* omask;     // [N,H,W,ceil(Cout/8)] or null
  T* out;                   // [S,N,H,W,Cout]
  int s, n, h, wd, c, cout;  // h, wd: output (full-resolution) size
  int gate_in, gate_out, method;
  int th, tco, cin_t, st;   // the plan (PX and SG are template arguments)
  int gh, gw, lstride;      // landing grid, elements per landing position
  int xs_bytes, land_bytes, stage_bytes;
  int vb_g, vb_w, vec_y;    // bytes per copy (0: ordinary loads), 16/8-byte
                            // stores
};

// floor(v / 2) for negative v too (the halo's first row may be -P).
__device__ __forceinline__ int floor_half(int v) {
  return v >= 0 ? v / 2 : -((1 - v) / 2);
}

// Registers are not capped for residency (ptxas may give a thread up to
// 255): without the 1, ptxas held some SG = 1 instances to 128 registers and
// spilled.  The plans fill the card with blocks (128 to 256 of them).
template <typename T, int K, int PX, int SG>
__global__ void __launch_bounds__(MAX_THREADS, 1)
conv_bwd_igemm_kernel(Args<T> a) {
  using Tr = repro::Traits<T>;
  using W = typename Tr::Word;
  constexpr int P = (K - 1) / 2, XW = TW + K - 1, XWP = (XW + 3) / 4 * 4;
  constexpr int NX = PX + K - 1, NV = (NX + 3) / 4;  // row of inputs, float4s
  constexpr int GX = TW / PX;  // threads across one tile row
  extern __shared__ float4 bwd_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(bwd_smem4);
  W* xs = reinterpret_cast<W*>(smem);  // [BS][cin_t][XH][XWP], gated
  const int th = a.th, cin_t = a.cin_t, tco = a.tco;
  const int BS = SG * a.st;  // seeds of the block: st slices x SG a thread
  const int XH = th + K - 1, plane = XH * XWP, XHW = XH * XW;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int tpt = th * GX * (tco / 4);  // threads of one seed slice
  const int slice = tid / tpt, rest = tid - slice * tpt;
  const int cg = rest % (tco / 4), pg = rest / (tco / 4);
  const int ty = pg / GX, px0 = (pg % GX) * PX;
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
    return reinterpret_cast<T*>(smem + a.xs_bytes + st * a.stage_bytes);
  };
  auto wts_of = [&](int st) {
    return reinterpret_cast<T*>(smem + a.xs_bytes + st * a.stage_bytes +
                                a.land_bytes);
  };

  // Stage pair t (seeds [s0, s0 + BS), channels [c0, c0 + cn)) into
  // stage st: the raw gradient of the group's seeds, then the weight slice.
  auto load = [&](int st, int t) {
    const int s0 = t / nchunks * BS, c0 = t % nchunks * cin_t;
    const int cn = min(cin_t, a.c - c0);
    T* land = land_of(st);
    T* ws = wts_of(st);
    const int eg = a.vb_g ? a.vb_g / static_cast<int>(sizeof(T)) : 1;
    const int gu = cn / eg;  // copies per position (eg divides cn)
    // one landing row (seed, position) a thread: its gu copies in turn
    for (int r = tid; r < BS * npos; r += nthr) {
      const int sg = r / npos, pos = r - sg * npos, s = s0 + sg;
      const int gy = gy0 + pos / a.gw, gx = gx0 + pos % a.gw;
      const bool ok = s < a.s && gy >= 0 && gy < hg && gx >= 0 && gx < wg;
      const T* src =
          ok ? a.g + (static_cast<size_t>(s) * a.n + nn) * gimg +
                   (static_cast<size_t>(gy) * wg + gx) * a.c + c0
             : a.g;
      T* dst = land + r * a.lstride;
      for (int q = 0; q < gu; ++q)
        repro::stage_copy(dst + q * eg, ok ? src + q * eg : src, ok,
                          a.vb_g);
    }
    const int ew = a.vb_w ? a.vb_w / static_cast<int>(sizeof(T)) : 1;
    const int wu = tco / ew;  // copies per weight row (ew divides tco)
    for (int e = tid; e < K * K * cn * wu; e += nthr) {
      const int q = e % wu, r = e / wu, kk = r / cn, ci = r % cn;
      const int o = co0 + q * ew;
      const bool ok = o < a.cout;
      const T* src =
          ok ? a.wt + (static_cast<size_t>(kk) * a.c + c0 + ci) * a.cout + o
             : a.wt;
      repro::stage_copy(ws + (kk * cin_t + ci) * tco + q * ew, src, ok,
                        a.vb_w);
    }
    repro::cp_async_commit();
  };

  // The prologue of pair t: unpool and gate the landing buffer of stage st
  // into the compute buffer, four channels of one halo position a step;
  // each crumb and mask bit is read once for all BS seeds.
  auto expand = [&](int st, int t) {
    const int c0 = t % nchunks * cin_t, cn = min(cin_t, a.c - c0);
    const T* land = land_of(st);
    const int cb4 = (a.c + 3) / 4, cb8 = (a.c + 7) / 8;
    const int nq = (cn + 3) / 4;
    for (int e = tid; e < nq * XHW; e += nthr) {
      const int ci0 = e / XHW * 4, p = e % XHW, r = p / XW, col = p % XW;
      const int yy = y0 - P + r, xx = x0 - P + col;
      int gpos = -1;
      bool take[4] = {false, false, false, false}, bit[4] = {};
      if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd) {
        const size_t at = (static_cast<size_t>(nn) * a.h + yy) * a.wd + xx;
        const uint8_t* mrow = a.mask ? a.mask + at * cb8 : nullptr;
        const uint8_t* irow = nullptr;
        if (pooled) {
          irow = a.pool_idx +
                 ((static_cast<size_t>(nn) * hg + yy / 2) * wg + xx / 2) * cb4;
          gpos = (yy / 2 - gy0) * a.gw + xx / 2 - gx0;
        } else {
          gpos = r * a.gw + col;
        }
        const int c = c0 + ci0, quad = (yy & 1) * 2 + (xx & 1);
        if ((c & 3) == 0 && ci0 + 4 <= cn) {
          // four channels in one mask byte and one crumb byte
          const int mb = mrow ? mrow[c >> 3] >> (c & 7) : 0;
          const int cb = pooled ? irow[c >> 2] : 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            take[j] = !pooled || ((cb >> (2 * j)) & 3) == quad;
            bit[j] = (mb >> j) & 1;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (ci0 + j < cn) {
              take[j] = !pooled || repro::crumb(irow, c + j) == quad;
              bit[j] = repro::mask_bit(mrow, c + j);
            }
          }
        }
      }
      for (int sg = 0; sg < BS; ++sg) {
        const T* src = land + (sg * npos + max(gpos, 0)) * a.lstride + ci0;
        W* dst = xs + (sg * cin_t + ci0) * plane + r * XWP + col;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (ci0 + j < cn)
            dst[j * plane] =
                take[j] ? Tr::prologue(src[j], bit[j], a.gate_in, a.method)
                        : W(0);
        }
      }
    }
  };

  W acc[SG][PX][4];
#pragma unroll
  for (int sg = 0; sg < SG; ++sg)
#pragma unroll
    for (int p = 0; p < PX; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[sg][p][j] = W(0);

  if (npairs > 0) load(0, 0);
  for (int t = 0; t < npairs; ++t) {
    repro::cp_async_wait_all();
    // Pair t has landed, and every thread is done with pair t - 1: its
    // compute buffer and weight stage, and (since its second barrier) the
    // landing stage the next copies overwrite.
    __syncthreads();
    if (t + 1 < npairs) load((t + 1) & 1, t + 1);
    expand(t & 1, t);
    __syncthreads();
    const int cn = min(cin_t, a.c - t % nchunks * cin_t);
    const T* wt = wts_of(t & 1) + 4 * cg;
    const W* xt = xs + slice * SG * cin_t * plane + ty * XWP + px0;
#pragma unroll 1
    for (int ci = 0; ci < cn; ++ci) {
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        W wv[K][4];
#pragma unroll
        for (int kw = 0; kw < K; ++kw)
          Tr::weights4(wt + ((kh * K + kw) * cin_t + ci) * tco, wv[kw]);
#pragma unroll
        for (int sg = 0; sg < SG; ++sg) {
          W xr[4 * NV];
          const W* row = xt + (sg * cin_t + ci) * plane + kh * XWP;
#pragma unroll
          for (int v = 0; v < NV; ++v) Tr::words4(row + 4 * v, xr + 4 * v);
#pragma unroll
          for (int kw = 0; kw < K; ++kw)
#pragma unroll
            for (int p = 0; p < PX; ++p)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[sg][p][j] = Tr::mac(acc[sg][p][j], xr[p + kw], wv[kw][j]);
        }
      }
    }
    if (t % nchunks != nchunks - 1) continue;

    // Epilogue of the group: finish, gate by the previous layer's mask,
    // store; then start the next group from 0.
    const int yy = y0 + ty, o = co0 + 4 * cg;
    const int s0 = t / nchunks * BS + slice * SG;  // the thread's seeds
    if (yy < a.h && o < a.cout) {
      const int cb8o = (a.cout + 7) / 8;
#pragma unroll
      for (int sg = 0; sg < SG; ++sg) {
        if (s0 + sg >= a.s) break;
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const int xx = x0 + px0 + p;
          if (xx >= a.wd) break;
          const size_t at = (static_cast<size_t>(nn) * a.h + yy) * a.wd + xx;
          T* dst = a.out +
                   (static_cast<size_t>(s0 + sg) * a.n * a.h * a.wd + at) *
                       a.cout +
                   o;
          decltype(Tr::finish(acc[0][0][0])) r[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            r[j] = Tr::finish(acc[sg][p][j]);
            if (a.gate_out) {
              const uint8_t* orow = a.omask ? a.omask + at * cb8o : nullptr;
              r[j] = repro::gate(r[j], repro::mask_bit(orow, o + j), a.method);
            }
          }
          if (a.vec_y) {  // Cout a multiple of 4, out aligned
            Tr::store4(dst, r);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (o + j < a.cout) dst[j] = static_cast<T>(r[j]);
          }
        }
      }
    }
#pragma unroll
    for (int sg = 0; sg < SG; ++sg)
#pragma unroll
      for (int p = 0; p < PX; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[sg][p][j] = W(0);
  }
}

template <typename T, int K, int PX, int SG>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  static_assert(PX == 4 || SG == 1, "SG x 8 x 4 accumulators spill");
  const size_t smem =
      static_cast<size_t>(a.xs_bytes) + 2 * static_cast<size_t>(a.stage_bytes);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_bwd_igemm_kernel<T, K, PX, SG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = a.st * a.th * (TW / PX) * (a.tco / 4);
  const dim3 grid(((a.h + a.th - 1) / a.th) * ((a.wd + TW - 1) / TW),
                  (a.cout + a.tco - 1) / a.tco, a.n);
  conv_bwd_igemm_kernel<T, K, PX, SG><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// PX = 8 only with one seed a thread: ptxas spills 2 and 3 x 32
// accumulators (255 registers).
template <typename T, int K>
cudaError_t launch_px(const Args<T>& a, int px, int sg, cudaStream_t stream) {
  if (px == 8) return launch<T, K, 8, 1>(a, stream);
  switch (sg) {
    case 1: return launch<T, K, 4, 1>(a, stream);
    case 2: return launch<T, K, 4, 2>(a, stream);
    default: return launch<T, K, 4, 3>(a, stream);
  }
}

// The tile plan of kernels/conv2d/conv2d.py conv_bwd_plan (k in {1,3,5,7}):
// check it, lay out shared memory as ConvBwdPlan.smem_bytes does, choose
// the copy widths, launch.
template <typename T>
cudaError_t launch_tiled(Args<T> a, int k, int px, int sg,
                         cudaStream_t stream) {
  const int threads = a.st * a.th * (px > 0 ? TW / px : 0) * (a.tco / 4);
  if ((px != 4 && px != 8) || sg < 1 || sg > MAX_SEED_GROUP ||
      (px == 8 && sg != 1) || a.st < 1 || a.tco < 4 || a.tco % 4 != 0 ||
      a.th < 1 || a.cin_t < 1 || threads > MAX_THREADS)
    return cudaErrorInvalidValue;
  const int xh = a.th + k - 1, xw = TW + k - 1;
  const bool pooled = a.pool_idx != nullptr;
  a.gh = pooled ? xh / 2 + 1 : xh;
  a.gw = pooled ? xw / 2 + 1 : xw;
  const int unit = 16 / static_cast<int>(sizeof(T));
  a.lstride = (a.cin_t + unit - 1) / unit * unit + unit;
  const int bs = sg * a.st;
  a.xs_bytes = 4 * bs * a.cin_t * xh * ((xw + 3) / 4 * 4);
  a.land_bytes = static_cast<int>(sizeof(T)) * bs * a.gh * a.gw * a.lstride;
  const int wbytes = static_cast<int>(sizeof(T)) * k * k * a.cin_t * a.tco;
  a.stage_bytes = a.land_bytes + (wbytes + 15) / 16 * 16;
  a.vb_g = repro::copy_bytes<T>(a.g, a.c, a.cin_t);
  a.vb_w = repro::copy_bytes<T>(a.wt, a.cout, a.tco);
  a.vec_y = a.cout % 4 == 0 &&
            reinterpret_cast<uintptr_t>(a.out) % (4 * sizeof(T)) == 0;
  switch (k) {
    case 1: return launch_px<T, 1>(a, px, sg, stream);
    case 3: return launch_px<T, 3>(a, px, sg, stream);
    case 5: return launch_px<T, 5>(a, px, sg, stream);
    default: return launch_px<T, 7>(a, px, sg, stream);
  }
}

}  // namespace bwd
}  // namespace
