// The tiled conv forward (paper §III.B and §IV), one template for the f32
// kernel B1 (instantiated in conv2d.cu for repro_conv2d_fwd), its bf16
// instance (conv_fwd_bf16.cu, repro_conv2d_fwd_bf16) and the int16 kernel
// B7 (instantiated in conv_fwd_i16.cu for conv2d_fxp.cu's
// repro_conv2d_fxp_fwd), NHWC x HWIO, stride 1, SAME.
//
//   y[n] = add_bias(finish(conv(x[n], w)), b)
//
// finish is the identity in f32 and bf16 and the requantize to Q7.8 in
// int16; the bias is added in f32, after the rounding in bf16 (the
// reference's conv2d_pallas(x, w) + b on a bf16 output), and with
// saturation in int16 (the reference's sat_add(conv2d_fxp_pallas(x, w), b)).
//
// Bound on an H100: multiply-adds on the CUDA cores (9*Cin a 3x3 output),
// except where a channel count is 3.  f32 runs FFMA (128 per SM per clock,
// no TF32); int16 runs IMAD on 32-bit words at half that rate (64 per SM per
// clock, 1.67e13/s on 132 SMs at 1.98 GHz): Hopper has no int16 tensor-core
// MMA, and its int8 MMA would need each product split in four.  So the
// design spends as few instructions as it can on anything but the
// multiply-add, and leaves IMAD's idle issue slots to the loads.
//
// Design: an implicit GEMM, pixels x Cout by a depth of K*K*Cin.  A block
// computes a th x 8 pixel tile of one image for tco output channels; each
// thread keeps a register micro-tile of PX pixels of one row (8 or 4) x 4
// channels.  For each (ci, kh) it loads the row's PX + K - 1 inputs once
// and reuses them for all K taps kw, and reads the 4 weights of a tap as
// one vector (float4; int16: 8 bytes, unpacked to 4 words): for PX = 8,
// K = 3 that is 13 shared-memory loads per 96 multiply-adds.  int16 inputs
// are widened as they are loaded (ld.shared.s16 sign-extends), so the
// staged tiles stay int16, half the bytes of f32.  The input halo tile
// ([pos][ci], rows padded by 16 bytes so the rows a warp reads fall in
// distinct banks) and the weight slice ([kh, kw][ci][co]) are staged Cin
// chunk by Cin chunk into a two-stage ring: cp.async copies of 16, 8 or 4
// bytes where the channel count, the chunk and the pointer allow, halo and
// ragged edges zero-filled by the copy itself; otherwise ordinary loads, one
// element each (int16 rows with an odd channel count, such as layer 0's
// Cin = 3, or a view 2 bytes off).  The next chunk's copies are issued
// right after the one __syncthreads of each chunk and land while the
// current chunk is summed.  Each output is one thread's chain over
// (ci, kh, kw) in that order, so no plan (th, PX, tco, chunk) changes a bit:
// the f32 kernel sums in the order of conv2d.cu's conv_kernel, and the
// int16 sum wraps modulo 2^32, which no order changes.  The tile's row of
// inputs needs K at compile time: it is built for K = 1, 3, 5, 7; other odd
// K, and the general plan of zeros, run each file's general kernel.
// kernels/conv2d/conv2d.py conv_plan chooses the plan and mirrors the
// shared-memory layout (ConvPlan.smem_bytes).
#pragma once

#include "common.cuh"

namespace repro {

// The tiled int16 forward (B7) for the plan (th, px, tco, cin_t), defined in
// conv_fwd_i16.cu: its instances build in a file of their own, in parallel
// with conv2d_fxp.cu's fused backward, not after it.
cudaError_t conv_fwd_tiled_i16(const int16_t* x, const int16_t* w,
                               const int16_t* bias, int16_t* y, int n, int h,
                               int wd, int cin, int cout, int k, int th,
                               int px, int tco, int cin_t,
                               cudaStream_t stream);

}  // namespace repro

namespace {
namespace fwd {

constexpr int TW = 8;            // tile width in pixels
constexpr int MAX_THREADS = 256; // kernels/conv2d/conv2d.py mirrors both

template <typename T>
struct Args {
  const T* x;     // [N,H,W,Cin]
  const T* w;     // [K,K,Cin,Cout]
  const T* bias;  // [Cout] or null
  T* y;           // [N,H,W,Cout]
  int n, h, wd, cin, cout;
  int th, tco, cin_t;  // tile rows, Cout per block, Cin per stage
  int xstride;         // elements per staged halo position
  int stage;           // elements per ring stage (halo, then weights)
  int vb_x, vb_w;      // bytes per copy (0: ordinary loads)
  int vec_y;           // 4-element stores allowed
};

template <typename T, int K, int PX>
__global__ void __launch_bounds__(MAX_THREADS)
conv_igemm_kernel(Args<T> a) {
  using Tr = repro::Traits<T>;
  using W = typename Tr::Word;
  constexpr int P = (K - 1) / 2, XW = TW + K - 1, NX = PX + K - 1;
  constexpr int GX = TW / PX;  // threads across one tile row
  extern __shared__ float4 fw_smem4[];
  T* smem = reinterpret_cast<T*>(fw_smem4);
  const int th = a.th, cin_t = a.cin_t, tco = a.tco, xstride = a.xstride;
  const int XH = th + K - 1, xsz = XH * XW * xstride;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cg = tid % (tco / 4), pg = tid / (tco / 4);
  const int ty = pg / GX, px0 = (pg % GX) * PX;
  const int tiles_w = (a.wd + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * th;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * tco, nn = blockIdx.z;
  const T* xn = a.x + static_cast<size_t>(nn) * a.h * a.wd * a.cin;

  // Stage Cin channels [c0, c0 + cn) of the halo tile and the weights in
  // copies of VB bytes, the launch's vb_x and vb_w made compile-time
  // constants of each loop; a copy never straddles a row: its element
  // count divides the channel count and the chunk.
  auto load = [&](int s, int c0) {
    T* xs = smem + s * a.stage;
    T* ws = xs + xsz;
    const int cn = min(cin_t, a.cin - c0);
    repro::with_copy_bytes(a.vb_x, [&](auto vx) {
      constexpr int VB = decltype(vx)::value;
      constexpr int E = VB ? VB / static_cast<int>(sizeof(T)) : 1;
      const int xu = cn / E;  // copies per halo position
      for (int e = tid; e < XH * XW * xu; e += nthr) {
        const int pos = e / xu, q = e - pos * xu;
        const int yy = y0 - P + pos / XW, xx = x0 - P + pos % XW;
        const bool ok = yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd;
        const T* src =
            ok ? xn + (static_cast<size_t>(yy) * a.wd + xx) * a.cin + c0 +
                     q * E
               : a.x;
        repro::stage_copy(xs + pos * xstride + q * E, src, ok, VB);
      }
    });
    repro::with_copy_bytes(a.vb_w, [&](auto vw) {
      constexpr int VB = decltype(vw)::value;
      constexpr int E = VB ? VB / static_cast<int>(sizeof(T)) : 1;
      const int wu = tco / E;  // copies per weight row
      for (int e = tid; e < K * K * cn * wu; e += nthr) {
        const int r = e / wu, q = e - r * wu;
        const int kk = r / cn, ci = r - kk * cn, o = co0 + q * E;
        const bool ok = o < a.cout;
        const T* src =
            ok ? a.w + (static_cast<size_t>(kk) * a.cin + c0 + ci) * a.cout +
                     o
               : a.w;
        repro::stage_copy(ws + (kk * cin_t + ci) * tco + q * E, src, ok,
                          VB);
      }
    });
    repro::cp_async_commit();
  };

  W acc[PX][4];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = W(0);

  const int nchunks = (a.cin + cin_t - 1) / cin_t;
  if (nchunks > 0) load(0, 0);
  for (int i = 0; i < nchunks; ++i) {
    repro::cp_async_wait_all();
    // Chunk i has landed for every thread, and every thread is done with
    // chunk i - 1, whose stage the next copies overwrite.
    __syncthreads();
    if (i + 1 < nchunks) load((i + 1) & 1, (i + 1) * cin_t);
    const T* xs = smem + (i & 1) * a.stage;
    const T* xt = xs + (ty * XW + px0) * xstride;
    const T* wt = xs + xsz + 4 * cg;
    const int cn = min(cin_t, a.cin - i * cin_t);
#pragma unroll 2
    for (int ci = 0; ci < cn; ++ci) {
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        W xr[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j)
          xr[j] = Tr::widen(xt[(kh * XW + j) * xstride + ci]);
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          W wv[4];
          Tr::weights4(wt + ((kh * K + kw) * cin_t + ci) * tco, wv);
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[p][j] = Tr::mac(acc[p][j], xr[p + kw], wv[j]);
        }
      }
    }
  }

  const int yy = y0 + ty, o = co0 + 4 * cg;
  if (yy >= a.h || o >= a.cout) return;
  T bv[4] = {T(0), T(0), T(0), T(0)};
  if (a.bias) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (o + j < a.cout) bv[j] = a.bias[o + j];
  }
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int xx = x0 + px0 + p;
    if (xx >= a.wd) break;
    T* dst =
        a.y + ((static_cast<size_t>(nn) * a.h + yy) * a.wd + xx) * a.cout + o;
    decltype(Tr::finish(acc[0][0])) r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = Tr::finish(acc[p][j]);
      if (a.bias) r[j] = Tr::add_bias(r[j], bv[j]);
    }
    if (a.vec_y) {  // Cout a multiple of 4, y aligned to 4 elements
      Tr::store4(dst, r);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (o + j < a.cout) dst[j] = static_cast<T>(r[j]);
    }
  }
}

template <typename T, int K, int PX>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 2 * static_cast<size_t>(a.stage);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_igemm_kernel<T, K, PX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = a.th * (TW / PX) * (a.tco / 4);
  // the batch rides gridDim.z, a chunk of at most kBatchChunk images a launch
  return repro::for_batch_chunks(a.n, [&](int n0, int nb) {
    Args<T> b = a;
    b.x = a.x + static_cast<size_t>(n0) * a.h * a.wd * a.cin;
    b.y = a.y + static_cast<size_t>(n0) * a.h * a.wd * a.cout;
    b.n = nb;
    const dim3 grid(((a.h + a.th - 1) / a.th) * ((a.wd + TW - 1) / TW),
                    (a.cout + a.tco - 1) / a.tco, nb);
    conv_igemm_kernel<T, K, PX><<<grid, threads, smem, stream>>>(b);
    return cudaGetLastError();
  });
}

template <typename T, int K>
cudaError_t launch_px(const Args<T>& a, int px, cudaStream_t stream) {
  return px == 8 ? launch<T, K, 8>(a, stream) : launch<T, K, 4>(a, stream);
}

// The tile plan of kernels/conv2d/conv2d.py conv_plan (k in {1,3,5,7}):
// check it, lay out shared memory as ConvPlan.smem_bytes does, choose the
// copy widths, launch.
template <typename T>
cudaError_t launch_tiled(Args<T> a, int k, int px, cudaStream_t stream) {
  const int threads = a.th * (px > 0 ? TW / px : 0) * (a.tco / 4);
  if ((px != 4 && px != 8) || a.tco < 4 || a.tco % 4 != 0 || a.th < 1 ||
      a.cin_t < 1 || threads > MAX_THREADS)
    return cudaErrorInvalidValue;
  // 16 bytes of elements: halo rows padded by one so the rows a warp reads
  // fall in distinct banks, and each stage 16-byte aligned
  const int unit = 16 / static_cast<int>(sizeof(T));
  a.xstride = (a.cin_t + unit - 1) / unit * unit + unit;
  const int stage =
      (a.th + k - 1) * (TW + k - 1) * a.xstride + k * k * a.cin_t * a.tco;
  a.stage = (stage + unit - 1) / unit * unit;
  a.vb_x = repro::copy_bytes<T>(a.x, a.cin, a.cin_t);
  a.vb_w = repro::copy_bytes<T>(a.w, a.cout, a.tco);
  a.vec_y = a.cout % 4 == 0 &&
            reinterpret_cast<uintptr_t>(a.y) % (4 * sizeof(T)) == 0;
  switch (k) {
    case 1: return launch_px<T, 1>(a, px, stream);
    case 3: return launch_px<T, 3>(a, px, stream);
    case 5: return launch_px<T, 5>(a, px, stream);
    default: return launch_px<T, 7>(a, px, stream);
  }
}

}  // namespace fwd
}  // namespace
