// True-int16 stride-1 SAME convolution, forward and fused backward (paper
// §IV: the 16-bit fixed-point datapath), NHWC x HWIO, odd K.
//
// Replaces: src/repro/kernels/conv2d/fxp.py, conv2d_fxp_pallas
// (repro_conv2d_fxp_fwd) and conv2d_bwd_fused_fxp_pallas
// (repro_conv2d_bwd_fused_fxp).
//
//   forward:  y[n] = sat_add(requantize(conv(x[n], w)), b)
//   backward: out[s, n] = gate_out(requantize(conv(gate_in(unpool(g[s, n])),
//             wt))), wt = flip_transpose(w) made once by the caller.
//
// Operands are int16: Q7.8 activations and gradients, Q1.14 weights, Q7.8
// bias.  Products accumulate in 32 bits and wrap modulo 2^32 (a uint32_t
// accumulator: K*K*Cin products of up to 2^30 can pass 2^31 at the rails,
// and the reference's int32 dot wraps there).  One requantize narrows the
// accumulator to Q7.8; the forward adds the bias with saturation after it,
// which equals the reference's sat_add(conv2d_fxp(x, w), b), and the
// backward applies its epilogue gate after it (fxp.py:119-125).
//
// Bound on an H100: integer multiply-adds, except the backward of layer 0
// (Cout' = 3), which is bound by bytes.  Hopper has no int16 tensor-core
// MMA, so the products run as IMAD on the CUDA cores: 64 per SM per clock,
// half the FFMA rate, 1.67e13/s on 132 SMs at 1.98 GHz.  No atomics: each
// output is written once by one thread, so results are deterministic.
//
// Forward design (B7): the tiled kernel of conv_fwd.cuh
// (conv_igemm_kernel<int16_t, K, PX>, instantiated in conv_fwd_i16.cu),
// B1's template on int16 operands:
// each thread a register micro-tile of PX pixels of one row x 4 channels
// in uint32_t accumulators, the row of PX + K - 1 inputs of each (ci, kh)
// loaded once (widened by ld.shared.s16) and reused for all K taps, the 4
// weights of a tap read as one 8-byte vector and unpacked to words, so the
// inner loop is IMAD with one shared-memory load per 7 of them (PX = 8,
// K = 3) where the general kernel below pays one per IMAD; the int16 halo and
// weights staged Cin chunk by Cin chunk on a two-stage cp.async ring
// (16-, 8- or 4-byte copies where C, the chunk and the pointer allow,
// ordinary loads for layer 0's 6-byte rows or a 2-byte offset view), half
// the bytes of f32 a stage; requantize, then sat16(r + bias), one write
// per output.  Wrapping addition is associative, so no plan changes a bit.
// Built for K = 1, 3, 5, 7 and tiled by kernels/conv2d/conv2d.py
// conv_plan.
//
// Fused backward design: the tiled kernel of conv_bwd.cuh
// (conv_bwd_igemm_kernel<int16_t, K, PX, SG>), the f32 backward's template
// on int16 operands: the register micro-tile, the input row reused across
// kw, the cp.async ring with its unpool + gate prologue, the gated values
// widened to 32 bits in shared memory so the inner loop is IMAD on uint32_t
// words, and the requantize before the epilogue gate.  Wrapping addition
// is associative, so no plan changes a bit.  Built for K = 1, 3, 5, 7 and
// tiled by kernels/conv2d/conv2d.py conv_bwd_plan.
//
// General kernel (conv_fxp_kernel: the forward and the fused backward for
// any other odd K or the general plan of zeros, and the bitwise reference
// the tiled kernels are timed beside): the tile structure of the f32
// general kernel (conv2d.cu conv_kernel): one block computes an 8x8 pixel
// tile of one image for TCO output channels (32, or 8 when Cout <= 8,
// e.g. the backward of layer 0 whose Cout' is 3); the input halo tile and
// the weight slice are staged in shared memory as int16, half the bytes of
// f32, Cin chunk by Cin chunk (64 channels, halved until the tiles fit the
// 48 KB: 32 at TCO = 32 and K = 3); each thread keeps TCO/4 pixel
// accumulators of one channel.  SAME padding and ragged channel counts are
// bounds checks on the loads and stores.  Its fused backward decodes its
// prologue (unpool routing bit + mask bit) for the whole halo tile and all
// C channels once into shared memory and then loops over the S seeds, so
// the residual bytes are loaded once for every seed.

#include "common.cuh"
#include "conv_bwd.cuh"
#include "conv_fwd.cuh"

namespace {

constexpr int TH = 8, TW = 8, NTHREADS = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxCinChunk = 64;

struct ConvFxpArgs {
  const int16_t* in;        // fwd x [N,H,W,Cin]; bwd g [S,N,Hg,Wg,Cin]
  const int16_t* wt;        // [K,K,Cin,Cout], Q1.14
  const int16_t* bias;      // [Cout] Q7.8 or null (forward only)
  const uint8_t* pool_idx;  // [N,H/2,W/2,ceil(Cin/4)] or null (no pool)
  const uint8_t* mask;      // [N,H,W,ceil(Cin/8)] or null
  const uint8_t* omask;     // [N,H,W,ceil(Cout/8)] or null
  int16_t* out;             // [S,N,H,W,Cout]
  int s, n, h, wd, cin, cout, k;  // h, wd: output (full-resolution) size
  int gate_in, gate_out, method;
  int cin_t;                // Cin channels staged per shared-memory chunk
};

// Halo row stride in int16: cin_t + 2 keeps rows 4-byte aligned and, for
// even cin_t, an odd number of words apart (rows start in distinct banks).
__host__ __device__ inline int xs_stride_of(int cin_t) { return cin_t + 2; }

template <int TCO, bool FUSED>
__global__ void __launch_bounds__(NTHREADS) conv_fxp_kernel(ConvFxpArgs a) {
  constexpr int PPT = TH * TW * TCO / NTHREADS;  // pixels per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = a.k, P = (K - 1) / 2;
  const int XW = TW + K - 1, XHW = (TH + K - 1) * XW;
  const int cin_t = a.cin_t, xs_stride = xs_stride_of(cin_t);
  int16_t* xs = reinterpret_cast<int16_t*>(smem_raw);  // [XHW][xs_stride]
  int16_t* ws = xs + XHW * xs_stride;                   // [K*K][cin_t][TCO]
  uint8_t* sel = reinterpret_cast<uint8_t*>(ws + K * K * cin_t * TCO);

  const int tiles_w = (a.wd + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH, x0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO, nn = blockIdx.z;
  const int tid = threadIdx.x, co = tid % TCO, pg = tid / TCO;
  const bool pooled = FUSED && a.pool_idx != nullptr;
  const int hg = pooled ? a.h / 2 : a.h, wg = pooled ? a.wd / 2 : a.wd;

  if (FUSED) {
    // Prologue state for the halo tile, once for all seeds: bit 0 = this
    // position receives the gradient (its crumb names it, or no pool),
    // bit 1 = the stored ReLU mask bit.  0 outside the image (SAME zeros).
    const int cb4 = (a.cin + 3) / 4, cb8 = (a.cin + 7) / 8;
    for (int e = tid; e < XHW * a.cin; e += NTHREADS) {
      const int c = e % a.cin, pos = e / a.cin;
      const int yy = y0 - P + pos / XW, xx = x0 - P + pos % XW;
      uint8_t bits = 0;
      if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd) {
        bool take = true;
        if (pooled) {
          const uint8_t* irow =
              a.pool_idx +
              ((static_cast<size_t>(nn) * hg + yy / 2) * wg + xx / 2) * cb4;
          take = repro::crumb(irow, c) == ((yy & 1) * 2 + (xx & 1));
        }
        const uint8_t* mrow =
            a.mask ? a.mask +
                         ((static_cast<size_t>(nn) * a.h + yy) * a.wd + xx) *
                             cb8
                   : nullptr;
        bits = (take ? 1 : 0) | (repro::mask_bit(mrow, c) ? 2 : 0);
      }
      sel[e] = bits;
    }
  }

  for (int s = 0; s < a.s; ++s) {
    const int16_t* in = a.in + static_cast<size_t>(s) * a.n * hg * wg * a.cin;
    uint32_t acc[PPT];
#pragma unroll
    for (int p = 0; p < PPT; ++p) acc[p] = 0u;

    for (int c0 = 0; c0 < a.cin; c0 += cin_t) {
      __syncthreads();  // previous chunk's reads (and sel writes) are done
      for (int e = tid; e < XHW * cin_t; e += NTHREADS) {
        const int ci = e % cin_t, pos = e / cin_t, c = c0 + ci;
        const int yy = y0 - P + pos / XW, xx = x0 - P + pos % XW;
        int v = 0;
        if (c < a.cin && yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd) {
          if (FUSED) {
            const uint8_t bits = sel[pos * a.cin + c];
            if (bits & 1) {
              const int gy = pooled ? yy / 2 : yy, gx = pooled ? xx / 2 : xx;
              v = in[((static_cast<size_t>(nn) * hg + gy) * wg + gx) * a.cin +
                     c];
              if (a.gate_in) v = repro::gate(v, bits & 2, a.method);
            }
          } else {
            v = in[((static_cast<size_t>(nn) * a.h + yy) * a.wd + xx) * a.cin +
                   c];
          }
        }
        xs[pos * xs_stride + ci] = static_cast<int16_t>(v);
      }
      for (int e = tid; e < K * K * cin_t * TCO; e += NTHREADS) {
        const int cc = e % TCO, ci = (e / TCO) % cin_t, kk = e / (TCO * cin_t);
        const int c = c0 + ci, o = co0 + cc;
        ws[e] = (c < a.cin && o < a.cout)
                    ? a.wt[(static_cast<size_t>(kk) * a.cin + c) * a.cout + o]
                    : int16_t(0);
      }
      __syncthreads();

      const int ci_n = min(cin_t, a.cin - c0);
      for (int ci = 0; ci < ci_n; ++ci) {
        for (int kh = 0; kh < K; ++kh) {
          for (int kw = 0; kw < K; ++kw) {
            const int wv = ws[((kh * K + kw) * cin_t + ci) * TCO + co];
#pragma unroll
            for (int p = 0; p < PPT; ++p) {
              const int pix = pg * PPT + p, py = pix / TW, px = pix % TW;
              const int xv = xs[((py + kh) * XW + px + kw) * xs_stride + ci];
              // |xv * wv| <= 2^30: the product fits; the sum wraps.
              acc[p] += static_cast<uint32_t>(xv * wv);
            }
          }
        }
      }
    }

    const int o = co0 + co;
    int16_t* out = a.out + static_cast<size_t>(s) * a.n * a.h * a.wd * a.cout;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int pix = pg * PPT + p;
      const int yy = y0 + pix / TW, xx = x0 + pix % TW;
      if (yy >= a.h || xx >= a.wd || o >= a.cout) continue;
      const size_t at = (static_cast<size_t>(nn) * a.h + yy) * a.wd + xx;
      int r = repro::requantize(acc[p]);
      if (!FUSED && a.bias) r = repro::sat16(r + a.bias[o]);
      if (FUSED && a.gate_out) {
        const uint8_t* orow =
            a.omask ? a.omask + at * ((a.cout + 7) / 8) : nullptr;
        r = repro::gate(r, repro::mask_bit(orow, o), a.method);
      }
      out[at * a.cout + o] = static_cast<int16_t>(r);
    }
  }
}

template <int TCO, bool FUSED>
cudaError_t launch(ConvFxpArgs a, cudaStream_t stream) {
  const int XHW = (TH + a.k - 1) * (TW + a.k - 1);
  auto smem_of = [&](int ct) {
    return sizeof(int16_t) * (static_cast<size_t>(XHW) * xs_stride_of(ct) +
                              static_cast<size_t>(a.k) * a.k * ct * TCO) +
           (FUSED ? static_cast<size_t>(XHW) * a.cin : 0);
  };
  int ct = a.cin < kMaxCinChunk ? a.cin : kMaxCinChunk;
  while (ct > 1 && smem_of(ct) > kDefaultSmem) ct = (ct + 1) / 2;
  a.cin_t = ct;
  const size_t smem = smem_of(ct);
  if (smem > kDefaultSmem) {
    // Large C in the fused backward: opt in to more than 48 KB (up to the
    // 227 KB a block may use); a refused size is returned to the caller.
    const cudaError_t e = cudaFuncSetAttribute(
        conv_fxp_kernel<TCO, FUSED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // The batch rides gridDim.z.  The forward (one seed) launches a chunk of
  // at most kBatchChunk images at a time; the fused backward indexes its
  // [S, N, ...] gradient by the whole N and launches once.
  return repro::for_batch_chunks(FUSED ? 0 : a.n, [&](int n0, int nb) {
    ConvFxpArgs b = a;
    if (!FUSED) {
      b.in = a.in + static_cast<size_t>(n0) * a.h * a.wd * a.cin;
      b.out = a.out + static_cast<size_t>(n0) * a.h * a.wd * a.cout;
      b.n = nb;
    }
    const dim3 grid(((a.h + TH - 1) / TH) * ((a.wd + TW - 1) / TW),
                    (a.cout + TCO - 1) / TCO, b.n);
    conv_fxp_kernel<TCO, FUSED><<<grid, NTHREADS, smem, stream>>>(b);
    return cudaGetLastError();
  });
}

template <bool FUSED>
int dispatch(const ConvFxpArgs& a, cudaStream_t stream) {
  const cudaError_t e = a.cout <= 8 ? launch<8, FUSED>(a, stream)
                                    : launch<32, FUSED>(a, stream);
  return static_cast<int>(e);
}

}  // namespace

REPRO_API int repro_conv2d_fxp_fwd(const int16_t* x, const int16_t* w,
                                   const int16_t* bias, int16_t* y, int n,
                                   int h, int wd, int cin, int cout, int k,
                                   int th, int px, int tco, int cin_t,
                                   cudaStream_t stream) {
  const bool tiled = k == 1 || k == 3 || k == 5 || k == 7;
  const bool general = th == 0 && px == 0 && tco == 0 && cin_t == 0;
  if (!tiled || general) {
    // Other odd K, or the general plan of zeros: conv_fxp_kernel, which
    // tiles itself.
    ConvFxpArgs a{};
    a.in = x;
    a.wt = w;
    a.bias = bias;
    a.out = y;
    a.s = 1;
    a.n = n;
    a.h = h;
    a.wd = wd;
    a.cin = cin;
    a.cout = cout;
    a.k = k;
    return dispatch<false>(a, stream);
  }
  // The tile plan of kernels/conv2d/conv2d.py conv_plan.
  return static_cast<int>(repro::conv_fwd_tiled_i16(
      x, w, bias, y, n, h, wd, cin, cout, k, th, px, tco, cin_t, stream));
}

REPRO_API int repro_conv2d_bwd_fused_fxp(const int16_t* g, const int16_t* wt,
                                         const uint8_t* pool_idx,
                                         const uint8_t* mask,
                                         const uint8_t* omask, int16_t* out,
                                         int s, int n, int h, int wd, int c,
                                         int cout, int k, int gate_in,
                                         int gate_out, int method, int th,
                                         int px, int tco, int cin_t, int sg,
                                         int st, cudaStream_t stream) {
  const bool tiled = k == 1 || k == 3 || k == 5 || k == 7;
  const bool general =
      th == 0 && px == 0 && tco == 0 && cin_t == 0 && sg == 0 && st == 0;
  if (!general && !tiled) return static_cast<int>(cudaErrorInvalidValue);
  if (!general) {
    // The tile plan of kernels/conv2d/conv2d.py conv_bwd_plan.
    bwd::Args<int16_t> b{};
    b.g = g;
    b.wt = wt;
    b.pool_idx = pool_idx;
    b.mask = mask;
    b.omask = omask;
    b.out = out;
    b.s = s;
    b.n = n;
    b.h = h;
    b.wd = wd;
    b.c = c;
    b.cout = cout;
    b.gate_in = gate_in;
    b.gate_out = gate_out;
    b.method = method;
    b.th = th;
    b.tco = tco;
    b.cin_t = cin_t;
    b.st = st;
    return static_cast<int>(bwd::launch_tiled(b, k, px, sg, stream));
  }
  // The general plan (zeros): conv_fxp_kernel, which tiles itself.
  ConvFxpArgs a{};
  a.in = g;
  a.wt = wt;
  a.pool_idx = pool_idx;
  a.mask = mask;
  a.omask = omask;
  a.out = out;
  a.s = s;
  a.n = n;
  a.h = h;
  a.wd = wd;
  a.cin = c;
  a.cout = cout;
  a.k = k;
  a.gate_in = gate_in;
  a.gate_out = gate_out;
  a.method = method;
  return dispatch<true>(a, stream);
}
