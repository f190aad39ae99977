// Stride-1 SAME convolution, forward and fused backward (paper §III.B,
// Fig. 4-6), NHWC activations x HWIO kernels, odd K.
//
// Replaces: src/repro/kernels/conv2d/conv2d.py, conv2d_pallas
// (repro_conv2d_fwd) and conv2d_bwd_fused_pallas (repro_conv2d_bwd_fused).
//
//   forward:  y[n] = conv(x[n], w) (+ b in the epilogue)
//   backward: out[s, n] = gate_out(conv(gate_in(unpool(g[s, n])), wt)),
//             wt = flip_transpose(w) made once by the caller.  unpool
//             routes each pooled gradient to the window position its 2-bit
//             crumb names (zeros elsewhere); gate_in is the Eq. 3-5 rule
//             with the layer's 1-bit mask (deconvnet: g > 0, no mask);
//             gate_out is the optional epilogue rule with the previous
//             layer's mask.  The residuals carry no seeds axis.
//
// Bound on an H100: operations for the wide layers, bytes where a channel
// count is 3.  A layer does 9*Cin FMAs per output: conv1 at batch 32 is
// 0.6 GFLOP on 8.4 MB (72 FLOP/byte, above the f32 ridge of 67 TFLOP/s /
// 3.35 TB/s = 20), while layer 0 forward (Cin = 3) and its backward
// (Cout' = 3) do about 12 FLOP/byte.  f32 FMA on CUDA cores both ways, no
// tensor cores (no TF32), no atomics: each output is written once by one
// thread, its sum taken over (ci, kh, kw) in that order.
//
// Forward design: the tiled kernel of conv_fwd.cuh
// (conv_igemm_kernel<float, K, PX>): a register-tiled implicit GEMM on a
// two-stage cp.async ring, each thread PX pixels of one row x 4 channels,
// the row of inputs of each (ci, kh) reused for all K taps; tiled by
// kernels/conv2d/conv2d.py conv_plan, bit for bit equal to conv_kernel
// below under every plan.  Built for K = 1, 3, 5, 7; the forward runs any
// other odd K, and the general plan of zeros, on conv_kernel.
//
// Fused backward design: the tiled kernel of conv_bwd.cuh
// (conv_bwd_igemm_kernel<float, K, PX, SG>), the forward's tile with the S
// seeds of one image in the block and the unpool + gate prologue run on a
// landing buffer of the cp.async ring; tiled by kernels/conv2d/conv2d.py
// conv_bwd_plan, bit for bit equal to conv_kernel below under every plan.
// Built for K = 1, 3, 5, 7 like the forward.
//
// General kernel (conv_kernel: the fused backward and the forward for any
// other odd K, or when the caller passes the general plan of zeros): one
// block computes an 8x8 pixel tile of one image for a slice of TCO output
// channels (32, or 8 when Cout <= 8, e.g. the backward of layer 0 whose
// Cout' is 3).  The input halo tile (10x10 for K=3) and the matching
// weight slice are staged in shared memory Cin chunk by Cin chunk; each
// thread keeps TCO/4 pixel accumulators of one channel, so a
// warp reads one broadcast activation and 32 (or 8) consecutive weights
// per FMA step.  SAME padding and ragged channel counts (Cin = 3, Cout' =
// 3) are bounds checks on the loads and stores, never a padded copy.  Its
// fused backward decodes the prologue for its whole halo tile and all C
// channels once (unpool routing bit + mask bit, one byte per value) into
// shared memory and then loops over the S seeds, so every seed reuses the
// residual bytes the block loaded once; that state grows with C (60 KB at
// C = 600), which the tiled kernel's does not.

#include "common.cuh"
#include "conv_bwd.cuh"
#include "conv_fwd.cuh"

namespace {

constexpr int TH = 8, TW = 8, NTHREADS = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

struct ConvArgs {
  const float* in;          // fwd x [N,H,W,Cin]; bwd g [S,N,Hg,Wg,Cin]
  const float* wt;          // [K,K,Cin,Cout]
  const float* bias;        // [Cout] or null (forward only)
  const uint8_t* pool_idx;  // [N,H/2,W/2,ceil(Cin/4)] or null (no pool)
  const uint8_t* mask;      // [N,H,W,ceil(Cin/8)] or null
  const uint8_t* omask;     // [N,H,W,ceil(Cout/8)] or null
  float* out;               // [S,N,H,W,Cout]
  int s, n, h, wd, cin, cout, k;  // h, wd: output (full-resolution) size
  int gate_in, gate_out, method;
  int cin_t;                // Cin channels staged per shared-memory chunk
};

template <int TCO, bool FUSED>
__global__ void __launch_bounds__(NTHREADS) conv_kernel(ConvArgs a) {
  constexpr int PPT = TH * TW * TCO / NTHREADS;  // pixels per thread
  extern __shared__ float smem[];
  const int K = a.k, P = (K - 1) / 2;
  const int XW = TW + K - 1, XHW = (TH + K - 1) * XW;
  const int cin_t = a.cin_t, xs_stride = cin_t + 1;  // +1: no bank clash
  float* xs = smem;                                  // [XHW][cin_t + 1]
  float* ws = xs + XHW * xs_stride;                  // [K*K][cin_t][TCO]
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
    const float* in = a.in + static_cast<size_t>(s) * a.n * hg * wg * a.cin;
    float acc[PPT];
#pragma unroll
    for (int p = 0; p < PPT; ++p) acc[p] = 0.f;

    for (int c0 = 0; c0 < a.cin; c0 += cin_t) {
      __syncthreads();  // previous chunk's reads (and sel writes) are done
      for (int e = tid; e < XHW * cin_t; e += NTHREADS) {
        const int ci = e % cin_t, pos = e / cin_t, c = c0 + ci;
        const int yy = y0 - P + pos / XW, xx = x0 - P + pos % XW;
        float v = 0.f;
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
        xs[pos * xs_stride + ci] = v;
      }
      for (int e = tid; e < K * K * cin_t * TCO; e += NTHREADS) {
        const int cc = e % TCO, ci = (e / TCO) % cin_t, kk = e / (TCO * cin_t);
        const int c = c0 + ci, o = co0 + cc;
        ws[e] = (c < a.cin && o < a.cout)
                    ? a.wt[(static_cast<size_t>(kk) * a.cin + c) * a.cout + o]
                    : 0.f;
      }
      __syncthreads();

      const int ci_n = min(cin_t, a.cin - c0);
      for (int ci = 0; ci < ci_n; ++ci) {
        for (int kh = 0; kh < K; ++kh) {
          for (int kw = 0; kw < K; ++kw) {
            const float wv = ws[((kh * K + kw) * cin_t + ci) * TCO + co];
#pragma unroll
            for (int p = 0; p < PPT; ++p) {
              const int pix = pg * PPT + p, py = pix / TW, px = pix % TW;
              acc[p] = fmaf(xs[((py + kh) * XW + px + kw) * xs_stride + ci],
                            wv, acc[p]);
            }
          }
        }
      }
    }

    const int o = co0 + co;
    float* out = a.out + static_cast<size_t>(s) * a.n * a.h * a.wd * a.cout;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int pix = pg * PPT + p;
      const int yy = y0 + pix / TW, xx = x0 + pix % TW;
      if (yy >= a.h || xx >= a.wd || o >= a.cout) continue;
      const size_t at = (static_cast<size_t>(nn) * a.h + yy) * a.wd + xx;
      float r = acc[p];
      if (!FUSED && a.bias) r += a.bias[o];
      if (FUSED && a.gate_out) {
        const uint8_t* orow =
            a.omask ? a.omask + at * ((a.cout + 7) / 8) : nullptr;
        r = repro::gate(r, repro::mask_bit(orow, o), a.method);
      }
      out[at * a.cout + o] = r;
    }
  }
}

template <int TCO, bool FUSED>
cudaError_t launch(ConvArgs a, cudaStream_t stream) {
  const int XHW = (TH + a.k - 1) * (TW + a.k - 1);
  auto smem_of = [&](int ct) {
    return sizeof(float) * (static_cast<size_t>(XHW) * (ct + 1) +
                            static_cast<size_t>(a.k) * a.k * ct * TCO) +
           (FUSED ? static_cast<size_t>(XHW) * a.cin : 0);
  };
  int ct = a.cin < 32 ? a.cin : 32;
  while (ct > 1 && smem_of(ct) > kDefaultSmem) ct = (ct + 1) / 2;
  a.cin_t = ct;
  const size_t smem = smem_of(ct);
  if (smem > kDefaultSmem) {
    // Large C in the fused backward: opt in to more than 48 KB (up to the
    // 227 KB a block may use); a refused size is returned to the caller.
    const cudaError_t e = cudaFuncSetAttribute(
        conv_kernel<TCO, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // The batch rides gridDim.z.  The forward (one seed) launches a chunk of
  // at most kBatchChunk images at a time; the fused backward indexes its
  // [S, N, ...] gradient by the whole N and launches once.
  return repro::for_batch_chunks(FUSED ? 0 : a.n, [&](int n0, int nb) {
    ConvArgs b = a;
    if (!FUSED) {
      b.in = a.in + static_cast<size_t>(n0) * a.h * a.wd * a.cin;
      b.out = a.out + static_cast<size_t>(n0) * a.h * a.wd * a.cout;
      b.n = nb;
    }
    const dim3 grid(((a.h + TH - 1) / TH) * ((a.wd + TW - 1) / TW),
                    (a.cout + TCO - 1) / TCO, b.n);
    conv_kernel<TCO, FUSED><<<grid, NTHREADS, smem, stream>>>(b);
    return cudaGetLastError();
  });
}

template <bool FUSED>
int dispatch(const ConvArgs& a, cudaStream_t stream) {
  const cudaError_t e = a.cout <= 8 ? launch<8, FUSED>(a, stream)
                                    : launch<32, FUSED>(a, stream);
  return static_cast<int>(e);
}

}  // namespace

REPRO_API int repro_conv2d_fwd(const float* x, const float* w,
                               const float* bias, float* y, int n, int h,
                               int wd, int cin, int cout, int k, int th,
                               int px, int tco, int cin_t,
                               cudaStream_t stream) {
  const bool tiled = k == 1 || k == 3 || k == 5 || k == 7;
  const bool general = th == 0 && px == 0 && tco == 0 && cin_t == 0;
  if (!tiled || general) {
    // Other odd K, or the general plan of zeros: the general kernel of the
    // fused backward, in its forward form, which tiles itself.
    ConvArgs a{};
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
  fwd::Args<float> a{};
  a.x = x;
  a.w = w;
  a.bias = bias;
  a.y = y;
  a.n = n;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  a.th = th;
  a.tco = tco;
  a.cin_t = cin_t;
  return static_cast<int>(fwd::launch_tiled(a, k, px, stream));
}

REPRO_API int repro_conv2d_bwd_fused(const float* g, const float* wt,
                                     const uint8_t* pool_idx,
                                     const uint8_t* mask,
                                     const uint8_t* omask, float* out, int s,
                                     int n, int h, int wd, int c, int cout,
                                     int k, int gate_in, int gate_out,
                                     int method, int th, int px, int tco,
                                     int cin_t, int sg, int st,
                                     cudaStream_t stream) {
  const bool tiled = k == 1 || k == 3 || k == 5 || k == 7;
  const bool general =
      th == 0 && px == 0 && tco == 0 && cin_t == 0 && sg == 0 && st == 0;
  if (!general && !tiled) return static_cast<int>(cudaErrorInvalidValue);
  if (!general) {
    // The tile plan of kernels/conv2d/conv2d.py conv_bwd_plan.
    bwd::Args<float> b{};
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
  // The general plan (zeros): conv_kernel, which tiles itself.
  ConvArgs a{};
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
