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
// Forward design (conv_igemm_kernel): an implicit GEMM, pixels x Cout by a
// depth of K*K*Cin, on the CUDA cores.  A block computes a TH x 8 pixel
// tile of one image for TCO output channels; each thread keeps a register
// micro-tile of PX pixels of one row (8 or 4) x 4 channels.  For each
// (ci, kh) it loads the row's PX + K - 1 inputs once and reuses them for
// all K taps kw, and reads the 4 weights of a tap as one float4: for
// PX = 8, K = 3 that is 13 shared-memory loads per 96 FMAs.  The input
// halo tile ([pos][ci], rows padded by 4 floats so the rows a warp reads
// fall in distinct banks) and the weight slice ([kh, kw][ci][co], whose
// float4 rows a warp reads as one 128-byte line) are staged Cin chunk by
// Cin chunk into a two-stage ring with cp.async: 16-byte copies where the
// channel counts and pointers allow, 4-byte copies otherwise (Cin = 3, a
// misaligned view), halo and ragged edges zero-filled by the copy itself.
// The next chunk's copies are issued right after the one __syncthreads of
// each chunk and land while the current chunk is summed.  TH, PX, TCO and
// the chunk are chosen per shape by kernels/conv2d/conv2d.py conv_plan;
// none of them changes the order of any sum, so every plan gives the same
// bits.  The tile's row of inputs needs K at compile time: it is built
// for K = 1, 3, 5, 7, and the forward runs any other odd K on conv_kernel
// below.
//
// Fused backward design (conv_kernel, also the forward's before the
// redesign and still for K > 7): one block computes an 8x8 pixel tile of
// one image for a slice of TCO output channels (32, or 8 when Cout <= 8,
// e.g. the backward of layer 0 whose Cout' is 3).  The input halo tile
// (10x10 for K=3) and the matching weight slice are staged in shared
// memory Cin chunk by Cin chunk; each thread keeps TCO/4 pixel accumulators of one channel, so a
// warp reads one broadcast activation and 32 (or 8) consecutive weights
// per FMA step.  SAME padding and ragged channel counts (Cin = 3, Cout' =
// 3) are bounds checks on the loads and stores, never a padded copy.
//
// The fused backward decodes the prologue for its whole halo tile and all C
// channels once (unpool routing bit + mask bit, one byte per value) into
// shared memory and then loops over the S seeds, so every seed reuses the
// residual bytes the block loaded once — the paper's mask reuse.  The
// gated gradient exists only in shared memory.

#include "common.cuh"

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
  const dim3 grid(((a.h + TH - 1) / TH) * ((a.wd + TW - 1) / TW),
                  (a.cout + TCO - 1) / TCO, a.n);
  conv_kernel<TCO, FUSED><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool FUSED>
int dispatch(const ConvArgs& a, cudaStream_t stream) {
  const cudaError_t e = a.cout <= 8 ? launch<8, FUSED>(a, stream)
                                    : launch<32, FUSED>(a, stream);
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// Forward: register-tiled implicit GEMM with a two-stage cp.async ring.
// ---------------------------------------------------------------------------

constexpr int FW_TW = 8;             // tile width in pixels
constexpr int FW_MAX_THREADS = 256;  // kernels/conv2d/conv2d.py mirrors both

struct FwdArgs {
  const float* x;     // [N,H,W,Cin]
  const float* w;     // [K,K,Cin,Cout]
  const float* bias;  // [Cout] or null
  float* y;           // [N,H,W,Cout]
  int n, h, wd, cin, cout;
  int th, tco, cin_t;  // tile rows, Cout per block, Cin per stage
  int xstride;         // floats per staged halo position
  int stage;           // floats per ring stage (halo, then weights)
  int vec_x, vec_w, vec_y;  // 16-byte copies / stores allowed
};

// Asynchronous global -> shared copies; ok == false zero-fills the bytes.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int K, int PX>
__global__ void __launch_bounds__(FW_MAX_THREADS)
conv_igemm_kernel(FwdArgs a) {
  constexpr int P = (K - 1) / 2, XW = FW_TW + K - 1, NX = PX + K - 1;
  constexpr int GX = FW_TW / PX;  // threads across one tile row
  extern __shared__ float4 fw_smem4[];
  float* smem = reinterpret_cast<float*>(fw_smem4);
  const int th = a.th, cin_t = a.cin_t, tco = a.tco, xstride = a.xstride;
  const int XH = th + K - 1, xsz = XH * XW * xstride;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cg = tid % (tco / 4), pg = tid / (tco / 4);
  const int ty = pg / GX, px0 = (pg % GX) * PX;
  const int tiles_w = (a.wd + FW_TW - 1) / FW_TW;
  const int y0 = (blockIdx.x / tiles_w) * th;
  const int x0 = (blockIdx.x % tiles_w) * FW_TW;
  const int co0 = blockIdx.y * tco, nn = blockIdx.z;
  const float* xn = a.x + static_cast<size_t>(nn) * a.h * a.wd * a.cin;

  // Stage Cin channels [c0, c0 + cn) of the halo tile and the weights.
  auto load = [&](int s, int c0) {
    float* xs = smem + s * a.stage;
    float* ws = xs + xsz;
    const int cn = min(cin_t, a.cin - c0);
    if (a.vec_x) {  // Cin and cin_t are multiples of 4
      const int v4 = cn / 4;
      for (int e = tid; e < XH * XW * v4; e += nthr) {
        const int pos = e / v4, q = e - pos * v4;
        const int yy = y0 - P + pos / XW, xx = x0 - P + pos % XW;
        const bool ok = yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd;
        const float* src =
            ok ? xn + (static_cast<size_t>(yy) * a.wd + xx) * a.cin + c0 +
                     4 * q
               : a.x;
        cp_async16(xs + pos * xstride + 4 * q, src, ok);
      }
    } else {
      for (int e = tid; e < XH * XW * cn; e += nthr) {
        const int pos = e / cn, ci = e - pos * cn;
        const int yy = y0 - P + pos / XW, xx = x0 - P + pos % XW;
        const bool ok = yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd;
        const float* src =
            ok ? xn + (static_cast<size_t>(yy) * a.wd + xx) * a.cin + c0 + ci
               : a.x;
        cp_async4(xs + pos * xstride + ci, src, ok);
      }
    }
    if (a.vec_w) {  // Cout a multiple of 4: a float4 never straddles it
      const int v4 = tco / 4;
      for (int e = tid; e < K * K * cn * v4; e += nthr) {
        const int r = e / v4, q = e - r * v4;
        const int kk = r / cn, ci = r - kk * cn, o = co0 + 4 * q;
        const bool ok = o < a.cout;
        const float* src =
            ok ? a.w + (static_cast<size_t>(kk) * a.cin + c0 + ci) * a.cout +
                     o
               : a.w;
        cp_async16(ws + (kk * cin_t + ci) * tco + 4 * q, src, ok);
      }
    } else {
      for (int e = tid; e < K * K * cn * tco; e += nthr) {
        const int r = e / tco, q = e - r * tco;
        const int kk = r / cn, ci = r - kk * cn, o = co0 + q;
        const bool ok = o < a.cout;
        const float* src =
            ok ? a.w + (static_cast<size_t>(kk) * a.cin + c0 + ci) * a.cout +
                     o
               : a.w;
        cp_async4(ws + (kk * cin_t + ci) * tco + q, src, ok);
      }
    }
    cp_async_commit();
  };

  float acc[PX][4];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  const int nchunks = (a.cin + cin_t - 1) / cin_t;
  if (nchunks > 0) load(0, 0);
  for (int i = 0; i < nchunks; ++i) {
    cp_async_wait_all();
    // Chunk i has landed for every thread, and every thread is done with
    // chunk i - 1, whose stage the next copies overwrite.
    __syncthreads();
    if (i + 1 < nchunks) load((i + 1) & 1, (i + 1) * cin_t);
    const float* xs = smem + (i & 1) * a.stage;
    const float* xt = xs + (ty * XW + px0) * xstride;
    const float* wt = xs + xsz + 4 * cg;
    const int cn = min(cin_t, a.cin - i * cin_t);
#pragma unroll 2
    for (int ci = 0; ci < cn; ++ci) {
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        float xr[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j) xr[j] = xt[(kh * XW + j) * xstride + ci];
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float4 wv = *reinterpret_cast<const float4*>(
              wt + ((kh * K + kw) * cin_t + ci) * tco);
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            acc[p][0] = fmaf(xr[p + kw], wv.x, acc[p][0]);
            acc[p][1] = fmaf(xr[p + kw], wv.y, acc[p][1]);
            acc[p][2] = fmaf(xr[p + kw], wv.z, acc[p][2]);
            acc[p][3] = fmaf(xr[p + kw], wv.w, acc[p][3]);
          }
        }
      }
    }
  }

  const int yy = y0 + ty, o = co0 + 4 * cg;
  if (yy >= a.h || o >= a.cout) return;
  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.bias) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (o + j < a.cout) bv[j] = a.bias[o + j];
  }
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int xx = x0 + px0 + p;
    if (xx >= a.wd) break;
    float* dst =
        a.y + ((static_cast<size_t>(nn) * a.h + yy) * a.wd + xx) * a.cout + o;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = a.bias ? acc[p][j] + bv[j] : acc[p][j];
    if (a.vec_y) {  // Cout a multiple of 4, y 16-byte aligned
      *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (o + j < a.cout) dst[j] = r[j];
    }
  }
}

template <int K, int PX>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(a.stage);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_igemm_kernel<K, PX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = a.th * (FW_TW / PX) * (a.tco / 4);
  const dim3 grid(((a.h + a.th - 1) / a.th) * ((a.wd + FW_TW - 1) / FW_TW),
                  (a.cout + a.tco - 1) / a.tco, a.n);
  conv_igemm_kernel<K, PX><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_fwd_px(const FwdArgs& a, int px, cudaStream_t stream) {
  return px == 8 ? launch_fwd<K, 8>(a, stream) : launch_fwd<K, 4>(a, stream);
}

}  // namespace

REPRO_API int repro_conv2d_fwd(const float* x, const float* w,
                               const float* bias, float* y, int n, int h,
                               int wd, int cin, int cout, int k, int th,
                               int px, int tco, int cin_t,
                               cudaStream_t stream) {
  if (k != 1 && k != 3 && k != 5 && k != 7) {
    // Other odd K: the general kernel of the fused backward, in its
    // forward form, which tiles itself (the plan is not used).
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
  const int threads = th * (px > 0 ? FW_TW / px : 0) * (tco / 4);
  if ((px != 4 && px != 8) || tco < 4 || tco % 4 != 0 || th < 1 ||
      cin_t < 1 || threads > FW_MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{};
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
  a.vec_x = cin % 4 == 0 && cin_t % 4 == 0 &&
            reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_w = cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  a.vec_y = cout % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // Halo rows padded by 4 floats: 16-byte aligned, and the rows a warp
  // reads fall in distinct banks.
  a.xstride = (cin_t + 3) / 4 * 4 + 4;
  a.stage = (th + k - 1) * (FW_TW + k - 1) * a.xstride + k * k * cin_t * tco;
  cudaError_t e;
  switch (k) {
    case 1: e = launch_fwd_px<1>(a, px, stream); break;
    case 3: e = launch_fwd_px<3>(a, px, stream); break;
    case 5: e = launch_fwd_px<5>(a, px, stream); break;
    default: e = launch_fwd_px<7>(a, px, stream); break;
  }
  return static_cast<int>(e);
}

REPRO_API int repro_conv2d_bwd_fused(const float* g, const float* wt,
                                     const uint8_t* pool_idx,
                                     const uint8_t* mask,
                                     const uint8_t* omask, float* out, int s,
                                     int n, int h, int wd, int c, int cout,
                                     int k, int gate_in, int gate_out,
                                     int method, cudaStream_t stream) {
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
