// repro_conv2d_fwd_bf16: B1 on bf16 operands, by one of two routes the
// caller's plan names (kernels/conv2d/conv2d.py conv_bf16_plan): the
// tensor-core kernel of conv_fwd_mma.cu (route 1, ConvMmaPlan; layers whose
// Cin is a multiple of 16), or the FFMA instances of the tiled conv forward
// (conv_fwd.cuh conv_igemm_kernel<__nv_bfloat16, K, PX>, route 0, ConvPlan;
// Table III's layer 0, Cin = 3, where it beats cuDNN's bf16 conv).  The
// FFMA instances are compiled here, in their own nvcc process, in parallel
// with the f32, int16 and tensor-core files.
//
// Replaces: src/repro/kernels/conv2d/conv2d.py, conv2d_pallas on bf16 x and
// w (the JAX package's precision="bf16" path), with the bias the reference
// adds after the call (src/repro/models/cnn.py:161) in the epilogue.
//
//   y[n] = bf16(f32(bf16(conv(x[n], w))) + f32(b))
//
// FFMA route.  Bound on an H100: the f32 instance's multiply-adds (FFMA on
// the CUDA cores; no tensor cores, so the f32 sum and its order are the f32
// kernel's), on half the bytes.  Design: the f32 tile and ring with bf16
// stages, half the bytes a stage (conv_plan(esize=2) sizes the chunk); each
// input widened to f32 where it is read from shared memory, the 4 weights of
// a tap read as one 8-byte vector and widened; the sum rounded to nearest
// even at the store (repro::Traits<__nv_bfloat16>).  Each output is one
// thread's chain over (ci, kh, kw), so no plan changes a bit.  Built for
// K = 1, 3, 5, 7; there is no general bf16 kernel, so any other K, and the
// general plan of zeros, are refused (the wrapper raises first).

#include "conv_fwd.cuh"
#include "mma.cuh"

// route 1: the plan (th, mt, tco, cin_t) of ConvMmaPlan (p = rows a warp);
// route 0: the plan (th, px, tco, cin_t) of ConvPlan (p = pixels a thread).
REPRO_API int repro_conv2d_fwd_bf16(const __nv_bfloat16* x,
                                    const __nv_bfloat16* w,
                                    const __nv_bfloat16* bias,
                                    __nv_bfloat16* y, int n, int h, int wd,
                                    int cin, int cout, int k, int route,
                                    int th, int p, int tco, int cin_t,
                                    cudaStream_t stream) {
  if (k != 1 && k != 3 && k != 5 && k != 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1)
    return static_cast<int>(repro::conv_fwd_mma_bf16(
        x, w, bias, y, n, h, wd, cin, cout, k, th, p, tco, cin_t, stream));
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  fwd::Args<__nv_bfloat16> a{};
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
  return static_cast<int>(fwd::launch_tiled(a, k, p, stream));
}
