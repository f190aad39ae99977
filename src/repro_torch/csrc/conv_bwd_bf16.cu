// repro_conv2d_bwd_fused_bf16: B5 on bf16 gradients and weights, by one of
// two routes the caller's plan names (kernels/conv2d/conv2d.py
// conv_bwd_bf16_plan): the tensor-core kernel of conv_bwd_mma.cu (route 1,
// ConvBwdMmaPlan; C a multiple of 16, every Table III layer), or the bf16
// instances of the tiled fused conv backward (conv_bwd.cuh
// conv_bwd_igemm_kernel<__nv_bfloat16, K, PX, SG>, route 0, ConvBwdPlan;
// any other C).  The FFMA instances are compiled here, in their own nvcc
// process, in parallel with the f32, int16 and tensor-core files.
//
// Replaces: src/repro/kernels/conv2d/conv2d.py, conv2d_bwd_fused_pallas on
// a bf16 gradient (the JAX package's precision="bf16" path).
//
//   out[s, n] = bf16(gate_out(conv(gate_in(unpool(g[s, n])), wt)))
//
// The unpool and the Eq. 3-5 gate select bf16 values (exact); the conv sums
// them in f32; the epilogue gate acts on the f32 sum, and the result is
// rounded to nearest even at the store, as the reference gates its f32
// accumulator before .astype(bf16) (conv2d.py:143-146).
//
// FFMA route.  Bound on an H100: the f32 instance's multiply-adds, counted
// on the nonzero gated inputs.  Design: the f32 template with bf16 landing
// buffers and weight stages (half the bytes a stage; conv_bwd_plan(esize=2)
// sizes the chunk): the prologue widens each gated value to an f32 word of
// the compute buffer, the weights are widened as they are read, and the
// inner loop is the f32 one, so each output is the same chain over
// (ci, kh, kw) under every plan.  Built for K = 1, 3, 5, 7; there is no
// general bf16 kernel, so any other K, and the general plan of zeros, are
// refused (the wrapper raises first).

#include "conv_bwd.cuh"
#include "mma.cuh"

// route 1: the plan (th, mt, tco, cin_t, sg, st) of ConvBwdMmaPlan (p = rows
// a warp); route 0: the plan (th, px, tco, cin_t, sg, st) of ConvBwdPlan (p =
// pixels a thread).
REPRO_API int repro_conv2d_bwd_fused_bf16(
    const __nv_bfloat16* g, const __nv_bfloat16* wt, const uint8_t* pool_idx,
    const uint8_t* mask, const uint8_t* omask, __nv_bfloat16* out, int s,
    int n, int h, int wd, int c, int cout, int k, int gate_in, int gate_out,
    int method, int route, int th, int p, int tco, int cin_t, int sg, int st,
    cudaStream_t stream) {
  if (k != 1 && k != 3 && k != 5 && k != 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1)
    return static_cast<int>(repro::conv_bwd_mma_bf16(
        g, wt, pool_idx, mask, omask, out, s, n, h, wd, c, cout, k, gate_in,
        gate_out, method, th, p, tco, cin_t, sg, st, stream));
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  bwd::Args<__nv_bfloat16> b{};
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
  return static_cast<int>(bwd::launch_tiled(b, k, p, sg, stream));
}
