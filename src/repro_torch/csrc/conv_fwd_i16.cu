// The int16 instances of the tiled conv forward (conv_fwd.cuh
// conv_igemm_kernel<int16_t, K, PX>, B7), for repro_conv2d_fxp_fwd in
// conv2d_fxp.cu.  They are compiled here, in their own nvcc process, so the
// library builds them in parallel with the int16 fused backward's.

#include "conv_fwd.cuh"

namespace repro {

cudaError_t conv_fwd_tiled_i16(const int16_t* x, const int16_t* w,
                               const int16_t* bias, int16_t* y, int n, int h,
                               int wd, int cin, int cout, int k, int th,
                               int px, int tco, int cin_t,
                               cudaStream_t stream) {
  fwd::Args<int16_t> a{};
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
  return fwd::launch_tiled(a, k, px, stream);
}

}  // namespace repro
