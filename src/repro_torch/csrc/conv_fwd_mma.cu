// The bf16 conv forward on the tensor cores (B1 in bf16 where Cin is a
// multiple of 16), called by repro_conv2d_fwd_bf16 (conv_fwd_bf16.cu) for
// the plans kernels/conv2d/conv2d.py conv_bf16_plan gives such layers
// (ConvMmaPlan); NHWC x HWIO, stride 1, SAME.
//
// Replaces: src/repro/kernels/conv2d/conv2d.py, conv2d_pallas on bf16 x and
// w (the JAX package's precision="bf16" path), with the bias the reference
// adds after the call in the epilogue:
//
//   y[n] = bf16(f32(bf16(conv(x[n], w))) + f32(b))
//
// Bound on an H100: bytes.  Layers 1-3 of Table III are 1.51 GFLOP an
// explain at batch 32, 1.5 us at the 989 TFLOP/s of the bf16 tensor cores,
// under the 2.4 us their 8.0 MB take at 3.35 TB/s; on FFMA (the
// conv_igemm_kernel<__nv_bfloat16> instance, 13 shared loads and 12 unpack
// ops a 96 FMA) the same products cannot take less than 22.5 us.  So the
// products run on mma.sync.m16n8k16 (bf16 in, f32 sums), which leaves the
// kernel bound by its copies; wgmma (64-row warpgroup tiles, asynchronous)
// is not needed for that and is not used: mma.sync on ldmatrix fragments
// is the simple kernel that is right.
//
// Design: an implicit GEMM, pixels x Cout by a depth of K*K*Cin, in k
// steps of one tap (kh, kw) over 16 consecutive input channels.  A block
// computes a th x 16 pixel tile of one image for tco output channels
// (a multiple of 32); each warp mt rows (1 or 2 m16 fragments, a row of 16
// pixels each) x 32 channels (4 n8 fragments).  The A fragment of a row at
// tap (kh, kw) is read by ldmatrix straight from the staged NHWC halo tile
// at (y + kh, x + kw): 16 pixels' rows of 32 bytes, the halo position
// stride padded to an odd multiple of 16 bytes, so the 8 rows of an 8x8
// matrix fall in distinct banks.  B comes from the staged [kh, kw][ci][co]
// weight slice by ldmatrix.trans, its row stride padded likewise.  The halo
// and weights are staged Cin chunk by Cin chunk (cin_t, a multiple of 16)
// into a cp.async ring, two stages where Cin takes more than one chunk:
// conv_fwd.cuh's loader, halo and ragged edges zero-filled by the copy.
//
// Fixed K order: each output's sum walks the 16-channel groups in order,
// and within a group the taps (kh, kw) in order; a group's K*K products go
// into a fresh accumulator that is then added to the running f32 sum
// (promotion: the tensor cores' accumulation, whose rounding need not be an
// FFMA chain's, never runs longer than one group, 9 k steps at K = 3).  No
// split of K across warps, and the ring's chunk only batches whole groups,
// so no tile plan changes a bit.  The order is not the FFMA instance's,
// so the two routes agree within one bf16 rounding step, not bitwise.
// Launched with programmatic dependent launch, as the ReLU / pool template
// is: the blocks may be scheduled while the kernel before drains.

#include "common.cuh"
#include "mma.cuh"

namespace {
namespace cmma {

using T = __nv_bfloat16;

constexpr int TW = 16;            // pixels of a tile row: one m16 fragment
constexpr int WN = 32;            // output channels a warp: four n8 fragments
constexpr int MAX_THREADS = 256;  // kernels/conv2d/conv2d.py mirrors all three

struct Args {
  const T* x;     // [N,H,W,Cin]
  const T* w;     // [K,K,Cin,Cout]
  const T* bias;  // [Cout] or null
  T* y;           // [N,H,W,Cout]
  int n, h, wd, cin, cout;
  int th, tco, cin_t;  // tile rows, Cout per block, Cin per stage
  int xstride;         // elements per staged halo position
  int wstride;         // elements per staged weight row
  int stage;           // elements per ring stage (halo, then weights)
  int stages;          // 1, or 2 where Cin takes more than one chunk
  int vb_x, vb_w;      // bytes per copy (0: ordinary loads)
  int vec_y;           // two-element stores allowed
};

template <int K, int MT>
__global__ void __launch_bounds__(MAX_THREADS) conv_mma_kernel(Args a) {
  constexpr int P = (K - 1) / 2, XW = TW + K - 1;
  extern __shared__ float4 cm_smem4[];
  T* smem = reinterpret_cast<T*>(cm_smem4);
  const int th = a.th, cin_t = a.cin_t, tco = a.tco;
  const int xstride = a.xstride, wstride = a.wstride;
  const int XH = th + K - 1, xsz = XH * XW * xstride;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wrows = th / MT;                  // warps down the tile
  const int r0 = (warp % wrows) * MT;         // the warp's first tile row
  const int n0 = (warp / wrows) * WN;         // and first channel
  const int tiles_w = (a.wd + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * th;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * tco, nn = blockIdx.z;
  const T* xn = a.x + static_cast<size_t>(nn) * a.h * a.wd * a.cin;
  // Launched with programmatic stream serialization, the grid may start
  // while the kernel before it drains: wait for its writes before a load.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // Stage Cin channels [c0, c0 + cn) of the halo tile and the weights, as
  // conv_fwd.cuh's loader does, with this kernel's padded strides.
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
        repro::stage_copy(ws + (kk * cin_t + ci) * wstride + q * E, src, ok,
                          VB);
      }
    });
    repro::cp_async_commit();
  };

  float run[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) run[m][j][q] = 0.f;

  // This lane's ldmatrix rows: A, pixel lane % 16 of a row, channels
  // 8 * (lane / 16) on; B, k row (lane % 8) + 8 * (lane / 8 % 2), columns
  // 8 * (lane / 16) on (matrices: k 0-7 and 8-15 of n8 tiles 0, then 1).
  const int a_off = (lane & 15) * xstride + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * wstride + n0 +
                    (lane >> 4) * 8;

  const int nchunks = (a.cin + cin_t - 1) / cin_t;
  if (nchunks > 0) load(0, 0);
  for (int i = 0; i < nchunks; ++i) {
    repro::cp_async_wait_all();
    // Chunk i has landed for every thread, and every thread is done with
    // chunk i - 1, whose stage the next copies overwrite.
    __syncthreads();
    if (i + 1 < nchunks) load((i + 1) % a.stages, (i + 1) * cin_t);
    const T* xs = smem + (i % a.stages) * a.stage;
    const T* ws = xs + xsz;
    const int groups = min(cin_t, a.cin - i * cin_t) / 16;
    for (int g = 0; g < groups; ++g) {
      float acc[MT][4][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          uint32_t af[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            repro::ldmatrix_x4(
                af[m], xs + ((r0 + m + kh) * XW + kw) * xstride + g * 16 +
                           a_off);
          uint32_t b01[4], b23[4];
          const T* wb = ws + ((kh * K + kw) * cin_t + g * 16) * wstride +
                        b_off;
          repro::ldmatrix_x4_trans(b01, wb);
          repro::ldmatrix_x4_trans(b23, wb + 16);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            repro::mma_bf16(acc[m][0], af[m], b01[0], b01[1]);
            repro::mma_bf16(acc[m][1], af[m], b01[2], b01[3]);
            repro::mma_bf16(acc[m][2], af[m], b23[0], b23[1]);
            repro::mma_bf16(acc[m][3], af[m], b23[2], b23[3]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) run[m][j][q] += acc[m][j][q];
    }
  }

  // Epilogue: D rows lane / 4 and lane / 4 + 8 are pixels of the row,
  // columns 2 * (lane % 4) and the next are two channels of each n8 tile.
  using Tr = repro::Traits<T>;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int yy = y0 + r0 + m;
    if (yy >= a.h) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int xx = x0 + (lane >> 2) + 8 * half;
      if (xx >= a.wd) continue;
      T* dst = a.y +
               ((static_cast<size_t>(nn) * a.h + yy) * a.wd + xx) * a.cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = co0 + n0 + 8 * j + 2 * (lane & 3);
        float v0 = run[m][j][2 * half], v1 = run[m][j][2 * half + 1];
        if (a.bias) {
          if (o < a.cout) v0 = Tr::add_bias(v0, a.bias[o]);
          if (o + 1 < a.cout) v1 = Tr::add_bias(v1, a.bias[o + 1]);
        }
        if (a.vec_y && o + 1 < a.cout) {  // Cout even, y 4-byte aligned
          *reinterpret_cast<uint32_t*>(dst + o) = repro::bf16_pack(v0, v1);
        } else {
          if (o < a.cout) dst[o] = __float2bfloat16_rn(v0);
          if (o + 1 < a.cout) dst[o + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int K, int MT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * static_cast<size_t>(a.stages) * static_cast<size_t>(a.stage);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_mma_kernel<K, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // the batch rides gridDim.z, a chunk of at most kBatchChunk images a launch
  return repro::for_batch_chunks(a.n, [&](int n0, int nb) {
    Args b = a;
    b.x = a.x + static_cast<size_t>(n0) * a.h * a.wd * a.cin;
    b.y = a.y + static_cast<size_t>(n0) * a.h * a.wd * a.cout;
    b.n = nb;
    return repro::launch_pdl(
        conv_mma_kernel<K, MT>,
        dim3(((a.h + a.th - 1) / a.th) * ((a.wd + TW - 1) / TW),
             (a.cout + a.tco - 1) / a.tco, nb),
        dim3(32 * (a.th / MT) * (a.tco / WN)), smem, stream, 0, b);
  });
}

template <int K>
cudaError_t launch_mt(const Args& a, int mt, cudaStream_t stream) {
  return mt == 2 ? launch<K, 2>(a, stream) : launch<K, 1>(a, stream);
}

}  // namespace cmma
}  // namespace

namespace repro {

// Check the plan (ConvMmaPlan's rules), lay out shared memory as
// ConvMmaPlan.smem_bytes does, choose the copy widths, launch.
cudaError_t conv_fwd_mma_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                              const __nv_bfloat16* bias, __nv_bfloat16* y,
                              int n, int h, int wd, int cin, int cout, int k,
                              int th, int mt, int tco, int cin_t,
                              cudaStream_t stream) {
  using cmma::T;
  if ((k != 1 && k != 3 && k != 5 && k != 7) || (mt != 1 && mt != 2) ||
      th < mt || th % mt != 0 || tco < cmma::WN || tco % cmma::WN != 0 ||
      cin < 16 || cin % 16 != 0 || cin_t < 16 || cin_t % 16 != 0 ||
      32 * (th / mt) * (tco / cmma::WN) > cmma::MAX_THREADS)
    return cudaErrorInvalidValue;
  cmma::Args a{};
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
  // 16 bytes of padding: a row stride of an odd number of 16-byte units
  a.xstride = cin_t + 8;
  a.wstride = tco + 8;
  a.stage = (th + k - 1) * (cmma::TW + k - 1) * a.xstride +
            k * k * cin_t * a.wstride;
  a.stages = cin_t >= cin ? 1 : 2;
  a.vb_x = copy_bytes<T>(x, cin, cin_t);
  a.vb_w = copy_bytes<T>(w, cout, tco);
  a.vec_y = cout % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 4 == 0;
  switch (k) {
    case 1: return cmma::launch_mt<1>(a, mt, stream);
    case 3: return cmma::launch_mt<3>(a, mt, stream);
    case 5: return cmma::launch_mt<5>(a, mt, stream);
    default: return cmma::launch_mt<7>(a, mt, stream);
  }
}

}  // namespace repro
