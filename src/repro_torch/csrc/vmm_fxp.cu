// True-int16 FC matmul, forward and fused backward (paper §IV: the 16-bit
// fixed-point datapath).
//
// Replaces: src/repro/kernels/vmm/fxp.py, vmm_fxp_pallas (repro_vmm_fxp_fwd)
// and vmm_bwd_fused_fxp_pallas (repro_vmm_bwd_fused_fxp, the template of
// vmm_bwd.cuh).
//
//   forward:  y[M, N] = sat_add(requantize(x[M, K] @ w[K, N]), b[N])
//   backward: out[s] = gate_out(requantize(gate_in(g[s]) @ wt)),
//             g [S, M, K], wt [K, N] = W^T made contiguous once by the
//             caller; the 1-bit masks [M, ceil(K/8)] and [M, ceil(N/8)]
//             have no seeds axis.
//
// Operands are int16 (Q7.8 activations and gradients, Q1.14 weights);
// products accumulate in a uint32_t so the sum wraps modulo 2^32 as the
// reference's int32 dot does (4096 products of up to 2^30 can pass 2^31 in
// FC0).  One requantize narrows the accumulator; the bias is added with
// saturation after it (forward), the epilogue gate runs after it
// (backward, fxp.py:106-112).
//
// Bound on an H100: integer multiply-adds, IMAD on the CUDA cores (Hopper
// has no int16 tensor-core MMA; 64 per SM per clock, about 16.7 T/s at
// 132 SMs and 1.98 GHz).  The forward [32, 4096] @ [4096, 128] does 16.8 M
// of them on 1.3 MB, about 1.0 us against 0.4 us of HBM traffic; the
// backward at S=3 seeds, [96, 128] @ [128, 4096], up to 50 M on 1.8 MB.
// At these sizes the floor is the card's parallelism, not either roof: a
// 16 x 16 output tile a block would put FC0's 4096-deep sums on 16 of the
// 132 SMs.
//
// Forward design (repro_vmm_fxp_fwd: vmm_fxp_splitk_kernel, and
// vmm_fxp_splitk_sum_kernel where K is split): split-K, the f32 forward's
// design (vmm.cu vmm_splitk_kernel) on int16.  A block owns a 32 x 32
// output tile and one slice of K (a multiple of 32 long; the caller picks
// the number of slices and their length, kernels/vmm/vmm.py vmm_splits and
// vmm_slice): at FC0 64 slices x 4 column tiles = 256 blocks, so the 1 MB
// weight streams through every SM.  Each 32-deep chunk is read as 16-byte
// vectors of 8 int16 (one of x and one of w a thread), widened to 32-bit
// words as it is stored to shared memory, and summed from there: each of
// the 128 threads keeps a 2-row x 4-column uint32_t tile and reads 4
// weights as one uint4 and its 2 x values as broadcasts, 8 IMADs per 3
// shared loads, summing its K in order.  The next chunk is loaded into
// registers while the current one is summed.  With one slice the block
// requantizes, adds the bias with saturation and writes y.  With more it
// writes its int32 partial tile to a workspace [splits, M, N] (torch.empty
// in the wrapper), and a second kernel launched by the same entry point,
// vmm_fxp_splitk_sum_kernel, sums the slices in slice order, requantizes
// and adds the bias.  The partial sums wrap modulo 2^32 like the single
// sum, and wrapping addition is associative, so no split changes a bit.
//
// Backward design (repro_vmm_bwd_fused_fxp): the f32 backward's tiled
// template (vmm_bwd.cuh vmm_bwd_tiled_kernel<int16_t, RM>), the gated
// gradient and the weight chunk widened to 32-bit words in its prologue,
// IMAD on uint32_t, requantize then the epilogue gate.  The plan of zeros
// runs the general kernel, vmm_fxp_kernel (the forward's before the
// split-K redesign, and the backward's until the tiled one): the 16x16
// shared-memory tile of vmm.cu vmm_kernel with int16 tiles and 32-bit
// accumulators.  Both wrap modulo 2^32, so every plan gives the plain
// version's bits.  No atomics: every output is one deterministic sum.

#include "common.cuh"
#include "vmm_bwd.cuh"

namespace {

constexpr int T = 16;

__global__ void __launch_bounds__(T * T)
vmm_fxp_kernel(const int16_t* __restrict__ a, const int16_t* __restrict__ b,
               const int16_t* __restrict__ bias,
               const uint8_t* __restrict__ mask,
               const uint8_t* __restrict__ omask, int16_t* __restrict__ out,
               int m, int k, int n, int gate_in, int gate_out, int method) {
  __shared__ int16_t as[T][T + 2];
  __shared__ int16_t bs[T][T + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * T + ty, col = blockIdx.x * T + tx;
  a += static_cast<size_t>(blockIdx.z) * m * k;
  out += static_cast<size_t>(blockIdx.z) * m * n;
  const uint8_t* mrow =
      mask ? mask + static_cast<size_t>(row) * ((k + 7) / 8) : nullptr;
  uint32_t acc = 0u;
  for (int k0 = 0; k0 < k; k0 += T) {
    const int ka = k0 + tx;
    int v = 0;
    if (row < m && ka < k) {
      v = a[static_cast<size_t>(row) * k + ka];
      if (gate_in) v = repro::gate(v, repro::mask_bit(mrow, ka), method);
    }
    as[ty][tx] = static_cast<int16_t>(v);
    const int kb = k0 + ty;
    bs[ty][tx] = (kb < k && col < n) ? b[static_cast<size_t>(kb) * n + col]
                                     : int16_t(0);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < T; ++q) {
      // |a * b| <= 2^30: the product fits; the sum wraps.
      acc += static_cast<uint32_t>(static_cast<int>(as[ty][q]) *
                                   static_cast<int>(bs[q][tx]));
    }
    __syncthreads();
  }
  if (row < m && col < n) {
    int o = repro::requantize(acc);
    if (bias) o = repro::sat16(o + bias[col]);
    if (gate_out) {
      const uint8_t* orow =
          omask ? omask + static_cast<size_t>(row) * ((n + 7) / 8) : nullptr;
      o = repro::gate(o, repro::mask_bit(orow, col), method);
    }
    out[static_cast<size_t>(row) * n + col] = static_cast<int16_t>(o);
  }
}

// Split-K forward: tile, chunk and block shape, those of the f32 forward
// (kernels/vmm/vmm.py SPLIT_TILE_M, SPLIT_TILE_N and SPLIT_CHUNK_K).
constexpr int SK_BM = 32, SK_BN = 32, SK_KC = 32, SK_THREADS = 128;
constexpr int SK_XS = SK_KC + 4;  // x row stride in words: no bank conflict
constexpr int SK_V = 8;           // int16 values in a 16-byte vector

// Two int16 bit patterns as one word, the first in the low half.
__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | static_cast<uint32_t>(hi) << 16;
}

// The 8 int16 values of a 16-byte vector as 32-bit words, sign-extended.
__device__ __forceinline__ void widen8(const uint4 v, uint32_t* out) {
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = static_cast<uint32_t>(
        static_cast<int>(static_cast<int16_t>(q[i] & 0xffffu)));
    out[2 * i + 1] = static_cast<uint32_t>(static_cast<int>(q[i]) >> 16);
  }
}

// One block: output rows [m0, m0 + 32) x columns [n0, n0 + 32) over the K
// slice [kb, ke).  part == nullptr: write y (requantized, + bias); else
// write the int32 partial tile to part[blockIdx.z].
__global__ void __launch_bounds__(SK_THREADS)
vmm_fxp_splitk_kernel(const int16_t* __restrict__ x,
                      const int16_t* __restrict__ w,
                      const int16_t* __restrict__ bias,
                      int16_t* __restrict__ y, int32_t* __restrict__ part,
                      int m, int k, int n, int ks, int vec_x, int vec_w) {
  __shared__ __align__(16) uint32_t xs[SK_BM * SK_XS];
  __shared__ __align__(16) uint32_t ws[SK_KC * SK_BN];
  const int tid = threadIdx.x, tc = tid % (SK_BN / 4), tr = tid / (SK_BN / 4);
  const int n0 = blockIdx.x * SK_BN, m0 = blockIdx.y * SK_BM;
  const int kb = blockIdx.z * ks, ke = min(k, kb + ks);
  static_assert(SK_KC * SK_BN / SK_V == SK_THREADS &&
                    SK_BM * SK_KC / SK_V == SK_THREADS,
                "one vector of w and one of x a thread per chunk");
  // This thread's vector of a chunk: w row wk, columns [wc, wc + 8); x row
  // xr, K [xk, xk + 8).
  const int wk = tid / (SK_BN / SK_V), wc = SK_V * (tid % (SK_BN / SK_V));
  const int xrow = tid / (SK_KC / SK_V), xk = SK_V * (tid % (SK_KC / SK_V));

  uint4 wv, xv;  // 8 int16 each, in flight while the block sums
  auto fetch = [&](int k0) {
    const int kk = k0 + wk, c = n0 + wc;
    wv = make_uint4(0u, 0u, 0u, 0u);
    if (kk < ke) {
      const int16_t* src = w + static_cast<size_t>(kk) * n + c;
      if (vec_w && c < n) {  // vec_w: N % 8 == 0, so c + 7 < n
        wv = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint16_t e[SK_V];
#pragma unroll
        for (int j = 0; j < SK_V; ++j)
          e[j] = c + j < n ? static_cast<uint16_t>(__ldg(src + j)) : 0;
        wv = make_uint4(pack2(e[0], e[1]), pack2(e[2], e[3]),
                        pack2(e[4], e[5]), pack2(e[6], e[7]));
      }
    }
    const int r = m0 + xrow, kx = k0 + xk;
    xv = make_uint4(0u, 0u, 0u, 0u);
    if (r < m) {
      const int16_t* src = x + static_cast<size_t>(r) * k + kx;
      if (vec_x && kx < ke) {  // vec_x: K % 8 == 0, so kx + 7 < ke
        xv = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint16_t e[SK_V];
#pragma unroll
        for (int j = 0; j < SK_V; ++j)
          e[j] = kx + j < ke ? static_cast<uint16_t>(__ldg(src + j)) : 0;
        xv = make_uint4(pack2(e[0], e[1]), pack2(e[2], e[3]),
                        pack2(e[4], e[5]), pack2(e[6], e[7]));
      }
    }
  };
  auto stash = [&]() {
    uint32_t u[SK_V];
    widen8(wv, u);
    uint4* wd = reinterpret_cast<uint4*>(&ws[wk * SK_BN + wc]);
    wd[0] = make_uint4(u[0], u[1], u[2], u[3]);
    wd[1] = make_uint4(u[4], u[5], u[6], u[7]);
    widen8(xv, u);
    uint4* xd = reinterpret_cast<uint4*>(&xs[xrow * SK_XS + xk]);
    xd[0] = make_uint4(u[0], u[1], u[2], u[3]);
    xd[1] = make_uint4(u[4], u[5], u[6], u[7]);
  };

  uint32_t acc[2][4] = {};
  if (kb < ke) fetch(kb);
  for (int k0 = kb; k0 < ke; k0 += SK_KC) {
    stash();
    __syncthreads();
    if (k0 + SK_KC < ke) fetch(k0 + SK_KC);   // in flight while we sum
#pragma unroll
    for (int kk = 0; kk < SK_KC; ++kk) {
      const uint4 b4 =
          reinterpret_cast<const uint4*>(ws)[kk * (SK_BN / 4) + tc];
      const uint32_t a0 = xs[(2 * tr) * SK_XS + kk];
      const uint32_t a1 = xs[(2 * tr + 1) * SK_XS + kk];
      // |a * b| <= 2^30: the product fits; the sum wraps.
      acc[0][0] += a0 * b4.x;
      acc[0][1] += a0 * b4.y;
      acc[0][2] += a0 * b4.z;
      acc[0][3] += a0 * b4.w;
      acc[1][0] += a1 * b4.x;
      acc[1][1] += a1 * b4.y;
      acc[1][2] += a1 * b4.z;
      acc[1][3] += a1 * b4.w;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + 2 * tr + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tc + j;
      if (c >= n) continue;
      if (part) {
        part[(static_cast<size_t>(blockIdx.z) * m + r) * n + c] =
            static_cast<int32_t>(acc[i][j]);
      } else {
        int o = repro::requantize(acc[i][j]);
        if (bias) o = repro::sat16(o + bias[c]);
        y[static_cast<size_t>(r) * n + c] = static_cast<int16_t>(o);
      }
    }
  }
}

// Second pass of the split-K forward: y = the slices summed in slice order
// (wrapping), requantized, + bias with saturation; one thread per output.
__global__ void vmm_fxp_splitk_sum_kernel(const int32_t* __restrict__ part,
                                          const int16_t* __restrict__ bias,
                                          int16_t* __restrict__ y, int m,
                                          int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * n) return;
  const size_t mn = static_cast<size_t>(m) * n;
  uint32_t s = static_cast<uint32_t>(part[i]);
#pragma unroll 8
  for (int z = 1; z < splits; ++z)
    s += static_cast<uint32_t>(part[z * mn + i]);
  int o = repro::requantize(s);
  if (bias) o = repro::sat16(o + bias[i % n]);
  y[i] = static_cast<int16_t>(o);
}

}  // namespace

REPRO_API int repro_vmm_fxp_fwd(const int16_t* x, const int16_t* w,
                                const int16_t* bias, int16_t* y, int m, int k,
                                int n, int32_t* part, int splits, int ks,
                                cudaStream_t stream) {
  // splits slices of K, each ks long (a whole number of chunks), none
  // empty: kernels/vmm/fxp.py vmm_fxp_with_splits chooses both.
  if (splits < 1 || ks < SK_KC || ks % SK_KC != 0 ||
      static_cast<long long>(splits) * ks < k ||
      (splits > 1 && (part == nullptr || (splits - 1) * ks >= k)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_x = k % SK_V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = n % SK_V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((n + SK_BN - 1) / SK_BN, (m + SK_BM - 1) / SK_BM, splits);
  vmm_fxp_splitk_kernel<<<grid, SK_THREADS, 0, stream>>>(
      x, w, bias, y, splits > 1 ? part : nullptr, m, k, n, ks, vec_x, vec_w);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int threads = 256, blocks = (m * n + threads - 1) / threads;
    vmm_fxp_splitk_sum_kernel<<<blocks, threads, 0, stream>>>(part, bias, y,
                                                              m, n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_API int repro_vmm_bwd_fused_fxp(const int16_t* g, const int16_t* wt,
                                      const uint8_t* mask,
                                      const uint8_t* omask, int16_t* out,
                                      int s, int m, int k, int n, int gate_in,
                                      int gate_out, int method, int br,
                                      int bn, int kc, int rm,
                                      cudaStream_t stream) {
  // the f32 backward's plan (kernels/vmm/vmm.py vmm_bwd_plan); all 0: the
  // general kernel
  if (br != 0 || bn != 0 || kc != 0 || rm != 0)
    return static_cast<int>(vbwd::launch_tiled<int16_t>(
        g, wt, mask, omask, out, s, m, k, n, gate_in, gate_out, method, br,
        bn, kc, rm, stream));
  const dim3 grid((n + T - 1) / T, (m + T - 1) / T, s), block(T, T);
  vmm_fxp_kernel<<<grid, block, 0, stream>>>(g, wt, nullptr, mask, omask, out,
                                             m, k, n, gate_in, gate_out,
                                             method);
  return static_cast<int>(cudaGetLastError());
}
