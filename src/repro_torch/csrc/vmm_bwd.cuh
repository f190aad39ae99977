// The tiled fused FC backward (paper §III.C, §III.E, Fig. 4), one template
// for the f32 kernel B6 (vmm.cu, repro_vmm_bwd_fused) and the int16 kernel
// B10 (vmm_fxp.cu, repro_vmm_bwd_fused_fxp).  B6 in bf16 runs on the tensor
// cores instead (vmm_bwd_bf16.cu).
//
//   out[s] = gate_out(finish(gate_in(g[s]) @ wt)),  g [S, M, K], wt [K, N]
//
// finish is the identity in f32 and the requantize to Q7.8 in int16 (before
// the epilogue gate, as src/repro/kernels/vmm/fxp.py:106-112 does).  The
// 1-bit masks [M, ceil(K/8)] and [M, ceil(N/8)] have no seeds axis.
//
// Bound on an H100: multiply-adds on the CUDA cores (FFMA, or IMAD at half
// its rate: no TF32, no int16 MMA).  FC0's launch of the seed-batched
// explain, [3, 32, 128] gated @ [128, 4096], does 50 M of them on 2.6 MB
// (f32): 1.5 us of FFMA, 3.0 us of IMAD, against 0.8 us of HBM traffic.
// The design before this one (vmm.cu vmm_kernel, vmm_fxp.cu
// vmm_fxp_kernel, still the general route) kept one output a thread in a
// 16 x 16 tile: two shared loads per multiply-add, nothing in flight while
// it summed, and each weight tile fetched again by every block of rows.
//
// Design: the seeds fold into rows, g read as [S*M, K]; output row r reads
// mask row r mod M, so every seed shares the stored bits.  A block owns a
// br x bn tile of the [S*M, N] output and walks K in kc-deep chunks through
// a two-stage ring of cp.async copies (16, 8 or 4 bytes where K or N, the
// chunk or tile and the pointer allow, the width chosen once per launch and
// made a compile-time constant of each copy loop; ordinary loads
// otherwise: K = 13, or a view off its alignment).  cp.async copies bytes
// and cannot gate, so each chunk has a prologue step between its two
// barriers: the block gates the landing g chunk into the compute buffer,
// transposed to [k][row] words (Eq. 3-5, one mask byte read per 8 k for all
// of a row's k), int16 widened to 32-bit words there as B7/B9 do, and for
// int16 the weight chunk widened too.  The next chunk's copies are issued
// right after the first barrier and land while the chunk is gated and
// summed.  Each thread keeps an RM x 4 register tile (RM rows, 4 columns):
// per k it reads its RM gated values as one vector and its 4 weights as
// one, RM * 4 multiply-adds per 2 shared loads.
//
// What bounds it at FC0 on an H100: not the multiply-adds.  Issuing a
// chunk's copies waits on what the SM has in flight from L2 (each tile
// reads its weight slab and its rows: 6-16 MB of L2 traffic a launch,
// by the tile), and the sums of a few warps a scheduler stall on their
// shared loads; the two add up, as the copies are issued by the warps
// that then sum.  A separate producer warp for the copies, a
// [k][4]-interleaved compute layout, a 3-D thread block and mask bytes
// prefetched into registers were each timed on the card, and none was
// faster than this layout.
//
// Each output is one thread's chain over k ascending from 0 (fmaf in f32;
// int16 a uint32_t that wraps modulo 2^32 as the reference's int32 dot
// does), the order of vmm_kernel, so no plan (br, bn, kc, RM) changes a bit
// and the f32 kernel equals vmm_kernel bit for bit.  No split of K, no
// atomics.  kernels/vmm/vmm.py vmm_bwd_plan chooses the plan and mirrors
// the shared-memory layout (VmmBwdPlan.smem_bytes).
#pragma once

#include "common.cuh"

namespace {
namespace vbwd {

constexpr int MAX_THREADS = 256;  // kernels/vmm/vmm.py mirrors it
constexpr int KG = 8;             // k per mask byte: kc is a multiple

template <typename T>
struct Args {
  const T* g;            // [S*M, K]
  const T* wt;           // [K, N]
  const uint8_t* mask;   // [M, ceil(K/8)] or null
  const uint8_t* omask;  // [M, ceil(N/8)] or null
  T* out;                // [S*M, N]
  int rows, m, k, n;     // rows = S*M
  int gate_in, gate_out, method;
  int br, bn, kc;        // the plan (RM is a template argument)
  int lstride;           // elements per landing g row
  int cbuf_bytes, land_bytes, stage_bytes;
  int vb_g, vb_w, vec_y;  // bytes per copy (0: ordinary loads), 4-wide
                          // stores
};

// The vector types that carry 2 or 4 compute words.
template <typename W>
struct Vec;
template <>
struct Vec<float> {
  using V2 = float2;
  using V4 = float4;
};
template <>
struct Vec<uint32_t> {
  using V2 = uint2;
  using V4 = uint4;
};

// RM consecutive compute words (16- or 8-byte aligned) as one load.
template <int RM, typename W>
__device__ __forceinline__ void load_words(const W* p, W (&x)[RM]) {
  if constexpr (RM == 4) {
    const auto v = *reinterpret_cast<const typename Vec<W>::V4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    static_assert(RM == 2, "RM is 2 or 4");
    const auto v = *reinterpret_cast<const typename Vec<W>::V2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}

template <typename T, int RM>
__global__ void __launch_bounds__(MAX_THREADS)
vmm_bwd_tiled_kernel(Args<T> a) {
  using Tr = repro::Traits<T>;
  using W = typename Tr::Word;
  constexpr bool kWiden = !std::is_same<T, float>::value;
  extern __shared__ float4 vbwd_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(vbwd_smem4);
  const int br = a.br, bn = a.bn, kc = a.kc;
  W* xs = reinterpret_cast<W*>(smem);  // [kc][br] gated g words
  W* wsw = xs + kc * br;               // int16: [kc][bn] widened
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int tc = tid % (bn / 4), tr = tid / (bn / 4);
  const int n0 = blockIdx.x * bn, r0 = blockIdx.y * br;
  const int nchunks = (a.k + kc - 1) / kc;
  const int mb = (a.k + KG - 1) / KG;  // mask bytes per row

  auto land_of = [&](int st) {
    return reinterpret_cast<T*>(smem + a.cbuf_bytes + st * a.stage_bytes);
  };
  auto wts_of = [&](int st) {
    return reinterpret_cast<T*>(smem + a.cbuf_bytes + st * a.stage_bytes +
                                a.land_bytes);
  };

  // Stage chunk t (k in [t*kc, t*kc + kc)) into stage st: the block's g
  // rows, then the weight rows of its columns.  A copy never straddles a
  // row: its element count divides K (N) and the chunk (tile), so it is
  // wholly inside or wholly zero-filled.
  auto load = [&](int st, int t) {
    const int k0 = t * kc;
    T* land = land_of(st);
    T* ws = wts_of(st);
    repro::with_copy_bytes(a.vb_g, [&](auto vg) {
      constexpr int VB = decltype(vg)::value;
      constexpr int E = VB ? VB / static_cast<int>(sizeof(T)) : 1;
      const int gu = kc / E;  // copies per row
      for (int e = tid; e < br * gu; e += nthr) {
        const int r = e / gu, q = e - r * gu;
        const int row = r0 + r, kk = k0 + q * E;
        const bool ok = row < a.rows && kk < a.k;
        const T* src = ok ? a.g + static_cast<size_t>(row) * a.k + kk : a.g;
        repro::stage_copy(land + r * a.lstride + q * E, src, ok, VB);
      }
    });
    repro::with_copy_bytes(a.vb_w, [&](auto vw) {
      constexpr int VB = decltype(vw)::value;
      constexpr int E = VB ? VB / static_cast<int>(sizeof(T)) : 1;
      const int wu = bn / E;  // copies per weight row
      for (int e = tid; e < kc * wu; e += nthr) {
        const int kr = e / wu, q = e - kr * wu;
        const int kk = k0 + kr, c = n0 + q * E;
        const bool ok = kk < a.k && c < a.n;
        const T* src = ok ? a.wt + static_cast<size_t>(kk) * a.n + c : a.wt;
        repro::stage_copy(ws + kr * bn + q * E, src, ok, VB);
      }
    });
    repro::cp_async_commit();
  };

  // The prologue of chunk t: gate 8 k of one row a step into the compute
  // buffer ([k][row]: a warp's 32 rows of one k are 32 banks), reading the
  // row's mask byte once for the 8; int16 also widens the weight chunk.
  auto expand = [&](int st, int t) {
    const int kb0 = t * kc / KG;
    const T* land = land_of(st);
    for (int e = tid; e < br * (kc / KG); e += nthr) {
      const int r = e % br, kg = e / br;
      const int row = r0 + r, kb = kb0 + kg;
      int bits = 0;
      if (a.mask != nullptr && row < a.rows && kb < mb)
        bits = a.mask[static_cast<size_t>(row % a.m) * mb + kb];
      // 8 elements, 16-byte aligned: the row stride and kg * 8 elements are
      // whole 16-byte units
      uint4 raw[KG * sizeof(T) / 16];
#pragma unroll
      for (int i = 0; i < KG * static_cast<int>(sizeof(T)) / 16; ++i)
        raw[i] = reinterpret_cast<const uint4*>(land + r * a.lstride +
                                                kg * KG)[i];
      const T* v = reinterpret_cast<const T*>(raw);
      W* dst = xs + kg * KG * br + r;
#pragma unroll
      for (int j = 0; j < KG; ++j)
        dst[j * br] = Tr::prologue(v[j], (bits >> j) & 1, a.gate_in,
                                   a.method);
    }
    if constexpr (kWiden) {
      const T* ws = wts_of(st);
      for (int e = tid; e < kc * bn / 4; e += nthr) {
        W w[4];
        Tr::weights4(ws + 4 * e, w);
        typename Vec<W>::V4 v;
        v.x = w[0], v.y = w[1], v.z = w[2], v.w = w[3];
        *reinterpret_cast<typename Vec<W>::V4*>(wsw + 4 * e) = v;
      }
    }
  };

  W acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = W(0);

  if (nchunks > 0) load(0, 0);
  for (int t = 0; t < nchunks; ++t) {
    repro::cp_async_wait_all();
    // Chunk t has landed, and every thread is done with chunk t - 1: its
    // compute buffer and (since its second barrier) the stage the next
    // copies overwrite.
    __syncthreads();
    if (t + 1 < nchunks) load((t + 1) & 1, t + 1);
    expand(t & 1, t);
    __syncthreads();
    const W* xt = xs + tr * RM;
    const W* wk;
    if constexpr (kWiden) {
      wk = wsw + 4 * tc;
    } else {
      wk = wts_of(t & 1) + 4 * tc;
    }
    for (int k8 = 0; k8 < kc; k8 += KG) {
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        W x[RM], w[4];
        load_words<RM>(xt + (k8 + j) * br, x);
        Tr::words4(wk + (k8 + j) * bn, w);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][c] = Tr::mac(acc[i][c], x[i], w[c]);
      }
    }
  }

  // Epilogue: finish, gate by the previous layer's mask, store.
  const int c0 = n0 + 4 * tc;
  if (c0 >= a.n) return;
  const int ob = (a.n + KG - 1) / KG;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = r0 + tr * RM + i;
    if (row >= a.rows) break;
    const uint8_t* orow =
        a.omask ? a.omask + static_cast<size_t>(row % a.m) * ob : nullptr;
    decltype(Tr::finish(acc[0][0])) r[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      r[c] = Tr::finish(acc[i][c]);
      if (a.gate_out)
        r[c] = repro::gate(r[c], repro::mask_bit(orow, c0 + c), a.method);
    }
    T* dst = a.out + static_cast<size_t>(row) * a.n + c0;
    if (a.vec_y) {  // N a multiple of 4, out aligned to 4 elements
      Tr::store4(dst, r);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + c < a.n) dst[c] = static_cast<T>(r[c]);
    }
  }
}

template <typename T, int RM>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.cbuf_bytes) +
                      2 * static_cast<size_t>(a.stage_bytes);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vmm_bwd_tiled_kernel<T, RM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = (a.br / RM) * (a.bn / 4);
  const dim3 grid((a.n + a.bn - 1) / a.bn, (a.rows + a.br - 1) / a.br);
  vmm_bwd_tiled_kernel<T, RM><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The tile plan of kernels/vmm/vmm.py vmm_bwd_plan (br rows x bn columns a
// block, kc k a chunk, rm rows a thread): check it, lay out shared memory as
// VmmBwdPlan.smem_bytes does, choose the copy widths, launch.
template <typename T>
cudaError_t launch_tiled(const T* g, const T* wt, const uint8_t* mask,
                         const uint8_t* omask, T* out, int s, int m, int k,
                         int n, int gate_in, int gate_out, int method, int br,
                         int bn, int kc, int rm, cudaStream_t stream) {
  const long long rows = static_cast<long long>(s) * m;
  if ((rm != 2 && rm != 4) || br < rm || br % rm != 0 || bn < 4 ||
      bn % 4 != 0 || kc < KG || kc % KG != 0 ||
      (br / rm) * (bn / 4) > MAX_THREADS || s < 1 || m < 1 || k < 1 ||
      n < 1 || rows >= (1LL << 31) || (rows + br - 1) / br > 65535)
    return cudaErrorInvalidValue;
  Args<T> a{g, wt, mask, omask, out, static_cast<int>(rows), m, k, n,
            gate_in, gate_out, method, br, bn, kc};
  // landing rows padded by 16 bytes: the rows a warp reads in the prologue
  // fall in distinct banks, and every row stays 16-byte aligned
  const int unit = 16 / static_cast<int>(sizeof(T));
  a.lstride = (kc + unit - 1) / unit * unit + unit;
  a.cbuf_bytes = 4 * kc * br + (std::is_same<T, float>::value ? 0
                                                               : 4 * kc * bn);
  a.land_bytes = (static_cast<int>(sizeof(T)) * br * a.lstride + 15) / 16 * 16;
  a.stage_bytes =
      a.land_bytes + (static_cast<int>(sizeof(T)) * kc * bn + 15) / 16 * 16;
  if (a.cbuf_bytes + 2 * a.stage_bytes > 227 * 1024)
    return cudaErrorInvalidValue;
  a.vb_g = repro::copy_bytes<T>(g, k, kc);
  a.vb_w = repro::copy_bytes<T>(wt, n, bn);
  a.vec_y = n % 4 == 0 &&
            reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  return rm == 4 ? launch<T, 4>(a, stream) : launch<T, 2>(a, stream);
}

}  // namespace vbwd
}  // namespace
