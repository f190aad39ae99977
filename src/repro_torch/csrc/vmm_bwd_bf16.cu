// The bf16 fused FC backward on the tensor cores (B6 in bf16), called by
// repro_vmm_bwd_fused_bf16 (vmm.cu) for the plans kernels/vmm/vmm.py
// vmm_bwd_mma_plan gives (VmmBwdMmaPlan).
//
// Replaces: src/repro/kernels/vmm/vmm.py, vmm_bwd_fused_pallas on a bf16
// gradient (the JAX package's precision="bf16" path):
//
//   out[s] = bf16(gate_out(gate_in(g[s]) @ wt)),  g [S, M, K], wt [K, N]
//
// The gate selects bf16 values (exact); the products are summed in f32; the
// epilogue gate acts on the f32 sum, and the result is rounded to nearest
// even once, at the store, as the reference gates its f32 accumulator
// before .astype (vmm.py:110-113).  The 1-bit masks [M, ceil(K/8)] and
// [M, ceil(N/8)] have no seeds axis.
//
// Bound on an H100: bytes.  FC0's launch of the seed-batched explain,
// [3, 32, 128] gated @ [128, 4096], moves 1.8 MB (0.55 us at 3.35 TB/s) for
// 100.7 MFLOP, 0.1 us on the bf16 tensor cores and 1.5 us on FFMA, where
// the f32 template's bf16 instance (vmm_bwd.cuh, which widened g and the
// weights to f32 words) summed them; that template also tiled FC0 into
// 16-row blocks, so six row tiles fetched the same 1 MiB weight slab.
//
// Design: the seeds fold into rows, g read as [S*M, K]; output row r reads
// mask row r mod M, so every seed shares the stored bits.  A block owns br
// rows x bn columns (kernels/vmm/vmm.py vmm_bwd_mma_plan: 32 x 64 at FC0,
// 192 blocks; a block of all 96 rows fetches each weight element from L2
// once, but leaves 128 blocks or fewer and ran 20 % slower), and walks K
// in kc-deep chunks through a cp.async ring (two stages where K takes more
// than one chunk).  cp.async cannot gate, so between a chunk's two
// barriers the block gates the landing g rows in place, eight k of a row a
// step, one mask byte read for the eight (repro::gate8).  Warp w holds
// 16 mf rows x 8 nt columns: per k16 step, A by ldmatrix from the gated
// [row][k + 8] g stage, B by ldmatrix.trans from the [k][n] weight stage
// (both rows an odd number of 16-byte units, so no bank conflicts), and
// mma.sync.m16n8k16 (bf16 in, f32 sums).  K past its end, to the next
// k16 step, is zero-filled in both operands by the copies (FC1: K = 10).
//
// Fixed order, as in vmm_fwd_bf16.cu: each k16 step's products go into a
// fresh accumulator that is then added to the running f32 sum in k order;
// no split of K, no atomics, so no plan and no run changes a bit.

#include "common.cuh"
#include "mma.cuh"

namespace {
namespace vbm {

using T = __nv_bfloat16;

constexpr int MAX_THREADS = 256;  // kernels/vmm/vmm.py mirrors it
constexpr int KG = 8;             // k per mask byte

struct Args {
  const T* g;            // [S*M, K]
  const T* wt;           // [K, N]
  const uint8_t* mask;   // [M, ceil(K/8)] or null
  const uint8_t* omask;  // [M, ceil(N/8)] or null
  T* out;                // [S*M, N]
  int rows, m, k, n;     // rows = S*M
  int gate_in, gate_out, method;
  int br, bn, kc;        // the plan (mf and nt are template arguments)
  int gstride, wstride;  // elements per staged g row, weight row
  int land_elems, stage_elems;
  int vb_g, vb_w, vec_y;  // bytes per copy (0: ordinary loads), pair stores
};

template <int MF, int NT>
__global__ void __launch_bounds__(MAX_THREADS) vmm_bwd_mma_kernel(Args a) {
  constexpr int WM = 16 * MF, WN = 8 * NT;
  extern __shared__ float4 vbm_smem4[];
  T* smem = reinterpret_cast<T*>(vbm_smem4);
  const int br = a.br, bn = a.bn, kc = a.kc;
  const int gstride = a.gstride, wstride = a.wstride;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wrows = br / WM;
  const int wr = warp % wrows, wc = warp / wrows;
  const int n0 = blockIdx.x * bn, r0 = blockIdx.y * br;
  const int nchunks = (a.k + kc - 1) / kc;
  const int mb = (a.k + KG - 1) / KG;  // mask bytes per row

  auto land_of = [&](int st) { return smem + st * a.stage_elems; };

  // Stage chunk t (k in [t*kc, t*kc + kc)) into stage st: the block's g
  // rows, then the weight rows of its columns.  A copy's element count
  // divides K (N) and the chunk (tile), so a copy is wholly inside or wholly
  // zero-filled.
  auto load = [&](int st, int t) {
    const int k0 = t * kc;
    T* land = land_of(st);
    T* ws = land + a.land_elems;
    repro::with_copy_bytes(a.vb_g, [&](auto vg) {
      constexpr int VB = decltype(vg)::value;
      constexpr int E = VB ? VB / static_cast<int>(sizeof(T)) : 1;
      const int gu = kc / E;  // copies per row
      for (int e = tid; e < br * gu; e += nthr) {
        const int r = e / gu, q = e - r * gu;
        const int row = r0 + r, kk = k0 + q * E;
        const bool ok = row < a.rows && kk < a.k;
        const T* src = ok ? a.g + static_cast<size_t>(row) * a.k + kk : a.g;
        repro::stage_copy(land + r * gstride + q * E, src, ok, VB);
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
        repro::stage_copy(ws + kr * wstride + q * E, src, ok, VB);
      }
    });
    repro::cp_async_commit();
  };

  // The prologue of chunk t: gate the landing g rows in place, eight k of
  // one row a step, the row's mask byte read once for the eight.
  const unsigned rule_bits = a.method != repro::kDeconvnet ? 0u : 0xffu;
  const bool positive = a.method != repro::kSaliency;
  auto gate = [&](int st, int t) {
    const int kb0 = t * kc / KG, nq = kc / KG;
    T* land = land_of(st);
    for (int e = tid; e < br * nq; e += nthr) {
      const int r = e / nq, q = e - r * nq;
      const int row = r0 + r, kb = kb0 + q;
      unsigned bits = 0;
      if (a.mask != nullptr && row < a.rows && kb < mb)
        bits = a.mask[static_cast<size_t>(row % a.m) * mb + kb];
      uint4* p = reinterpret_cast<uint4*>(land + r * gstride + KG * q);
      *p = repro::gate8(*p, rule_bits | bits, positive);
    }
  };

  float run[MF][NT][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) run[f][j][q] = 0.f;

  // This lane's ldmatrix rows (as in vmm_fwd_bf16.cu): A, row lane % 16 of
  // the warp's first fragment at k 8 * (lane / 16); B, k row (lane % 8) +
  // 8 * (lane / 8 % 2) at column 8 * (lane / 16) of the warp's.
  const int a_off = (wr * WM + (lane & 15)) * gstride + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * wstride +
                    wc * WN + (lane >> 4) * 8;

  if (nchunks > 0) load(0, 0);
  for (int t = 0; t < nchunks; ++t) {
    repro::cp_async_wait_all();
    // Chunk t has landed, and every thread is done with chunk t - 1, whose
    // stage the next copies overwrite.
    __syncthreads();
    if (t + 1 < nchunks) load((t + 1) & 1, t + 1);
    if (a.gate_in) {
      gate(t & 1, t);
      __syncthreads();
    }
    const T* gs = land_of(t & 1);
    const T* ws = gs + a.land_elems;
    const int steps = min(kc, a.k - t * kc + 15) / 16;  // k16 steps with K
#pragma unroll 1
    for (int ks = 0; ks < steps; ++ks) {
      uint32_t af[MF][4];
#pragma unroll
      for (int f = 0; f < MF; ++f)
        repro::ldmatrix_x4(af[f], gs + a_off + 16 * f * gstride + 16 * ks);
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b4[4];
        repro::ldmatrix_x4_trans(b4, ws + b_off + 16 * ks * wstride + 8 * j);
        bf[j][0] = b4[0], bf[j][1] = b4[1];
        bf[j + 1][0] = b4[2], bf[j + 1][1] = b4[3];
      }
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          repro::mma_bf16(acc, af[f], bf[j][0], bf[j][1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) run[f][j][q] += acc[q];
        }
    }
  }

  // Epilogue: gate the f32 sums by the previous layer's mask, round once,
  // store.  D rows lane / 4 and lane / 4 + 8 of each fragment, columns
  // 2 * (lane % 4) and the next of each n8 tile.
  const int ob = (a.n + KG - 1) / KG;
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + wr * WM + 16 * f + (lane >> 2) + 8 * half;
      if (row >= a.rows) continue;
      const uint8_t* orow =
          a.omask ? a.omask + static_cast<size_t>(row % a.m) * ob : nullptr;
      T* dst = a.out + static_cast<size_t>(row) * a.n;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + wc * WN + 8 * j + 2 * (lane & 3);
        float v0 = run[f][j][2 * half], v1 = run[f][j][2 * half + 1];
        if (a.gate_out) {
          if (c < a.n) v0 = repro::gate(v0, repro::mask_bit(orow, c), a.method);
          if (c + 1 < a.n)
            v1 = repro::gate(v1, repro::mask_bit(orow, c + 1), a.method);
        }
        if (a.vec_y && c + 1 < a.n) {  // N even, out 4-byte aligned
          *reinterpret_cast<uint32_t*>(dst + c) = repro::bf16_pack(v0, v1);
        } else {
          if (c < a.n) dst[c] = __float2bfloat16_rn(v0);
          if (c + 1 < a.n) dst[c + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

template <int MF, int NT>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vmm_bwd_mma_kernel<MF, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = 32 * (a.br / (16 * MF)) * (a.bn / (8 * NT));
  const dim3 grid((a.n + a.bn - 1) / a.bn, (a.rows + a.br - 1) / a.br);
  vmm_bwd_mma_kernel<MF, NT><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace vbm
}  // namespace

namespace repro {

// Check the plan (VmmBwdMmaPlan's rules), lay out shared memory as
// VmmBwdMmaPlan.smem_bytes does, choose the copy widths, launch.
cudaError_t vmm_bwd_mma_bf16(const __nv_bfloat16* g, const __nv_bfloat16* wt,
                             const uint8_t* mask, const uint8_t* omask,
                             __nv_bfloat16* out, int s, int m, int k, int n,
                             int gate_in, int gate_out, int method, int br,
                             int bn, int kc, int mf, int nt,
                             cudaStream_t stream) {
  using vbm::T;
  const long long rows = static_cast<long long>(s) * m;
  if ((mf != 1 && mf != 2) || (nt != 2 && nt != 4) || br < 16 * mf ||
      br % (16 * mf) != 0 || bn < 8 * nt || bn % (8 * nt) != 0 || kc < 16 ||
      kc % 16 != 0 ||
      32 * (br / (16 * mf)) * (bn / (8 * nt)) > vbm::MAX_THREADS || s < 1 ||
      m < 1 || k < 1 || n < 1 || rows >= (1LL << 31) ||
      (rows + br - 1) / br > 65535)
    return cudaErrorInvalidValue;
  vbm::Args a{g, wt, mask, omask, out, static_cast<int>(rows), m, k, n,
              gate_in, gate_out, method, br, bn, kc};
  // rows of an odd number of 16-byte units: kc + 8, and bn rounded up to an
  // odd number of n8 columns
  a.gstride = kc + 8;
  a.wstride = 8 * ((bn / 8) | 1);
  a.land_elems = br * a.gstride;
  a.stage_elems = a.land_elems + kc * a.wstride;
  const size_t smem = sizeof(T) * (k > kc ? 2 : 1) *
                      static_cast<size_t>(a.stage_elems);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  a.vb_g = copy_bytes<T>(g, k, kc);
  a.vb_w = copy_bytes<T>(wt, n, bn);
  a.vec_y = n % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  if (mf == 1)
    return nt == 2 ? vbm::launch<1, 2>(a, smem, stream)
                   : vbm::launch<1, 4>(a, smem, stream);
  return nt == 2 ? vbm::launch<2, 2>(a, smem, stream)
                 : vbm::launch<2, 4>(a, smem, stream);
}

}  // namespace repro
