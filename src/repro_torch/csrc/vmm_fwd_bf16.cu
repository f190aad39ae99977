// The bf16 FC forward on the tensor cores (B4 in bf16), called by
// repro_vmm_fwd_bf16 (vmm.cu) for the plans kernels/vmm/vmm.py
// vmm_mma_plan gives (VmmMmaPlan: columns a block, blocks a cluster).
//
// Replaces: src/repro/kernels/vmm/vmm.py, vmm_pallas on bf16 x and w (the
// JAX package's precision="bf16" path), with the bias the reference adds
// after the call in the epilogue:
//
//   y[M, N] = bf16(f32(bf16(x[M, K] @ w[K, N])) + f32(b[N]))
//
// Bound on an H100: bytes.  FC0 ([32, 4096] @ [4096, 128]) must read the
// 1 MiB bf16 weight once, 0.4 us at 3.35 TB/s; its 33.5 MFLOP take 0.03 us
// on the tensor cores.  The FFMA split-K it replaces (vmm.cu's
// vmm_splitk_kernel on bf16) wrote a [64, 32, 128] f32 workspace, read back
// by a second kernel: 3.3 MB moved where 1.3 MB are needed, in two
// launches.
//
// Design: one launch, split-K reduced inside a thread-block cluster.  A
// block owns a 32 x bn output tile (bn 16 or 32) and one slice of K (a
// multiple of 64 long); the `cluster` blocks that share a tile, one slice
// each, form a cluster.  A block stages its slice in 64-deep chunks
// through an eight-stage cp.async ring, so a slice of up to 7 chunks (FC0's
// has 4) is in flight from the start (x rows and weight rows padded to an
// odd number of 16-byte units, so ldmatrix reads them without bank
// conflicts); warp w takes k16 step w of every chunk: ldmatrix for the two
// m16 fragments of x, ldmatrix.trans for the n8 fragments of the weight,
// mma.sync.m16n8k16 (bf16 in, f32 sums) into a fresh accumulator that is
// then added to the warp's running f32 sum (the tensor cores' own
// accumulation spans one k step).  The four warps' partial tiles are
// summed in warp order in shared memory; each rank owns a share of the
// tile, and every block pushes its partial of each element into the
// owner's shared memory (map_shared_rank); after one cluster barrier each
// owner sums its ranks' partials in rank order, rounds, adds the bias,
// rounds again and writes y.  The barrier that lets a block write into
// another's shared memory (all have started) is split, arrive at the start
// and wait after the main loop, so one barrier is exposed.  The launch
// uses programmatic dependent launch (repro::launch_pdl): the blocks may be
// scheduled while the kernel before drains, and wait for its writes before
// their first load.  No workspace,
// no second kernel, no atomics: the same bits every run.  The cluster
// size sets how K is cut and so the order of the sum; the column tile does
// not.  Up to 8 blocks a cluster is portable, 16 needs
// cudaFuncAttributeNonPortableClusterSizeAllowed.

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {
namespace vmma {

using T = __nv_bfloat16;

// kernels/vmm/vmm.py mirrors BM, KC and the cluster limits.
constexpr int BM = 32, KC = 64, WARPS = KC / 16, THREADS = 32 * WARPS;
constexpr int STAGES = 8, XS = KC + 8;  // x row stride: 144 bytes
constexpr int MAX_CLUSTER = 16, PORTABLE_CLUSTER = 8;

template <int BN>
struct Layout {
  static constexpr int WS = BN + 8;  // weight row stride: 48 or 80 bytes
  static constexpr int XSZ = BM * XS, STAGE = XSZ + KC * WS;
  static constexpr size_t RING = sizeof(T) * STAGES * STAGE;
  // then the inbox: [cluster][share] partials of the rank's share
  static constexpr size_t SMEM =
      RING + sizeof(float) * (BM * BN + MAX_CLUSTER);
  static_assert(sizeof(float) * WARPS * BM * BN <= RING,
                "the warps' partial tiles reuse the ring");
};

template <int BN>
__global__ void __launch_bounds__(THREADS)
vmm_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ y, int m, int k,
               int n, int ks, int vb_x, int vb_w) {
  using L = Layout<BN>;
  constexpr int NT = BN / 8;  // n8 fragments of the tile
  extern __shared__ float4 vm_smem4[];
  T* ring = reinterpret_cast<T*>(vm_smem4);
  float* inbox = reinterpret_cast<float*>(
      reinterpret_cast<char*>(vm_smem4) + L::RING);  // [cs][share]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  // A block may write into another's shared memory only once that block
  // runs: arrive now, wait before the first remote write.
  if (cs > 1) repro::cluster_arrive_relaxed();
  // Launched with programmatic stream serialization, the grid may start
  // while the kernel before it drains: wait for its writes before a load.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = (blockIdx.x / cs) * BN, m0 = blockIdx.y * BM;
  const int kb = rank * ks, ke = min(k, kb + ks);
  const int nch = ke > kb ? (ke - kb + KC - 1) / KC : 0;

  // Stage the chunk [k0, k0 + KC) of x's rows and of the weight's rows;
  // past K, M or N the copy writes zeros.  A copy never straddles the end
  // of K or N: its element count divides both (repro::copy_bytes).
  auto load = [&](int s, int k0) {
    T* xs = ring + s * L::STAGE;
    T* ws = xs + L::XSZ;
    repro::with_copy_bytes(vb_x, [&](auto vx) {
      constexpr int VB = decltype(vx)::value;
      constexpr int E = VB ? VB / static_cast<int>(sizeof(T)) : 1;
      constexpr int XU = KC / E;  // copies per x row
      for (int e = tid; e < BM * XU; e += THREADS) {
        const int r = e / XU, kk = k0 + (e - r * XU) * E;
        const bool ok = m0 + r < m && kk < ke;
        const T* src = ok ? x + static_cast<size_t>(m0 + r) * k + kk : x;
        repro::stage_copy(xs + r * XS + (kk - k0), src, ok, VB);
      }
    });
    repro::with_copy_bytes(vb_w, [&](auto vw) {
      constexpr int VB = decltype(vw)::value;
      constexpr int E = VB ? VB / static_cast<int>(sizeof(T)) : 1;
      constexpr int WU = BN / E;  // copies per weight row
      for (int e = tid; e < KC * WU; e += THREADS) {
        const int r = e / WU, c = (e - r * WU) * E;
        const bool ok = k0 + r < ke && n0 + c < n;
        const T* src =
            ok ? w + static_cast<size_t>(k0 + r) * n + n0 + c : w;
        repro::stage_copy(ws + r * L::WS + c, src, ok, VB);
      }
    });
    repro::cp_async_commit();
  };

  float run[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) run[mt][j][q] = 0.f;

  // This lane's ldmatrix rows within warp w's k16 step (as in
  // conv_fwd_mma.cu): A, row lane % 16 at k 8 * (lane / 16); B, k row
  // (lane % 8) + 8 * (lane / 8 % 2) at column 8 * (lane / 16).
  const int a_off = (lane & 15) * XS + warp * 16 + (lane >> 4) * 8;
  const int b_off =
      (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::WS +
      (lane >> 4) * 8;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) {
      load(s, kb + s * KC);
    } else {
      repro::cp_async_commit();  // an empty group keeps the count
    }
  }
  for (int i = 0; i < nch; ++i) {
    repro::cp_async_wait<STAGES - 2>();
    // Chunk i has landed for every thread, and every thread is done with
    // chunk i - 1, whose stage the next copies overwrite.
    __syncthreads();
    const int next = i + STAGES - 1;
    if (next < nch) {
      load(next % STAGES, kb + next * KC);
    } else {
      repro::cp_async_commit();
    }
    const T* xs = ring + (i % STAGES) * L::STAGE;
    const T* ws = xs + L::XSZ;
    uint32_t af[2][4];
    repro::ldmatrix_x4(af[0], xs + a_off);
    repro::ldmatrix_x4(af[1], xs + 16 * XS + a_off);
    uint32_t bf[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
      repro::ldmatrix_x4_trans(bf[j], ws + b_off + 16 * j);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        repro::mma_bf16(acc, af[mt], bf[j / 2][2 * (j % 2)],
                        bf[j / 2][2 * (j % 2) + 1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) run[mt][j][q] += acc[q];
      }
    }
  }
  repro::cp_async_wait_all();
  __syncthreads();  // the ring is free for the warps' partial tiles

  // The warps' partials, summed in warp order into the block's tile.
  float* wpart = reinterpret_cast<float*>(vm_smem4);  // [WARPS][BM][BN]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt + (lane >> 2) + 8 * half;
        const int c = 8 * j + 2 * (lane & 3);
        float* p = wpart + (warp * BM + r) * BN + c;
        p[0] = run[mt][j][2 * half];
        p[1] = run[mt][j][2 * half + 1];
      }
  __syncthreads();

  // Rank o owns elements [o * share, (o + 1) * share) of the tile: each
  // block pushes its partial of every element into the owner's inbox, at
  // its own rank's row; after one cluster barrier each owner sums its
  // inbox in rank order and writes y.  No block reads another's shared
  // memory after the barrier, so none has to wait for the others to leave.
  const int share = (BM * BN + cs - 1) / cs;
  if (cs > 1) repro::cluster_wait();
  for (int e = tid; e < BM * BN; e += THREADS) {
    float s = wpart[e];
#pragma unroll
    for (int q = 1; q < WARPS; ++q) s += wpart[q * BM * BN + e];
    const int o = e / share;
    float* box = cs > 1 ? cluster.map_shared_rank(inbox, o) : inbox;
    box[rank * share + e - o * share] = s;
  }
  if (cs > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  const int e0 = rank * share, e1 = min(BM * BN, e0 + share);
  for (int e = e0 + tid; e < e1; e += THREADS) {
    float v[MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < cs) v[q] = inbox[q * share + e - e0];
    float s = v[0];
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q)
      if (q < cs) s += v[q];
    const int r = m0 + e / BN, c = n0 + e % BN;
    if (r < m && c < n) {
      if (bias) s = repro::Traits<T>::add_bias(s, bias[c]);
      y[static_cast<size_t>(r) * n + c] = __float2bfloat16_rn(s);
    }
  }
}

template <int BN>
cudaError_t launch(const T* x, const T* w, const T* bias, T* y, int m, int k,
                   int n, int cluster, int ks, cudaStream_t stream) {
  using L = Layout<BN>;
  auto kernel = vmm_mma_kernel<BN>;
  if (L::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::SMEM));
    if (e != cudaSuccess) return e;
  }
  if (cluster > PORTABLE_CLUSTER) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  const int vb_x = repro::copy_bytes<T>(x, k, KC);
  const int vb_w = repro::copy_bytes<T>(w, n, BN);
  return repro::launch_pdl(
      kernel, dim3(((n + BN - 1) / BN) * cluster, (m + BM - 1) / BM, 1),
      dim3(THREADS, 1, 1), L::SMEM, stream, cluster, x, w, bias, y, m, k, n,
      ks, vb_x, vb_w);
}

}  // namespace vmma
}  // namespace

namespace repro {

cudaError_t vmm_fwd_mma_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                             const __nv_bfloat16* bias, __nv_bfloat16* y,
                             int m, int k, int n, int cluster, int ks, int bn,
                             cudaStream_t stream) {
  // cluster slices of K, each ks long (whole chunks), none empty:
  // kernels/vmm/vmm.py VmmMmaPlan.slice and _check_mma_plan agree.
  if ((bn != 16 && bn != 32) || cluster < 1 ||
      cluster > vmma::MAX_CLUSTER || ks < vmma::KC || ks % vmma::KC != 0 ||
      static_cast<long long>(cluster) * ks < k ||
      static_cast<long long>(cluster - 1) * ks >= k)
    return cudaErrorInvalidValue;
  return bn == 16
             ? vmma::launch<16>(x, w, bias, y, m, k, n, cluster, ks, stream)
             : vmma::launch<32>(x, w, bias, y, m, k, n, cluster, ks, stream);
}

}  // namespace repro
