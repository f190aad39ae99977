"""FC matmul kernels (paper §III.C, §III.E): forward and fused backward.

:func:`vmm` wraps ``repro_vmm_fwd`` of ``csrc/vmm.cu`` (the port of
``repro.kernels.vmm.vmm.vmm_pallas``), with the FC bias added in its
epilogue.  The forward splits K across blocks: :func:`vmm_splits` chooses
the number of slices from the shape, and with more than one the wrapper
hands the kernel a ``[splits, M, N]`` f32 workspace, which a second kernel
of the same entry point sums in slice order (:func:`vmm_fwd`, which the
int16 forward shares).  :func:`vmm_bwd_fused` wraps
``repro_vmm_bwd_fused`` (the port of ``vmm_bwd_fused_pallas``): the 1-bit mask gate runs on the gradient as it
is loaded, then the product with ``W^T``, then an optional epilogue gate —
an FC layer's whole backward step in one launch, all S seeds sharing the
stored mask, tiled by :func:`vmm_bwd_plan` (``csrc/vmm_bwd.cuh``; the plan
:data:`VMM_BWD_GENERAL` runs the general 16x16 kernel instead).
:func:`vmm_bwd_fused_plain` is that kernel's plain twin.

Both wrappers take f32 and bf16 (the bf16 path): each element type has its
entry point (``repro_vmm_fwd_bf16``, :data:`_BWD_ENTRY`), bf16 with f32 sums,
rounded once to bf16 (the forward's bias added after the rounding, as the
JAX package adds it after ``vmm_pallas``).  The bf16 forward runs on the
tensor cores in one launch, K split across the blocks of a thread-block
cluster and reduced in their shared memory, with no workspace
(``csrc/vmm_fwd_bf16.cu``, :func:`vmm_planned`, :class:`VmmMmaPlan` by
:func:`vmm_mma_plan`); the split-K forward is f32's and int16's.  The bf16
fused backward runs on the tensor cores too, all the seeds' rows in one
block (``csrc/vmm_bwd_bf16.cu``, :class:`VmmBwdMmaPlan` by
:func:`vmm_bwd_mma_plan`); the tiled template of ``csrc/vmm_bwd.cuh`` is
f32's and int16's, and bf16 has no general fused-backward kernel.  The
int16 twins (``vmm.fxp``) share the argument contract, checks and plain
dataflow defined here; only the element type, the entry point and the
product itself differ.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import (METHOD_CODES, _build, check,
                                 check_kernel_operands, on_card,
                                 validate_bp_gates)
from repro_torch.kernels.relu_mask.relu_mask import gate_gradient, unpack_bits
from repro_torch.kernels.tiling import H100_SMS, align_up, cdiv, mask_bytes
from repro_torch.kernels.vmm import ref
from repro_torch.obs.profile import instrument

#: The split-K forward's output tile and K chunk (``csrc/vmm.cu`` SK_BM,
#: SK_BN, SK_KC): a slice of K is a whole number of chunks.
SPLIT_TILE_M, SPLIT_TILE_N, SPLIT_CHUNK_K = 32, 32, 32


def vmm_max_splits(k: int) -> int:
    """The most slices K can be cut into: one chunk each."""
    return max(1, cdiv(k, SPLIT_CHUNK_K))


def vmm_slice(k: int, splits: int) -> int:
    """Length of each K slice for ``splits`` slices (the last may be
    shorter): a whole number of chunks, at least one."""
    return align_up(max(1, cdiv(k, splits)), SPLIT_CHUNK_K)


def vmm_splits(m: int, k: int, n: int, *, sms: int = H100_SMS) -> int:
    """Number of K slices for ``[m, k] @ [k, n]`` on an H100.

    One slice, with no second pass, where K is at most four chunks or the
    output tiles alone fill the card; otherwise enough slices for about two
    blocks per SM, each at least one chunk long, and none empty.  ``sms``
    is the card's SM count (the tile planner passes its profile's).
    """
    tiles = cdiv(m, SPLIT_TILE_M) * cdiv(n, SPLIT_TILE_N)
    if k <= 4 * SPLIT_CHUNK_K or tiles >= sms:
        return 1
    per = vmm_slice(k, cdiv(2 * sms, tiles))
    return cdiv(k, per)


#: The bf16 tensor-core forward (``csrc/vmm_fwd_bf16.cu`` BM, KC and the
#: cluster limits): 32 rows a block, K in 64-deep chunks (a k16 step a warp),
#: 16 or 32 columns a block, and up to 16 blocks a cluster, of which more
#: than 8 need ``cudaFuncAttributeNonPortableClusterSizeAllowed``.
MMA_TILE_M, MMA_CHUNK_K = 32, 64
MMA_TILE_NS = (16, 32)
MMA_MAX_CLUSTER, MMA_PORTABLE_CLUSTER = 16, 8


@dataclass(frozen=True)
class VmmMmaPlan:
    """The bf16 tensor-core forward's launch: ``bn`` columns a block, and K
    cut into ``cluster`` slices (:meth:`slice` long), one a block of a
    thread-block cluster.  The cluster size sets how the sum is grouped;
    the column tile changes no bit."""
    bn: int
    cluster: int

    def slice(self, k: int) -> int:
        """Length of each K slice: whole chunks, the last maybe shorter."""
        return align_up(max(1, cdiv(k, self.cluster)), MMA_CHUNK_K)

    def blocks(self, m: int, n: int) -> int:
        return cdiv(m, MMA_TILE_M) * cdiv(n, self.bn) * self.cluster

    def args(self, k: int) -> Tuple[int, int, int]:
        """The entry point's ``splits, ks, bn`` for this plan."""
        return (self.cluster, self.slice(k), self.bn)


def vmm_mma_plan(m: int, k: int, n: int, *,
                 sms: int = H100_SMS) -> VmmMmaPlan:
    """The bf16 tensor-core forward's launch for ``[m, k] @ [k, n]`` on an
    H100, from ``python3 chip_smoke.py --sweep``: 16 columns a block (twice
    the blocks of 32; the two were within 2 % at FC0), and the smallest
    power-of-two cluster (up to 16) whose blocks cover the SMs, with no
    slice shorter than a chunk and none empty.  FC0 ``[32, 4096] @ [4096,
    128]``: 8 tiles x a cluster of 16 = 128 blocks, slices of 256 (the
    sweep's fastest cluster; 8 ran 13 % slower); FC1 ``[32, 128] @ [128,
    10]``: a cluster of 2, a chunk each (10 % faster than one block)."""
    bn = MMA_TILE_NS[0]
    tiles = cdiv(m, MMA_TILE_M) * cdiv(n, bn)
    most = min(MMA_MAX_CLUSTER, cdiv(max(k, 1), MMA_CHUNK_K))
    cluster = 1
    while 2 * cluster <= most and tiles * cluster < sms:
        cluster *= 2
    return VmmMmaPlan(bn, cdiv(max(k, 1),
                               VmmMmaPlan(bn, cluster).slice(k)))


def vmm_mma_candidates(m: int, k: int, n: int):
    """The tensor-core launches ``chip_smoke.py --sweep`` times for one
    shape: each column tile no wider than N needs, by each cluster size
    whose slices leave none of K's blocks empty."""
    return [VmmMmaPlan(bn, c) for bn in MMA_TILE_NS for c in (1, 2, 4, 8, 16)
            if bn <= max(MMA_TILE_NS[0], align_up(n, MMA_TILE_NS[0]))
            and (c - 1) * VmmMmaPlan(bn, c).slice(k) < max(k, 1)]


def _check_mma_plan(name: str, plan: VmmMmaPlan, k: int) -> None:
    """Raise unless the tensor-core forward can run ``plan`` on K: its
    slices cover K, none empty."""
    if (plan.bn not in MMA_TILE_NS
            or not 1 <= plan.cluster <= MMA_MAX_CLUSTER
            or (plan.cluster - 1) * plan.slice(k) >= max(k, 1)):
        raise ValueError(f"{name}: invalid tensor-core plan {plan} for "
                         f"K = {k}")


#: ``csrc/vmm_bwd.cuh`` MAX_THREADS and the k a mask byte covers: a block of
#: the tiled fused backward has at most 256 threads, a chunk is a whole
#: number of mask bytes.
VMM_BWD_MAX_THREADS, VMM_BWD_KG = 256, 8
#: Rows a thread of the tiled fused backward holds (its register tile is
#: rows x 4 columns): ``csrc/vmm_bwd.cuh`` is compiled for 2 and 4.
VMM_BWD_RMS = (2, 4)
#: The rule's tile: rows and columns a block, and K a chunk at most.
VMM_BWD_TILE_ROWS, VMM_BWD_TILE_COLS, VMM_BWD_MAX_KC = 16, 64, 64
#: Shared memory one block may use on an H100 (227 KB).
VMM_BWD_SMEM_LIMIT = 227 * 1024


@dataclass(frozen=True)
class VmmBwdPlan:
    """The tiled fused FC backward's tile: ``br`` rows (of the seeds folded
    into ``[S*M]``) x ``bn`` columns a block, ``kc`` k a ring stage,
    ``rm`` rows x 4 columns a thread.  No field changes the order of any
    sum.  :data:`VMM_BWD_GENERAL` (all zeros) selects the general kernel
    instead."""
    br: int
    bn: int
    kc: int
    rm: int

    @property
    def threads(self) -> int:
        return (self.br // self.rm) * (self.bn // 4)

    def blocks(self, rows: int, n: int) -> int:
        return cdiv(rows, self.br) * cdiv(n, self.bn)

    def smem_bytes(self, *, esize: int = 4) -> int:
        """The compute buffer (gated g as ``[kc][br]`` 32-bit words; int16
        also the widened weights, ``[kc][bn]`` words) and both ring stages
        (the g rows of ``esize``-byte elements, padded by 16 bytes, then the
        weight chunk ``[kc][bn]``, each rounded up to 16 bytes), as
        ``csrc/vmm_bwd.cuh`` ``launch_tiled`` lays them out."""
        unit = 16 // esize
        lstride = align_up(self.kc, unit) + unit
        cbuf = 4 * self.kc * (self.br + (self.bn if esize != 4 else 0))
        land = align_up(esize * self.br * lstride, 16)
        wts = align_up(esize * self.kc * self.bn, 16)
        return cbuf + 2 * (land + wts)

    def args(self) -> Tuple[int, int, int, int]:
        return (self.br, self.bn, self.kc, self.rm)


#: The plan that selects the general fused-backward kernel (``vmm_kernel``
#: / ``vmm_fxp_kernel``, the 16x16 tile); for tests and sweeps that hold
#: the tiled kernel against it.
VMM_BWD_GENERAL = VmmBwdPlan(0, 0, 0, 0)


def vmm_bwd_plan(s: int, m: int, k: int, n: int, *,
                 sms: int = H100_SMS) -> VmmBwdPlan:
    """The tiled fused backward's tile for ``g [s, m, k] @ wt [k, n]`` on an
    H100, from ``python3 chip_smoke.py --sweep``: 16 rows x 64 columns a
    block (fewer where the launch has fewer), 2 rows x 4 columns a thread
    (128 threads), and K in chunks of up to 64.  Of the plans swept at FC0
    (S = 3 and 1, f32 and int16) it had the least time summed over the
    four, within 7 % of each one's best; at FC1 it was the fastest.  At FC0
    it gives 384 blocks with S = 3 and 128 (the SMs rounded down to a power
    of two) with S = 1.  The tile does not depend on ``sms``, which it
    takes as the other rules do.
    """
    rows = max(s * m, 1)
    rm = 2
    br = min(VMM_BWD_TILE_ROWS, align_up(rows, rm))
    bn = min(VMM_BWD_TILE_COLS, align_up(max(n, 1), 4))
    kc = min(VMM_BWD_MAX_KC, align_up(max(k, 1), VMM_BWD_KG))
    return VmmBwdPlan(br, bn, kc, rm)


def vmm_bwd_candidates(s: int, m: int, k: int, n: int):
    """The tile plans ``chip_smoke.py --sweep`` times for one launch (and
    the card tests hold bitwise to the general kernel): 8 to 64 rows x 16
    to 128 columns a block (no wider than the launch), 2 or 4 rows a
    thread, chunks of 8 to 128 k (no deeper than K), 16 to 256 threads,
    within 227 KB of shared memory for f32 and int16."""
    rows = max(s * m, 1)
    kcs = sorted({min(c, align_up(max(k, 1), VMM_BWD_KG))
                  for c in (8, 16, 32, 64, 128)})
    out = []
    for rm in VMM_BWD_RMS:
        for br in (8, 16, 32, 64):
            for bn in (16, 32, 64, 128):
                for kc in kcs:
                    p = VmmBwdPlan(br, bn, kc, rm)
                    if (br <= max(8, align_up(rows, 8))
                            and bn <= max(16, align_up(n, 16))
                            and 16 <= p.threads <= VMM_BWD_MAX_THREADS
                            and max(p.smem_bytes(), p.smem_bytes(esize=2))
                            <= VMM_BWD_SMEM_LIMIT):
                        out.append(p)
    return out


#: The bf16 tensor-core fused backward (``csrc/vmm_bwd_bf16.cu``): a warp
#: holds ``mf`` m16 row fragments (1 or 2) x ``nt`` n8 column fragments (2
#: or 4), and a k step is 16 deep (K is zero-filled up to it).  The rule's
#: tile: rows and columns a block, K a chunk at most.
VMM_BWD_MMA_MFS, VMM_BWD_MMA_NTS, VMM_BWD_MMA_K16 = (1, 2), (2, 4), 16
VMM_BWD_MMA_BR, VMM_BWD_MMA_BN, VMM_BWD_MMA_MAX_KC = 32, 64, 128


@dataclass(frozen=True)
class VmmBwdMmaPlan:
    """The bf16 tensor-core fused backward's tile: ``br`` rows (of the
    seeds folded into ``[S*M]``) x ``bn`` columns a block, ``kc`` k (a
    multiple of 16) a ring stage, each warp ``16 mf`` rows x ``8 nt``
    columns.  No field changes the order of any sum: each output adds its
    k16 steps in k order."""
    br: int
    bn: int
    kc: int
    mf: int
    nt: int

    @property
    def threads(self) -> int:
        return 32 * (self.br // (16 * self.mf)) * (self.bn // (8 * self.nt))

    def blocks(self, rows: int, n: int) -> int:
        return cdiv(rows, self.br) * cdiv(n, self.bn)

    def smem_bytes(self, k: int) -> int:
        """2-byte elements, as ``csrc/vmm_bwd_bf16.cu`` lays them out: a
        stage is the block's g rows (``kc`` padded by 16 bytes; gated in
        place) and the weight chunk (rows of ``bn`` rounded up to an odd
        number of 8-column units); two stages where K takes more than one
        chunk, else one."""
        stage = (self.br * (self.kc + 8)
                 + self.kc * 8 * ((self.bn // 8) | 1))
        return 2 * (2 if k > self.kc else 1) * stage

    def args(self) -> Tuple[int, int, int, int, int]:
        return (self.br, self.bn, self.kc, self.mf, self.nt)


def vmm_bwd_mma_plan(s: int, m: int, k: int, n: int, *,
                     sms: int = H100_SMS) -> VmmBwdMmaPlan:
    """The bf16 tensor-core fused backward's tile for ``g [s, m, k] @ wt
    [k, n]`` on an H100, from ``python3 chip_smoke.py --sweep``: up to 32
    rows x 64 columns a block (16 or 32 columns where N needs no more), one
    m16 and two n8 fragments a warp, K in one chunk up to 128.  At FC0 ``[3,
    32, 128] @ [128, 4096]`` that is 192 blocks of 8 warps, each weight
    element fetched from L2 by three row blocks: 0.0097 ms between events
    against 0.0116 for the best plan holding all 96 rows in a block (one
    fetch), which leaves 128 or fewer blocks to hide the copies' latency;
    at FC1 (K = 10, one k16 step) it is within 2 % of the fastest.  The
    tile does not depend on ``sms``, which it takes as the other rules
    do."""
    rows = max(s * m, 1)
    br = min(VMM_BWD_MMA_BR, align_up(rows, 16))
    bn = max(b for b in (16, 32, VMM_BWD_MMA_BN)
             if b <= max(16, align_up(n, 16)))
    kc = min(VMM_BWD_MMA_MAX_KC, align_up(max(k, 1), VMM_BWD_MMA_K16))
    return VmmBwdMmaPlan(br, bn, kc, 1, 2)


def vmm_bwd_mma_candidates(s: int, m: int, k: int, n: int):
    """The tensor-core tile plans ``chip_smoke.py --sweep`` times for one
    launch (and the card tests hold bitwise to each other): 16 to 128 rows
    (no more than the launch has), 16 to 64 columns (no wider than N
    needs), chunks of 16 to 128 k (no deeper than K), 1 or 2 row fragments
    x 2 or 4 column fragments a warp, 32 to 256 threads, within 227 KB."""
    rows16 = align_up(max(s * m, 1), 16)
    brs = sorted({min(b, rows16) for b in (16, 32, 64, 96, 128)})
    kcs = sorted({min(c, align_up(max(k, 1), VMM_BWD_MMA_K16))
                  for c in (16, 32, 64, 128)})
    out = []
    for br in brs:
        for bn in (16, 32, 64):
            for kc in kcs:
                for mf in VMM_BWD_MMA_MFS:
                    for nt in VMM_BWD_MMA_NTS:
                        p = VmmBwdMmaPlan(br, bn, kc, mf, nt)
                        if (br % (16 * mf) == 0 and bn % (8 * nt) == 0
                                and bn <= max(16, align_up(n, 16))
                                and p.threads <= VMM_BWD_MAX_THREADS
                                and p.smem_bytes(k) <= VMM_BWD_SMEM_LIMIT):
                            out.append(p)
    return out


def _check_bwd_plan(name: str, plan, dtype: torch.dtype, esize: int,
                    k: int) -> None:
    """Raise unless the fused backward can run ``plan`` on ``dtype``
    (``esize``-byte) elements and K = ``k``: a :class:`VmmBwdMmaPlan` for
    bf16, a :class:`VmmBwdPlan` (or :data:`VMM_BWD_GENERAL`, f32 and int16
    only) otherwise."""
    if plan == VMM_BWD_GENERAL:
        return
    if dtype == torch.bfloat16:
        if (not isinstance(plan, VmmBwdMmaPlan)
                or plan.mf not in VMM_BWD_MMA_MFS
                or plan.nt not in VMM_BWD_MMA_NTS
                or plan.br < 16 * plan.mf or plan.br % (16 * plan.mf)
                or plan.bn < 8 * plan.nt or plan.bn % (8 * plan.nt)
                or plan.kc < VMM_BWD_MMA_K16 or plan.kc % VMM_BWD_MMA_K16
                or plan.threads > VMM_BWD_MAX_THREADS
                or plan.smem_bytes(k) > VMM_BWD_SMEM_LIMIT):
            raise ValueError(f"{name}: invalid tile plan {plan} for bf16 "
                             f"(the tensor cores take a VmmBwdMmaPlan)")
        return
    if not isinstance(plan, VmmBwdPlan):
        raise ValueError(f"{name}: invalid tile plan {plan}: the tensor-core "
                         f"route is bf16's only")
    if (plan.rm not in VMM_BWD_RMS or plan.br < plan.rm
            or plan.br % plan.rm or plan.bn < 4 or plan.bn % 4
            or plan.kc < VMM_BWD_KG or plan.kc % VMM_BWD_KG
            or plan.threads > VMM_BWD_MAX_THREADS
            or plan.smem_bytes(esize=esize) > VMM_BWD_SMEM_LIMIT):
        raise ValueError(f"{name}: invalid tile plan {plan}")


def _vmm_dims(name: str, x: torch.Tensor, w: torch.Tensor):
    """``(m, k, n)`` of ``[M, K] @ [K, N]``, or raise."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: need [M, K] @ [K, N], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    return x.shape[0], x.shape[1], w.shape[1]


def _fwd_operands(name: str, x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor], dtypes: tuple):
    """``(m, k, n)`` of a forward's operands, or raise: x of one of
    ``dtypes``, w and b of x's."""
    m, k, n = _vmm_dims(name, x, w)
    check(name, x, dtypes, what="x")
    check(name, w, x.dtype, what="w")
    if b is not None:
        check(name, b, x.dtype, (n,), what="b")
    return m, k, n


def vmm_fwd(name: str, counter: str, entries: dict,
            part_dtype: torch.dtype, plain: Callable, x: torch.Tensor,
            w: torch.Tensor, b: Optional[torch.Tensor],
            splits: Optional[int]) -> torch.Tensor:
    """Check, then run ``plain(x, w, b)`` on the CPU or launch the split-K
    forward of x's element type (``entries``: f32, int16) with ``splits``
    slices of K (:func:`vmm_splits`' when None), each :func:`vmm_slice`
    long, as many as K fills, and a ``[splits, M, N]`` workspace of
    ``part_dtype`` where K is split."""
    m, k, n = _fwd_operands(name, x, w, b, tuple(entries))
    if splits is None:
        splits = vmm_splits(m, k, n)
    elif not 1 <= splits <= vmm_max_splits(k):
        raise ValueError(f"{name}: splits={splits} not in [1, "
                         f"{vmm_max_splits(k)}] for K = {k}")
    if not on_card(name, x, w, b):
        return plain(x, w, b)
    check_kernel_operands(name, x, w, b)
    ks = vmm_slice(k, splits)
    splits = max(1, cdiv(k, ks))
    part = (torch.empty((splits, m, n), dtype=part_dtype, device=x.device)
            if splits > 1 else None)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel():
        _build.launch(counter, entries[x.dtype], x.device, x.data_ptr(),
                      w.data_ptr(), _build.ptr(b), y.data_ptr(), m, k, n,
                      _build.ptr(part), splits, ks)
    return y


def _vmm_plain(x, w, b):
    """The plain product, then ``+ b`` in x's type (bf16: after the
    rounding, as the reference adds it)."""
    y = ref.vmm_bf16(x, w) if x.dtype == torch.bfloat16 else ref.vmm(x, w)
    return y if b is None else y + b


@instrument("vmm_fwd")
def vmm(x: torch.Tensor, w: torch.Tensor,
        b: Optional[torch.Tensor] = None, *, plan=None) -> torch.Tensor:
    """[M, K] @ [K, N] (+ b [N]) -> [M, N], f32 accumulation; f32 or bf16
    (rounded once, then ``+ b`` in bf16).

    CPU tensors run :func:`ref.vmm` / :func:`ref.vmm_bf16` (then ``+ b``);
    CUDA tensors the kernel: f32 with ``plan`` slices of K (an int, a tile
    planner's entry) or, when it is None, :func:`vmm_splits`'; bf16 on the
    tensor cores, launched by ``plan`` (a :class:`VmmMmaPlan`) or
    :func:`vmm_mma_plan`'s.
    """
    if x.dtype == torch.bfloat16:
        return vmm_planned(x, w, b, plan=plan)
    return vmm_with_splits(x, w, b, splits=plan)


def vmm_with_splits(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *,
                    splits: Optional[int] = None) -> torch.Tensor:
    """:func:`vmm` on f32 with the number of K slices (1 to
    :func:`vmm_max_splits`; :func:`vmm_splits`' when None) chosen by the
    caller, for tests and sweeps; one count of ``vmm_fwd`` per call,
    whatever the split.  The slices are :func:`vmm_slice` long and as many
    as K fills, so none is empty."""
    return vmm_fwd("vmm", "vmm_fwd", {torch.float32: "repro_vmm_fwd"},
                   torch.float32, _vmm_plain, x, w, b, splits)


def vmm_planned(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *,
                plan: Optional[VmmMmaPlan] = None) -> torch.Tensor:
    """:func:`vmm` on bf16: the tensor-core kernel, launched by ``plan``
    (:func:`vmm_mma_plan`'s when None; tests and sweeps pass others, and
    plans of one cluster size give the same bits), with no workspace.
    One count of ``vmm_fwd`` per call."""
    m, k, n = _fwd_operands("vmm", x, w, b, (torch.bfloat16,))
    if plan is None:
        plan = vmm_mma_plan(m, k, n)
    _check_mma_plan("vmm", plan, k)
    if not on_card("vmm", x, w, b):
        return _vmm_plain(x, w, b)
    check_kernel_operands("vmm", x, w, b)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel():
        _build.launch("vmm_fwd", "repro_vmm_fwd_bf16", x.device,
                      x.data_ptr(), w.data_ptr(), _build.ptr(b),
                      y.data_ptr(), m, k, n, *plan.args(k))
    return y


def bwd_fused_plain(matmul: Callable, g, w, *, relu_mask=None, gate=None,
                    method="saliency", out_relu_mask=None, out_gate=None):
    """Gate, ``matmul(g, w)``, gate, as separate PyTorch ops."""
    gate, out_gate = validate_bp_gates(method, gate, relu_mask, out_gate,
                                       out_relu_mask)
    seeded = g.dim() == 3
    if not seeded:
        g = g[None]
    k, n = w.shape
    if gate:
        bits = None if relu_mask is None else unpack_bits(relu_mask)[:, :k]
        g = gate_gradient(g, bits, method)
    out = matmul(g, w)
    if out_gate:
        bits = (None if out_relu_mask is None
                else unpack_bits(out_relu_mask)[:, :n])
        out = gate_gradient(out, bits, method)
    return out if seeded else out[0]


def vmm_bwd_fused_plain(g, w, **kw):
    """Plain twin of :func:`vmm_bwd_fused`: gate, matmul, gate, as separate
    PyTorch ops; bf16 sums the widened values in f32 and rounds once,
    after the epilogue gate."""
    if g.dtype == torch.bfloat16:
        return bwd_fused_plain(ref.vmm_widened, g, w, **kw).to(
            torch.bfloat16)
    return bwd_fused_plain(torch.matmul, g, w, **kw)


#: Fused-backward entry point per element type: f32, and bf16.
_BWD_ENTRY = {torch.float32: "repro_vmm_bwd_fused",
              torch.bfloat16: "repro_vmm_bwd_fused_bf16"}


def bwd_fused(name: str, entries: dict, plain: Callable,
              g: torch.Tensor, w: torch.Tensor, *, relu_mask, gate, method,
              out_relu_mask, out_gate,
              plan=None) -> torch.Tensor:
    """Check the fused-backward operands, then run ``plain`` on the CPU or
    launch the entry of g's element type (``entries``, counted under
    ``name``), tiled by ``plan`` (when it is None :func:`vmm_bwd_mma_plan`'s
    for bf16, :func:`vmm_bwd_plan`'s otherwise; :data:`VMM_BWD_GENERAL` for
    the general kernel, which bf16 has not)."""
    gate, out_gate = validate_bp_gates(method, gate, relu_mask, out_gate,
                                       out_relu_mask)
    seeded = g.dim() == 3
    g3 = g if seeded else g[None]
    if g3.dim() != 3 or w.dim() != 2 or g3.shape[-1] != w.shape[0]:
        raise ValueError(f"{name}: need g [S, M, K] and w [K, N], got "
                         f"{tuple(g.shape)}, {tuple(w.shape)}")
    s, m, k = g3.shape
    n = w.shape[1]
    check(name, g3, tuple(entries), what="g")
    check(name, w, g.dtype, what="w")
    if relu_mask is not None:
        check(name, relu_mask, torch.uint8, (m, mask_bytes(k)),
              what="relu_mask")
    if out_relu_mask is not None:
        check(name, out_relu_mask, torch.uint8, (m, mask_bytes(n)),
              what="out_relu_mask")
    bf16 = g.dtype == torch.bfloat16
    if plan is None:
        plan = (vmm_bwd_mma_plan if bf16 else vmm_bwd_plan)(s, m, k, n)
    _check_bwd_plan(name, plan, g.dtype, g.element_size(), k)
    if not on_card(name, g3, w, relu_mask, out_relu_mask):
        return plain(g, w, relu_mask=relu_mask, gate=gate, method=method,
                     out_relu_mask=out_relu_mask, out_gate=out_gate)
    if plan == VMM_BWD_GENERAL and bf16:
        raise ValueError(f"{name}: bf16 has no general kernel; on the card "
                         f"it takes a tile plan")
    check_kernel_operands(name, g3, w, relu_mask, out_relu_mask)
    # bf16: the tensor-core kernel, counted under its route too
    counted = dict(route="vmm_bwd_fused_bf16_mma") if bf16 else {}
    out = torch.empty((s, m, n), dtype=g.dtype, device=g.device)
    if out.numel():
        _build.launch(name, entries[g.dtype], g.device, g3.data_ptr(),
                      w.data_ptr(),
                      _build.ptr(relu_mask), _build.ptr(out_relu_mask),
                      out.data_ptr(), s, m, k, n, int(gate), int(out_gate),
                      METHOD_CODES[method], *plan.args(), **counted)
    return out if seeded else out[0]


@instrument("vmm_bwd")
def vmm_bwd_fused(g: torch.Tensor, w: torch.Tensor, *,
                  relu_mask: Optional[torch.Tensor] = None,
                  gate: Optional[bool] = None,
                  method: str = "saliency",
                  out_relu_mask: Optional[torch.Tensor] = None,
                  out_gate: Optional[bool] = None,
                  plan=None) -> torch.Tensor:
    """One launch for an FC layer's whole backward step.

    ``g``: [M, K] or seed-batched [S, M, K] gradients w.r.t. the FC output.
    ``w``: [K, N], the TRANSPOSED weight (``W.T``, made contiguous once by
    the caller).  ``relu_mask``: [M, ceil(K/8)] packed mask of the layer's
    ReLU; ``gate=True`` with no mask selects the deconvnet rule.
    ``out_relu_mask``/``out_gate``: epilogue gate on the outgoing gradient,
    [M, ceil(N/8)].  Masks carry no seeds axis — shared across S.
    ``plan``: the tile (tests, sweeps): :func:`vmm_bwd_plan`'s by default,
    :data:`VMM_BWD_GENERAL` for the general kernel (f32 only); bf16 runs on
    the tensor cores, :class:`VmmBwdMmaPlan` by :func:`vmm_bwd_mma_plan`;
    every plan gives the same bits.  ``g`` and ``w`` are f32 or bf16 (f32
    sums, rounded once after the epilogue gate).
    CPU tensors run :func:`vmm_bwd_fused_plain`; CUDA tensors the kernel.
    """
    return bwd_fused("vmm_bwd_fused", _BWD_ENTRY,
                     vmm_bwd_fused_plain, g, w, relu_mask=relu_mask,
                     gate=gate, method=method, out_relu_mask=out_relu_mask,
                     out_gate=out_gate, plan=plan)
