"""The launch choice of the tiled fused conv backward (B5 f32, B8 int16:
``conv_bwd_plan``), on the CPU.  The plan is a pure function of the shape,
so what it hands the card is pinned here, down to the arguments the
wrappers pass to ``repro_conv2d_bwd_fused`` and ``repro_conv2d_bwd_fused_fxp``
(with the launch itself stubbed); the kernels are held against their plain
versions, and against the general kernel bit for bit, by
``test_torch_cuda.py`` and ``chip_smoke.py`` on a card.
"""
import pytest
import torch

from repro_torch.core import masks
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import conv2d as conv_mod
from repro_torch.kernels.conv2d.conv2d import (CONV_BWD_GENERAL,
                                               CONV_BWD_SEED_GROUPS,
                                               CONV_KS,
                                               CONV_MAX_THREADS, CONV_TILE_W,
                                               ConvBwdPlan, bwd_cin_step,
                                               conv2d_bwd_fused,
                                               conv_bwd_plan)
from repro_torch.kernels.conv2d.fxp import conv2d_bwd_fused_fxp
from repro_torch.kernels.tiling import H100_SMS, cdiv, crumb_bytes

#: The fused backward's four launches of a Table III explain at batch 32:
#: (H, C, Cout', pooled) of layers 3, 2, 1, 0.
TABLE3_BWD = ((16, 64, 64, True), (16, 64, 32, False), (32, 32, 32, True),
              (32, 32, 3, False))
#: The most shared memory one block may use on an H100.
SMEM_PER_BLOCK = 227 * 1024
ENTRIES = (("repro_conv2d_bwd_fused", conv2d_bwd_fused, torch.float32),
           ("repro_conv2d_bwd_fused_fxp", conv2d_bwd_fused_fxp, torch.int16))


def _valid(plan: ConvBwdPlan, c: int, k: int, pooled: bool, esize: int,
           n: int, h: int, w: int, cout: int):
    assert plan.px in (4, 8) and plan.tco % 4 == 0 and plan.th >= 1
    assert plan.sg in CONV_BWD_SEED_GROUPS and plan.st >= 1
    assert 1 <= plan.threads <= CONV_MAX_THREADS
    assert 1 <= plan.cin_t <= max(c, 1)
    # 16-byte copies stay whole: int16 rows where C % 8 == 0, f32 where 4
    assert plan.cin_t % bwd_cin_step(c) == 0
    smem = plan.smem_bytes(k, pooled=pooled, esize=esize)
    assert smem <= SMEM_PER_BLOCK
    # a chunk over the smallest whole one still lets the blocks the grid
    # puts on an SM reside there together
    if plan.cin_t > bwd_cin_step(c):
        per_sm = min(cdiv(plan.blocks(n, h, w, cout), H100_SMS),
                     2048 // plan.threads)
        assert per_sm * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("c", [1, 3, 13, 20, 32, 64, 96, 600])
@pytest.mark.parametrize("k", CONV_KS)
def test_bwd_plan_fits_shared_memory_up_to_c_600(c, k):
    for s, n, h, w, cout in ((3, 32, 32, 32, 3), (1, 1, 1, 1, 3),
                             (2, 2, 14, 10, 40), (5, 32, 16, 16, 600)):
        for pooled in (False, True):
            for esize in (4, 2):              # f32, int16
                plan = conv_bwd_plan(s, n, h, w, c, cout, k, pooled=pooled,
                                     esize=esize)
                _valid(plan, c, k, pooled, esize, n, h, w, cout)


def test_bwd_plan_bounds_grow_with_the_chunk_not_with_c():
    """The landing buffer, compute buffer and weight stage hold one chunk:
    a plan's shared memory is the same at C = 64 and C = 600."""
    p = ConvBwdPlan(8, 4, 32, 16, 3)
    assert conv_bwd_plan(3, 32, 16, 16, 600, 32, 3).cin_t \
        == conv_bwd_plan(3, 32, 16, 16, 64, 32, 3).cin_t
    # the pooled landing buffer is the Hg x Wg tile: under half the bytes
    land = p.smem_bytes(3) - p.smem_bytes(3, pooled=True)
    assert land > 0 and p.smem_bytes(3, esize=2) < p.smem_bytes(3)


@pytest.mark.parametrize("s,n,h,w,cout", [
    (3, 32, 32, 32, 3), (1, 1, 13, 7, 96), (3, 3, 1, 1, 2), (2, 2, 9, 7, 40),
    (1, 32, 16, 16, 64), (4, 2, 6, 10, 9)])
def test_bwd_plan_grid_covers_every_output(s, n, h, w, cout):
    plan = conv_bwd_plan(s, n, h, w, 16, cout, 3)
    assert cdiv(h, plan.th) * plan.th >= h
    assert cdiv(w, CONV_TILE_W) * CONV_TILE_W >= w
    assert cdiv(cout, plan.tco) * plan.tco >= cout
    assert plan.tco <= max(32, cout)       # no block of idle channels
    assert plan.seeds == min(s, 3)         # every seed in a group of <= 3
    assert plan.sg == 1 or plan.st == 1


@pytest.mark.parametrize("h,c,cout,pooled", TABLE3_BWD)
@pytest.mark.parametrize("s", [3, 1])
@pytest.mark.parametrize("esize", [4, 2])
def test_bwd_plan_on_table3_one_seed_group_and_a_full_card(h, c, cout,
                                                           pooled, s, esize):
    """S = 3 (seed-batched top-3) and S = 1 (the vjp path): all seeds in
    one block, so the residuals are read once; a block per SM at least
    (128 of them: the grid's tiles are powers of two)."""
    plan = conv_bwd_plan(s, 32, h, h, c, cout, 3, pooled=pooled,
                         esize=esize)
    assert plan.seeds == s
    assert plan.blocks(32, h, h, cout) >= 128
    # the sweep's winners: the seeds in each thread on the pooled layers
    # (3 and 1: 8 and 16 warps an SM), across slices on the unpooled ones
    assert (plan.sg, plan.st) == ((s, 1) if pooled else (1, s))


def test_bwd_plan_rejects_kernel_sizes_it_was_not_built_for():
    with pytest.raises(ValueError, match="K in"):
        conv_bwd_plan(3, 1, 8, 8, 4, 4, 9)


@pytest.fixture
def launches(monkeypatch):
    """Stub the card: the wrappers take their kernel route on CPU tensors
    and record ``(entry, args)``."""
    out = []

    def launch(counter, entry, device, *args):
        out.append((entry, args))

    monkeypatch.setattr(conv_mod, "on_card", lambda name, *ts: True)
    monkeypatch.setattr(conv_mod, "check_kernel_operands",
                        lambda name, *ts: None)
    monkeypatch.setattr(_build, "launch", launch)
    return out


def _operands(dtype, s, n, hg, wg, c, cout, k, pooled):
    g = torch.zeros(s, n, hg, wg, c, dtype=dtype)
    wt = torch.zeros(k, k, c, cout, dtype=dtype)
    h, w = (2 * hg, 2 * wg) if pooled else (hg, wg)
    kw = dict(relu_mask=masks.pack_mask(torch.ones(n, h, w, c,
                                                   dtype=torch.bool)))
    if pooled:
        kw["pool_idx"] = torch.zeros(n, hg, wg, crumb_bytes(c),
                                     dtype=torch.uint8)
    return g, wt, kw, (h, w)


@pytest.mark.parametrize("entry,fn,dtype", ENTRIES,
                         ids=["f32", "int16"])
@pytest.mark.parametrize("s,n,hg,wg,c,cout,k,pooled", [
    (3, 2, 4, 5, 16, 8, 3, True), (1, 1, 9, 7, 13, 3, 5, False),
    (2, 2, 3, 3, 600, 16, 1, True), (3, 32, 8, 8, 64, 64, 7, True)])
def test_bwd_plan_reaches_the_entry_in_argtype_order(launches, entry, fn,
                                                     dtype, s, n, hg, wg, c,
                                                     cout, k, pooled):
    g, wt, kw, (h, w) = _operands(dtype, s, n, hg, wg, c, cout, k, pooled)
    fn(g, wt, method="guided", **kw)
    (got_entry, args), = launches
    assert got_entry == entry
    # every argument but the trailing stream, in the order of the argtypes
    assert len(args) + 1 == len(_build.SIGNATURES[entry])
    assert args[6:16] == (s, n, h, w, c, cout, k, 1, 0, 2)
    assert args[16:] == conv_bwd_plan(s, n, h, w, c, cout, k, pooled=pooled,
                                      esize=g.element_size()).args()


@pytest.mark.parametrize("entry,fn,dtype", ENTRIES, ids=["f32", "int16"])
def test_bwd_k9_and_the_general_plan_get_the_general_args(launches, entry,
                                                          fn, dtype):
    g, wt, kw, _ = _operands(dtype, 2, 1, 6, 5, 8, 12, 9, False)
    fn(g, wt, **kw)                                   # K = 9: general
    fn(g, wt, plan=CONV_BWD_GENERAL, **kw)
    g3, wt3, kw3, _ = _operands(dtype, 2, 1, 6, 5, 8, 12, 3, True)
    fn(g3, wt3, plan=CONV_BWD_GENERAL, **kw3)         # K = 3, forced
    plan = ConvBwdPlan(2, 4, 16, 4, 1, 2)
    fn(g3, wt3, plan=plan, **kw3)                     # K = 3, forced tile
    assert [a[16:] for _, a in launches] == [(0,) * 6] * 3 + [plan.args()]
    assert [a[12] for _, a in launches] == [9, 9, 3, 3]


@pytest.mark.parametrize("plan,k", [
    (ConvBwdPlan(8, 5, 32, 8, 3), 3),      # px not 4 or 8
    (ConvBwdPlan(8, 4, 30, 8, 3), 3),      # tco not a multiple of 4
    (ConvBwdPlan(8, 4, 32, 8, 4), 3),      # no kernel for 4 seeds a thread
    (ConvBwdPlan(8, 8, 32, 8, 2), 3),      # 2 x 8 x 4 accumulators spill
    (ConvBwdPlan(8, 4, 32, 8, 1, 0), 3),   # no thread slice
    (ConvBwdPlan(32, 4, 64, 8, 1), 3),     # 1024 threads
    (ConvBwdPlan(8, 4, 32, 0, 1), 3),      # empty chunk
    (ConvBwdPlan(32, 4, 32, 64, 3), 7),    # > 227 KB of shared memory
    (ConvBwdPlan(8, 4, 32, 8, 3), 9)])     # a tile plan for K = 9
@pytest.mark.parametrize("fn,dtype", [(conv2d_bwd_fused, torch.float32),
                                      (conv2d_bwd_fused_fxp, torch.int16)],
                         ids=["f32", "int16"])
def test_bwd_bad_plan_raises(launches, fn, dtype, plan, k):
    g, wt, kw, _ = _operands(dtype, 1, 1, 4, 4, 64, 8, k, False)
    with pytest.raises(ValueError, match="plan"):
        fn(g, wt, plan=plan, **kw)
    assert not launches


def test_bwd_plan_and_general_plan_run_the_plain_version_on_the_cpu():
    """On CPU tensors a plan only has to be valid: every plan gives the
    plain version's result."""
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(2, 1, 4, 4, 8, generator=gen)
    wt = torch.randn(3, 3, 8, 5, generator=gen)
    want = conv2d_bwd_fused(g, wt)
    for plan in (CONV_BWD_GENERAL, ConvBwdPlan(1, 8, 4, 1, 1)):
        assert torch.equal(conv2d_bwd_fused(g, wt, plan=plan), want)
