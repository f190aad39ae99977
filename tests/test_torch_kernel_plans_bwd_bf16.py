"""The launch choices of the bf16 backwards on the tensor cores, on the CPU:
the route and tile of the fused conv backward (B5 bf16,
``conv_bwd_bf16_plan`` / ``conv_bwd_mma_plan``) and the tile of the fused
FC backward (B6 bf16, ``vmm_bwd_mma_plan``).  Both are pure functions of
the shape, so what they hand the card is pinned here, down to the
arguments the wrappers pass to the bf16 entry points (with the launch
itself stubbed) and the launches per route of the seed-batched pair; the
kernels are held against their plain versions by ``test_torch_cuda.py``
and ``chip_smoke.py`` on a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import masks
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import conv2d as conv_mod
from repro_torch.kernels.conv2d.conv2d import (CONV_BWD_GENERAL, CONV_KS,
                                               CONV_MAX_THREADS,
                                               CONV_MMA_TW, ConvBwdMmaPlan,
                                               ConvBwdPlan,
                                               conv2d_bwd_fused,
                                               conv2d_bwd_fused_plain,
                                               conv_bwd_bf16_plan,
                                               conv_bwd_mma_candidates,
                                               conv_bwd_mma_plan,
                                               conv_bwd_plan)
from repro_torch.kernels.conv2d.fxp import conv2d_bwd_fused_fxp
from repro_torch.kernels.pool import ref as pool_ref
from repro_torch.kernels.tiling import H100_SMS, cdiv, crumb_bytes
from repro_torch.kernels.vmm import vmm as vmm_mod
from repro_torch.kernels.vmm.fxp import vmm_bwd_fused_fxp
from repro_torch.kernels.vmm.vmm import (VMM_BWD_GENERAL, VmmBwdMmaPlan,
                                         VmmBwdPlan, vmm_bwd_fused,
                                         vmm_bwd_fused_plain,
                                         vmm_bwd_mma_candidates,
                                         vmm_bwd_mma_plan, vmm_bwd_plan)
from repro_torch.models import cnn

BF = torch.bfloat16
#: The most shared memory one H100 block may use.
SMEM_PER_BLOCK = 227 * 1024
#: The four backward launches of Table III's seed-batched explain at batch
#: 32, S = 3: (H, C, Cout', pooled), H the output size.
TABLE3_BWD = ((16, 64, 64, True), (16, 64, 32, False), (32, 32, 32, True),
              (32, 32, 3, False))
#: FC0 and FC1's backward launches: (S, M, K, N).
TABLE3_FC_BWD = ((3, 32, 128, 4096), (3, 32, 10, 128))
VMM_SHAPES = [(3, 32, 128, 4096), (3, 32, 10, 128), (1, 32, 128, 4096),
              (1, 4, 13, 21), (2, 7, 64, 40), (3, 50, 37, 20),
              (4, 33, 200, 9), (3, 100, 600, 300)]


# -- the conv backward: route and tile ---------------------------------------


@pytest.mark.parametrize("h,c,cout,pooled", TABLE3_BWD)
def test_table3_backward_layers_all_take_the_tensor_cores(h, c, cout,
                                                          pooled):
    plan = conv_bwd_bf16_plan(3, 32, h, h, c, cout, 3, pooled=pooled)
    assert plan == conv_bwd_mma_plan(3, 32, h, h, c, cout, 3, pooled=pooled)
    # all three seeds in each warp, but at layer 2, whose 4-row tile of 32
    # channels would leave 4 warps: one seed a warp at two rows a warp;
    # layer 0's three channels one n8 fragment a block, layer 3's 64 one
    # block; a block per SM or more
    if (cout, pooled) == (32, False):
        assert (plan.sg, plan.st, plan.mt) == (1, 3, 2)
    else:
        assert (plan.sg, plan.st, plan.mt) == (3, 1, 1)
    assert plan.tco == (8 if cout <= 8 else 64 if cout >= 64 else 32)
    assert plan.blocks(32, h, h, cout) >= 1 << (H100_SMS.bit_length() - 1)
    assert 6 * 32 <= plan.threads <= CONV_MAX_THREADS
    # one (seed group, chunk) pair: one ring stage
    assert plan.cin_t == c


@pytest.mark.parametrize("c", [1, 3, 8, 13, 24, 40, 600])
def test_c_off_the_k16_step_takes_ffma(c):
    plan = conv_bwd_bf16_plan(3, 2, 8, 8, c, 16, 3, pooled=True)
    assert plan == conv_bwd_plan(3, 2, 8, 8, c, 16, 3, pooled=True, esize=2)
    with pytest.raises(ValueError, match="multiple of 16"):
        conv_bwd_mma_plan(3, 2, 8, 8, c, 16, 3)


@pytest.mark.parametrize("c", [16, 32, 48, 64, 608])
def test_c_a_multiple_of_16_takes_the_tensor_cores(c):
    for s, cout, pooled in ((1, 3, False), (3, 64, True), (4, 13, True)):
        plan = conv_bwd_bf16_plan(s, 2, 8, 8, c, cout, 3, pooled=pooled)
        assert isinstance(plan, ConvBwdMmaPlan)


def _valid_mma(plan: ConvBwdMmaPlan, s, c, k, pooled):
    assert plan.sg in (1, 2, 3) and plan.st >= 1 and plan.frags <= 3
    assert plan.th % plan.mt == 0
    assert plan.tco == 8 or plan.tco % 32 == 0
    assert plan.cin_t % 16 == 0 and 16 <= plan.cin_t <= max(c, 16)
    assert 32 <= plan.threads <= CONV_MAX_THREADS
    assert plan.smem_bytes(k, c, s, pooled=pooled) <= SMEM_PER_BLOCK


def _covers(plan, s, n, h, w, cout):
    assert cdiv(h, plan.th) * plan.th >= h
    assert cdiv(w, CONV_MMA_TW) * CONV_MMA_TW >= w
    assert cdiv(cout, plan.tco) * plan.tco >= cout
    assert plan.seeds >= min(s, 3)          # all S <= 3 seeds in one block
    assert plan.blocks(n, h, w, cout) == (
        cdiv(h, plan.th) * cdiv(w, CONV_MMA_TW) * cdiv(cout, plan.tco) * n)


@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("k", CONV_KS)
def test_conv_bwd_mma_plan_within_shared_memory_and_covers(k, pooled):
    for s, n, h, w, c, cout in ((3, 32, 16, 16, 64, 64), (1, 1, 2, 2, 16, 3),
                                (4, 2, 14, 6, 32, 40), (3, 1, 32, 32, 608, 64),
                                (2, 3, 10, 34, 96, 8), (3, 32, 32, 32, 32, 3)):
        plan = conv_bwd_mma_plan(s, n, h, w, c, cout, k, pooled=pooled)
        _valid_mma(plan, s, c, k, pooled)
        _covers(plan, s, n, h, w, cout)


@pytest.mark.parametrize("h,c,cout,pooled", TABLE3_BWD)
def test_every_candidate_valid_and_the_rule_among_them(h, c, cout, pooled):
    cands = conv_bwd_mma_candidates(3, h, h, c, cout, 3, pooled=pooled)
    assert conv_bwd_mma_plan(3, 32, h, h, c, cout, 3, pooled=pooled) in cands
    assert len(set(cands)) == len(cands)
    for p in cands:
        _valid_mma(p, 3, c, 3, pooled)
        _covers(p, 3, 32, h, h, cout)


def test_conv_bwd_mma_smem_mirrors_the_c_layout():
    p = ConvBwdMmaPlan(4, 1, 32, 32, 3)
    xh, xw = 4 + 2, 16 + 2
    land = 2 * 3 * xh * xw * (32 + 8)            # unpooled: gated in place
    wts = 2 * 9 * 32 * (32 + 8)                  # 4 n8 columns -> 5 units
    masks_ = xh * xw * 32 // 8                   # a byte per 8 channels
    assert masks_ % 16 == 0
    assert p.smem_bytes(3, 32, 3) == land + wts + masks_
    assert p.smem_bytes(3, 64, 3) == 2 * (land + wts + masks_)  # 2 chunks
    assert p.smem_bytes(3, 32, 4) == 2 * (land + wts + masks_)  # 2 groups
    gh, gw = xh // 2 + 1, xw // 2 + 1
    crumbs = gh * gw * 32 // 4                   # a byte per 4 channels
    assert crumbs % 16 == 0
    assert p.smem_bytes(3, 32, 3, pooled=True) == (
        2 * 3 * xh * xw * 40 + 2 * 3 * gh * gw * 40 + wts + masks_ + crumbs)
    n8 = ConvBwdMmaPlan(4, 1, 8, 32, 3)          # one n8 column: 1 unit
    assert n8.smem_bytes(3, 32, 3) == land + 2 * 9 * 32 * 8 + masks_


@pytest.mark.parametrize("plan,c,k", [
    (ConvBwdMmaPlan(4, 1, 32, 16, 4), 32, 3),     # 4 seeds a warp
    (ConvBwdMmaPlan(4, 2, 32, 16, 2), 32, 3),     # 4 fragments a warp
    (ConvBwdMmaPlan(3, 2, 32, 16, 1), 32, 3),     # rows not whole warps
    (ConvBwdMmaPlan(4, 1, 16, 16, 3), 32, 3),     # 16 channels a block
    (ConvBwdMmaPlan(4, 1, 40, 16, 3), 32, 3),     # 40 channels a block
    (ConvBwdMmaPlan(4, 1, 32, 8, 3), 32, 3),      # chunk off the k16 step
    (ConvBwdMmaPlan(16, 1, 32, 16, 1, 3), 32, 3),  # 1536 threads
    (ConvBwdMmaPlan(4, 1, 32, 16, 3, 0), 32, 3),  # no seed slice
    (ConvBwdMmaPlan(16, 1, 64, 64, 3), 608, 7),   # > 227 KB
    (ConvBwdMmaPlan(4, 1, 32, 16, 3), 24, 3),     # C off the k16 step
    (ConvBwdMmaPlan(4, 1, 32, 16, 3), 32, 9)])    # K = 9
def test_bad_mma_plans_raise(plan, c, k):
    g = torch.zeros(3, 1, 8, 8, c, dtype=BF)
    with pytest.raises(ValueError, match="plan|multiple of 16"):
        conv2d_bwd_fused(g, torch.zeros(k, k, c, 8, dtype=BF), plan=plan)


def test_the_tensor_core_plan_is_bf16s_only():
    for dtype, fn in ((torch.float32, conv2d_bwd_fused),
                      (torch.int16, conv2d_bwd_fused_fxp)):
        g = torch.zeros(1, 1, 8, 8, 16, dtype=dtype)
        with pytest.raises(ValueError, match="bf16's only"):
            fn(g, torch.zeros(3, 3, 16, 8, dtype=dtype),
               plan=ConvBwdMmaPlan(4, 1, 32, 16, 1))


def _conv_operands(s, n, h, w, c, cout, k, pooled, method, gen):
    y = torch.randn(n, h, w, c, generator=gen)
    mask = None if method == "deconvnet" else masks.pack_mask(y > 0)
    idx = pool_ref.maxpool_fwd(torch.clamp_min(y, 0))[1] if pooled else None
    hg, wg = (h // 2, w // 2) if pooled else (h, w)
    g = torch.randn(s, n, hg, wg, c, generator=gen).to(BF)
    wt = (torch.randn(k, k, c, cout, generator=gen) * 0.1).to(BF)
    omask = masks.pack_mask(torch.randn(n, h, w, cout, generator=gen) > 0)
    kw = dict(pool_idx=idx, relu_mask=mask, gate=True, method=method,
              out_relu_mask=None if method == "deconvnet" else omask,
              out_gate=True)
    return g, wt, kw


@pytest.mark.parametrize("method", ["saliency", "deconvnet", "guided"])
def test_every_conv_plan_is_the_plain_version_on_the_cpu(method):
    gen = torch.Generator().manual_seed(0)
    g, wt, kw = _conv_operands(3, 2, 8, 6, 32, 13, 3, True, method, gen)
    want = conv2d_bwd_fused_plain(g, wt, **kw)
    plans = conv_bwd_mma_candidates(3, 8, 6, 32, 13, 3, pooled=True)
    for p in plans + [None, conv_bwd_plan(3, 2, 8, 6, 32, 13, 3, pooled=True,
                                          esize=2)]:
        assert torch.equal(conv2d_bwd_fused(g, wt, plan=p, **kw), want)


# -- the FC backward: the tile -----------------------------------------------


def test_fc0_32_rows_x_64_columns_a_block_fc1_one_k16_step():
    fc0 = vmm_bwd_mma_plan(3, 32, 128, 4096)
    # 32 of the three seeds' 96 rows a block, K in one chunk: 192 blocks of
    # 8 warps, each weight element fetched by three row blocks
    assert fc0 == VmmBwdMmaPlan(32, 64, 128, 1, 2)
    assert fc0.blocks(96, 4096) == 192 and fc0.threads == 256
    fc1 = vmm_bwd_mma_plan(3, 32, 10, 128)
    assert fc1.kc == 16 and fc1.br == 32          # K = 10: one k16 step
    assert vmm_bwd_mma_plan(1, 4, 13, 21) == VmmBwdMmaPlan(16, 32, 16, 1, 2)
    assert vmm_bwd_mma_plan(3, 100, 600, 300).kc == 128   # K in 5 chunks


@pytest.mark.parametrize("s,m,k,n", VMM_SHAPES)
def test_vmm_bwd_mma_plan_and_candidates_valid_and_cover(s, m, k, n):
    rows = s * m
    cands = vmm_bwd_mma_candidates(s, m, k, n)
    plan = vmm_bwd_mma_plan(s, m, k, n)
    assert plan in cands and len(set(cands)) == len(cands)
    for p in cands:
        assert p.mf in (1, 2) and p.nt in (2, 4)
        assert p.br % (16 * p.mf) == 0 and p.bn % (8 * p.nt) == 0
        assert p.kc % 16 == 0 and 32 <= p.threads <= 256
        assert p.smem_bytes(k) <= SMEM_PER_BLOCK
        assert cdiv(rows, p.br) * p.br >= rows
        assert cdiv(n, p.bn) * p.bn >= n
        assert p.blocks(rows, n) == cdiv(rows, p.br) * cdiv(n, p.bn)


def test_vmm_bwd_mma_smem_mirrors_the_c_layout():
    p = VmmBwdMmaPlan(96, 32, 64, 1, 4)
    stage = 96 * (64 + 8) + 64 * (32 + 8)
    assert p.smem_bytes(128) == 2 * 2 * stage      # two chunks: two stages
    assert p.smem_bytes(64) == 2 * stage
    assert VmmBwdMmaPlan(32, 16, 16, 1, 2).smem_bytes(10) == 2 * (
        32 * 24 + 16 * 24)                          # 2 n8 columns -> 3 units


@pytest.mark.parametrize("plan", [
    VmmBwdMmaPlan(96, 32, 64, 3, 4),       # no kernel for 3 row fragments
    VmmBwdMmaPlan(96, 32, 64, 1, 1),       # no kernel for 1 column fragment
    VmmBwdMmaPlan(40, 32, 64, 1, 4),       # rows off the m16 fragment
    VmmBwdMmaPlan(96, 24, 64, 1, 2),       # columns off 2 n8 fragments
    VmmBwdMmaPlan(96, 32, 24, 1, 4),       # chunk off the k16 step
    VmmBwdMmaPlan(256, 32, 64, 1, 4),      # 512 threads
    VmmBwdMmaPlan(96, 32, 4096, 1, 4),     # > 227 KB
    vmm_bwd_plan(3, 32, 128, 64)])         # the f32 / int16 tile
def test_bad_vmm_bwd_mma_plans_raise(plan):
    g, w = torch.zeros(3, 32, 128, dtype=BF), torch.zeros(128, 64, dtype=BF)
    with pytest.raises(ValueError, match="plan"):
        vmm_bwd_fused(g, w, plan=plan)


def test_the_fc_tensor_core_plan_is_bf16s_only():
    for dtype, fn in ((torch.float32, vmm_bwd_fused),
                      (torch.int16, vmm_bwd_fused_fxp)):
        g, w = torch.zeros(1, 4, 16, dtype=dtype), torch.zeros(16, 8,
                                                               dtype=dtype)
        with pytest.raises(ValueError, match="bf16's only"):
            fn(g, w, plan=VmmBwdMmaPlan(16, 16, 16, 1, 2))


@pytest.mark.parametrize("method", ["saliency", "deconvnet", "guided"])
def test_every_fc_plan_is_the_plain_version_on_the_cpu(method):
    gen = torch.Generator().manual_seed(1)
    s, m, k, n = 3, 7, 37, 20
    g = torch.randn(s, m, k, generator=gen).to(BF)
    w = (torch.randn(k, n, generator=gen) * 0.2).to(BF)
    mask = (None if method == "deconvnet"
            else masks.pack_mask(torch.randn(m, k, generator=gen) > 0))
    kw = dict(relu_mask=mask, gate=True, method=method)
    want = vmm_bwd_fused_plain(g, w, **kw)
    for p in vmm_bwd_mma_candidates(s, m, k, n) + [None]:
        assert torch.equal(vmm_bwd_fused(g, w, plan=p, **kw), want)


# -- the entry arguments, launch stubbed -------------------------------------


@pytest.fixture
def launches(monkeypatch):
    """Stub the card: the wrappers take their kernel route on CPU tensors
    and record ``(counter, entry, args, route)``."""
    out = []

    def launch(counter, entry, device, *args, route=None):
        out.append((counter, entry, args, route))

    for mod in (conv_mod, vmm_mod):
        monkeypatch.setattr(mod, "on_card", lambda name, *ts: True)
        monkeypatch.setattr(mod, "check_kernel_operands",
                            lambda name, *ts: None)
    monkeypatch.setattr(_build, "launch", launch)
    return out


def _bwd_operands(dtype, s, n, hg, wg, c, cout, k, pooled):
    g = torch.zeros(s, n, hg, wg, c, dtype=dtype)
    wt = torch.zeros(k, k, c, cout, dtype=dtype)
    h, w = (2 * hg, 2 * wg) if pooled else (hg, wg)
    kw = dict(relu_mask=masks.pack_mask(torch.ones(n, h, w, c,
                                                   dtype=torch.bool)))
    if pooled:
        kw["pool_idx"] = torch.zeros(n, hg, wg, crumb_bytes(c),
                                     dtype=torch.uint8)
    return g, wt, kw, (h, w)


def test_signatures_of_the_bf16_backwards():
    conv = _build.SIGNATURES["repro_conv2d_bwd_fused_bf16"]
    # the f32 entry's arguments with the route int before the plan
    assert conv == (_build.SIGNATURES["repro_conv2d_bwd_fused"][:16]
                    + [_build._I] * 7 + [_build._P])
    fc = _build.SIGNATURES["repro_vmm_bwd_fused_bf16"]
    # the f32 entry's arguments up to method, then a plan of five ints
    assert fc == (_build.SIGNATURES["repro_vmm_bwd_fused"][:12]
                  + [_build._I] * 5 + [_build._P])


@pytest.mark.parametrize("s,n,hg,wg,c,cout,k,pooled", [
    (3, 2, 4, 5, 16, 8, 3, True), (1, 1, 9, 7, 32, 3, 5, False),
    (4, 2, 3, 3, 608, 16, 1, True), (3, 32, 8, 8, 64, 64, 7, True)])
def test_conv_bf16_bwd_entry_gets_route_then_plan(launches, s, n, hg, wg, c,
                                                  cout, k, pooled):
    g, wt, kw, (h, w) = _bwd_operands(BF, s, n, hg, wg, c, cout, k, pooled)
    conv2d_bwd_fused(g, wt, method="guided", **kw)               # the rule
    ffma = ConvBwdPlan(2, 4, 16, 8, 1, 2)
    conv2d_bwd_fused(g, wt, method="guided", plan=ffma, **kw)    # FFMA
    cands = conv_bwd_mma_candidates(s, h, w, c, cout, k, pooled=pooled)
    for p in cands[:5]:
        conv2d_bwd_fused(g, wt, method="guided", plan=p, **kw)
    entry = "repro_conv2d_bwd_fused_bf16"
    assert {e for _, e, _, _ in launches} == {entry}
    assert {c_ for c_, _, _, _ in launches} == {"conv2d_bwd_fused"}
    for _, _, args, _ in launches:
        # every argument but the trailing stream, in argtype order
        assert len(args) + 1 == len(_build.SIGNATURES[entry])
        assert args[6:16] == (s, n, h, w, c, cout, k, 1, 0, 2)
    rule = conv_bwd_mma_plan(s, n, h, w, c, cout, k, pooled=pooled)
    assert launches[0][2][16:] == (1,) + rule.args()
    assert launches[1][2][16:] == (0,) + ffma.args()
    for (_, _, args, _), p in zip(launches[2:], cands):
        assert args[16:] == (1,) + p.args()
    # each launch counted under the kernel its route selects
    assert [r for *_, r in launches] == (
        ["conv2d_bwd_fused_bf16_mma", "conv2d_bwd_fused_bf16_ffma"]
        + ["conv2d_bwd_fused_bf16_mma"] * len(cands[:5]))
    assert {r for *_, r in launches} <= set(_build.ROUTE_LAUNCHES)


def test_conv_bf16_bwd_c13_gets_route_0(launches):
    g, wt, kw, (h, w) = _bwd_operands(BF, 3, 2, 4, 4, 13, 9, 3, True)
    conv2d_bwd_fused(g, wt, **kw)
    (_, _, args, route), = launches
    assert route == "conv2d_bwd_fused_bf16_ffma"
    assert args[16:] == (0,) + conv_bwd_plan(3, 2, h, w, 13, 9, 3,
                                             pooled=True, esize=2).args()


@pytest.mark.parametrize("s,m,k,n", VMM_SHAPES)
def test_vmm_bf16_bwd_entry_gets_the_plan(launches, s, m, k, n):
    g, w = torch.zeros(s, m, k, dtype=BF), torch.zeros(k, n, dtype=BF)
    mask = masks.pack_mask(torch.ones(m, k, dtype=torch.bool))
    vmm_bwd_fused(g, w, relu_mask=mask, method="guided")
    forced = vmm_bwd_mma_candidates(s, m, k, n)[-1]
    vmm_bwd_fused(g, w, gate=True, method="deconvnet", plan=forced)
    (c0, e0, a0, r0), (c1, e1, a1, r1) = launches
    assert c0 == c1 == "vmm_bwd_fused"
    assert e0 == e1 == "repro_vmm_bwd_fused_bf16"
    assert r0 == r1 == "vmm_bwd_fused_bf16_mma"
    assert len(a0) + 1 == len(_build.SIGNATURES[e0])
    assert a0[5:12] == (s, m, k, n, 1, 0, 2)
    assert a0[12:] == vmm_bwd_mma_plan(s, m, k, n).args()
    assert a1[12:] == forced.args() == (forced.br, forced.bn, forced.kc,
                                        forced.mf, forced.nt)


def test_bf16_general_plans_raise_on_the_card(launches):
    with pytest.raises(ValueError, match="bf16 has no general kernel"):
        conv2d_bwd_fused(torch.zeros(1, 1, 8, 8, 16, dtype=BF),
                         torch.zeros(3, 3, 16, 4, dtype=BF),
                         plan=CONV_BWD_GENERAL)
    with pytest.raises(ValueError, match="bf16 has no general kernel"):
        vmm_bwd_fused(torch.zeros(1, 2, 16, dtype=BF),
                      torch.zeros(16, 4, dtype=BF), plan=VMM_BWD_GENERAL)
    assert launches == []


@pytest.mark.parametrize("dtype,conv_entry,fc_entry", [
    (torch.float32, "repro_conv2d_bwd_fused", "repro_vmm_bwd_fused"),
    (torch.int16, "repro_conv2d_bwd_fused_fxp", "repro_vmm_bwd_fused_fxp")],
    ids=["f32", "int16"])
def test_f32_and_int16_entries_keep_their_arguments(launches, dtype,
                                                    conv_entry, fc_entry):
    conv = conv2d_bwd_fused if dtype == torch.float32 else \
        conv2d_bwd_fused_fxp
    fc = vmm_bwd_fused if dtype == torch.float32 else vmm_bwd_fused_fxp
    g, wt, kw, (h, w) = _bwd_operands(dtype, 3, 2, 4, 4, 32, 16, 3, True)
    conv(g, wt, **kw)
    fc(torch.zeros(3, 32, 128, dtype=dtype), torch.zeros(128, 64,
                                                         dtype=dtype))
    (_, ec, ac, rc), (_, ev, av, rv) = launches
    assert (ec, ev) == (conv_entry, fc_entry) and rc is rv is None
    assert len(_build.SIGNATURES[ec]) == len(ac) + 1 == 23
    assert ac[16:] == conv_bwd_plan(3, 2, h, w, 32, 16, 3, pooled=True,
                                    esize=g.element_size()).args()
    assert len(_build.SIGNATURES[ev]) == len(av) + 1 == 17
    assert av[12:] == vmm_bwd_plan(3, 32, 128, 64).args()
    assert all(isinstance(p, VmmBwdPlan) for p in [vmm_bwd_plan(3, 32, 128,
                                                                64)])


# -- the seed-batched pair, counted per route ---------------------------------


@pytest.fixture
def stub_card(monkeypatch):
    """The real ``_build.launch`` (its counters) on a library whose every
    entry point returns 0, and the wrappers taking their kernel route on
    CPU tensors: the outputs are uninitialised buffers, only the routing
    and the counts are checked."""
    from repro_torch.kernels.pool import pool as pool_mod
    from repro_torch.kernels.relu_mask import relu_mask as relu_mod

    class Lib:
        def repro_set_device(self, index):
            return 0

        def __getattr__(self, entry):
            return lambda *args: 0

    class Stream:
        cuda_stream = 0

    for mod in (conv_mod, vmm_mod, pool_mod, relu_mod):
        monkeypatch.setattr(mod, "on_card", lambda name, *ts: True)
        monkeypatch.setattr(mod, "check_kernel_operands",
                            lambda name, *ts: None)
    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    _build.reset_launches()
    yield
    _build.reset_launches()


@pytest.mark.parametrize("method", ["saliency", "deconvnet", "guided"])
def test_table3_bf16_pair_counts_tensor_core_backwards_per_route(stub_card,
                                                                 method):
    cfg = cnn.CNNConfig()                       # Table III, full width
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 32, 32, 3).astype(np.float32))
    logits, res = cnn.forward_with_residuals(params, x, cfg, method, "bf16")
    seeds = torch.eye(cfg.num_classes)[:3, None].expand(3, 2,
                                                        cfg.num_classes)
    before = dict(_build.ROUTE_LAUNCHES)
    cnn.backward_seeds(params, res, seeds, cfg, method, "bf16")
    rose = {k: v - before[k] for k, v in _build.ROUTE_LAUNCHES.items()
            if v != before[k]}
    # per explain: the four conv backwards and the two FC backwards on the
    # tensor cores, none on the FFMA instance
    assert rose == {"conv2d_bwd_fused_bf16_mma": 4,
                    "vmm_bwd_fused_bf16_mma": 2}
    assert _build.ENTRY_LAUNCHES["repro_conv2d_bwd_fused_bf16"] == 4
    assert _build.ENTRY_LAUNCHES["repro_vmm_bwd_fused_bf16"] == 2
    assert _build.ENTRY_LAUNCHES["repro_conv2d_bwd_fused"] == 0
    # and the forwards: layers 1-3 on the tensor cores, layer 0 on FFMA
    assert {k: before[k] for k in ("conv2d_fwd_bf16_mma",
                                   "conv2d_fwd_bf16_ffma")} == {
        "conv2d_fwd_bf16_mma": 3, "conv2d_fwd_bf16_ffma": 1}
