"""The launch choice of the tiled fused FC backward (B6 f32, B10 int16:
``vmm_bwd_plan``), on the CPU.  The plan is a pure function of the shape,
so what it hands the card is pinned here, down to the arguments the
wrappers pass to ``repro_vmm_bwd_fused`` and ``repro_vmm_bwd_fused_fxp``
(with the launch itself stubbed); the kernels are held against the general
kernel (f32) and the plain version (int16) bit for bit by
``test_torch_cuda.py`` and ``chip_smoke.py`` on a card.
"""
import pytest
import torch

from repro_torch.core import masks
from repro_torch.kernels import _build
from repro_torch.kernels.tiling import H100_SMS, align_up, cdiv, mask_bytes
from repro_torch.kernels.vmm import vmm as vmm_mod
from repro_torch.kernels.vmm.fxp import (vmm_bwd_fused_fxp,
                                         vmm_bwd_fused_fxp_plain)
from repro_torch.kernels.vmm.vmm import (VMM_BWD_GENERAL, VMM_BWD_KG,
                                         VMM_BWD_MAX_THREADS, VMM_BWD_RMS,
                                         VmmBwdPlan, vmm_bwd_candidates,
                                         vmm_bwd_fused, vmm_bwd_fused_plain,
                                         vmm_bwd_plan)

#: The most shared memory one block may use on an H100.
SMEM_PER_BLOCK = 227 * 1024
#: (S, M, K, N): the main path's FC1 and FC0 at S = 3 and 1, the card
#: tests' ragged shapes, and wide or deep layers.
SHAPES = [(3, 32, 10, 128), (3, 32, 128, 4096), (1, 32, 10, 128),
          (1, 32, 128, 4096), (1, 4, 13, 21), (3, 33, 128, 300),
          (5, 7, 200, 65), (1, 1, 1, 1), (10, 1024, 4096, 4096),
          (2, 3, 600, 9), (3, 130, 7, 1000), (3, 3, 10, 128)]
ENTRIES = (("repro_vmm_bwd_fused", vmm_bwd_fused, torch.float32),
           ("repro_vmm_bwd_fused_fxp", vmm_bwd_fused_fxp, torch.int16))


def _valid(plan: VmmBwdPlan, k: int):
    assert plan.rm in VMM_BWD_RMS and plan.br % plan.rm == 0
    assert plan.bn % 4 == 0 and plan.bn >= 4
    assert 1 <= plan.threads <= VMM_BWD_MAX_THREADS
    assert plan.kc % VMM_BWD_KG == 0
    assert VMM_BWD_KG <= plan.kc <= align_up(k, VMM_BWD_KG)
    for esize in (4, 2):                    # f32, int16
        assert plan.smem_bytes(esize=esize) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("s,m,k,n", SHAPES)
def test_vmm_bwd_plan_stays_within_shared_memory(s, m, k, n):
    _valid(vmm_bwd_plan(s, m, k, n), k)


@pytest.mark.parametrize("s,m,k,n", SHAPES)
def test_vmm_bwd_plan_grid_covers_every_output(s, m, k, n):
    plan = vmm_bwd_plan(s, m, k, n)
    rows = s * m
    assert cdiv(rows, plan.br) * plan.br >= rows
    assert cdiv(n, plan.bn) * plan.bn >= n
    assert plan.blocks(rows, n) == cdiv(rows, plan.br) * cdiv(n, plan.bn)
    assert plan.br <= max(32, align_up(rows, plan.rm))   # no idle rows
    assert plan.bn <= max(16, align_up(n, 16))           # no idle columns


@pytest.mark.parametrize("s", [3, 1])
def test_vmm_bwd_plan_fills_the_card_on_fc0(s):
    """FC0's launch, [S, 32, 128] @ [128, 4096], at the seed-batched S = 3
    and the vjp and training S = 1: a block per SM at least (128, the SMs
    rounded down to a power of two, as the tiles and FC0 are powers of
    two), K = 128 in whole chunks."""
    plan = vmm_bwd_plan(s, 32, 128, 4096)
    assert plan.blocks(s * 32, 4096) >= 1 << (H100_SMS.bit_length() - 1)
    assert 128 % plan.kc == 0


@pytest.mark.parametrize("s,m,k,n", SHAPES[:8])
def test_vmm_bwd_candidates_are_valid(s, m, k, n):
    plans = vmm_bwd_candidates(s, m, k, n)
    assert plans and len(set(plans)) == len(plans)
    for p in plans:
        _valid(p, k)
    assert VMM_BWD_GENERAL not in plans


def test_smem_bytes_mirrors_the_kernel_layout():
    """The compute buffer ([kc][br] words; int16 also [kc][bn] words), then
    two stages of landing rows padded by 16 bytes and the weight chunk
    [kc][bn], each rounded up to 16 bytes: ``csrc/vmm_bwd.cuh``
    ``launch_tiled``."""
    p = VmmBwdPlan(32, 64, 32, 4)
    assert p.smem_bytes() == 4 * 32 * 32 + 2 * (4 * 32 * 36 + 4 * 32 * 64)
    assert p.smem_bytes(esize=2) == (4 * 32 * 32 + 4 * 32 * 64
                                     + 2 * (2 * 32 * 40 + 2 * 32 * 64))
    q = VmmBwdPlan(4, 4, 8, 2)   # an odd int16 weight chunk rounds up
    assert q.smem_bytes(esize=2) == (4 * 8 * 4 + 4 * 8 * 4
                                     + 2 * (align_up(2 * 4 * 16, 16)
                                            + align_up(2 * 8 * 4, 16)))


@pytest.fixture
def launches(monkeypatch):
    """Stub the card: the wrappers take their kernel route on CPU tensors
    and record ``(entry, args, tensors handed to _build.ptr)``."""
    seen, out = [], []
    real_ptr = _build.ptr

    def ptr(t):
        seen.append(t)
        return real_ptr(t)

    def launch(counter, entry, device, *args):
        out.append((entry, args, list(seen)))
        seen.clear()

    monkeypatch.setattr(vmm_mod, "on_card", lambda name, *ts: True)
    monkeypatch.setattr(vmm_mod, "check_kernel_operands",
                        lambda name, *ts: None)
    monkeypatch.setattr(_build, "ptr", ptr)
    monkeypatch.setattr(_build, "launch", launch)
    return out


def _operands(dtype, s, m, k, n):
    g = torch.zeros(s, m, k, dtype=dtype)
    w = torch.zeros(k, n, dtype=dtype)
    mask = masks.pack_mask(torch.ones(m, k, dtype=torch.bool))
    omask = masks.pack_mask(torch.ones(m, n, dtype=torch.bool))
    return g, w, mask, omask


@pytest.mark.parametrize("entry,fn,dtype", ENTRIES, ids=["f32", "int16"])
@pytest.mark.parametrize("s,m,k,n", [(3, 32, 128, 4096), (1, 32, 128, 4096),
                                     (3, 32, 10, 128), (1, 4, 13, 21)])
def test_vmm_bwd_plan_reaches_the_entry_in_argtype_order(launches, entry, fn,
                                                         dtype, s, m, k, n):
    g, w, mask, omask = _operands(dtype, s, m, k, n)
    fn(g, w, relu_mask=mask, method="guided", out_relu_mask=omask)
    (got_entry, args, tensors), = launches
    assert got_entry == entry
    # every argument but the trailing stream, in the order of the argtypes
    assert len(args) + 1 == len(_build.SIGNATURES[entry]) == 17
    assert args[5:12] == (s, m, k, n, 1, 1, 2)
    assert args[12:] == vmm_bwd_plan(s, m, k, n).args()
    assert tensors[0] is mask and tensors[1] is omask


@pytest.mark.parametrize("entry,fn,dtype", ENTRIES, ids=["f32", "int16"])
def test_vmm_bwd_general_and_forced_plans_reach_the_entry(launches, entry,
                                                          fn, dtype):
    g, w, mask, _ = _operands(dtype, 3, 33, 128, 300)
    forced = VmmBwdPlan(16, 128, 64, 2)
    fn(g, w, relu_mask=mask, plan=VMM_BWD_GENERAL)
    fn(g[0], w, gate=True, method="deconvnet", plan=forced)   # unseeded
    fn(g, w, plan=None)
    assert [a[12:] for _, a, _ in launches] == [
        (0, 0, 0, 0), forced.args(), vmm_bwd_plan(3, 33, 128, 300).args()]
    assert [a[5:12] for _, a, _ in launches] == [
        (3, 33, 128, 300, 1, 0, 0), (1, 33, 128, 300, 1, 0, 1),
        (3, 33, 128, 300, 0, 0, 0)]


@pytest.mark.parametrize("plan", [
    VmmBwdPlan(32, 64, 32, 3),         # no kernel for 3 rows a thread
    VmmBwdPlan(30, 64, 32, 4),         # rows not a multiple of rm
    VmmBwdPlan(32, 62, 32, 4),         # columns not a multiple of 4
    VmmBwdPlan(32, 64, 12, 4),         # chunk not whole mask bytes
    VmmBwdPlan(32, 64, 0, 4),          # empty chunk
    VmmBwdPlan(64, 128, 32, 2),        # 1024 threads
    VmmBwdPlan(256, 16, 2048, 4)])     # > 227 KB of shared memory
@pytest.mark.parametrize("fn,dtype", [(vmm_bwd_fused, torch.float32),
                                      (vmm_bwd_fused_fxp, torch.int16)],
                         ids=["f32", "int16"])
def test_vmm_bwd_bad_plan_raises(launches, fn, dtype, plan):
    g, w, mask, _ = _operands(dtype, 1, 8, 64, 32)
    with pytest.raises(ValueError, match="plan"):
        fn(g, w, relu_mask=mask, plan=plan)
    assert not launches


@pytest.mark.parametrize("s,m,k,n", [(3, 5, 13, 21), (2, 7, 40, 9)])
def test_vmm_bwd_every_plan_runs_the_plain_version_on_the_cpu(s, m, k, n):
    """On CPU tensors a plan only has to be valid: every plan gives the
    plain version's result, f32 and int16."""
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(s, m, k, generator=gen)
    w = torch.randn(k, n, generator=gen)
    gi = torch.randint(-4000, 4000, (s, m, k), generator=gen,
                       dtype=torch.int16)
    wi = torch.randint(-4000, 4000, (k, n), generator=gen, dtype=torch.int16)
    mask = masks.pack_mask(torch.randn(m, k, generator=gen) > 0)
    assert mask.shape == (m, mask_bytes(k))
    kw = dict(relu_mask=mask, method="guided")
    want = vmm_bwd_fused_plain(g, w, **kw)
    wanti = vmm_bwd_fused_fxp_plain(gi, wi, **kw)
    for plan in [None, VMM_BWD_GENERAL] + vmm_bwd_candidates(s, m, k, n)[:4]:
        assert torch.equal(vmm_bwd_fused(g, w, plan=plan, **kw), want)
        assert torch.equal(vmm_bwd_fused_fxp(gi, wi, plan=plan, **kw), wanti)
