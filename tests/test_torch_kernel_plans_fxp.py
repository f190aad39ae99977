"""The launch choices of the redesigned int16 forwards, on the CPU: the tile
of the conv forward (B7: ``conv_plan`` at 2-byte elements, the f32
forward's rule with an int16 chunk) and the K split of the FC forward (B9:
``vmm_splits``, shared with the f32 forward).  Both are pure functions of
the shape, so what they hand the card is pinned here, down to the
arguments the wrappers pass to ``repro_conv2d_fxp_fwd`` and
``repro_vmm_fxp_fwd`` (with the launch itself stubbed); the kernels are
held against their plain versions bit for bit by ``test_torch_cuda.py``
and ``chip_smoke.py`` on a card.
"""
import pytest
import torch

from repro_torch.core import masks
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import conv2d as conv_mod
from repro_torch.kernels.conv2d import ref as conv_ref
from repro_torch.kernels.conv2d.conv2d import (CONV_GENERAL, CONV_KS,
                                               CONV_MAX_THREADS, CONV_TILE_W,
                                               ConvPlan, conv_plan)
from repro_torch.kernels.conv2d.fxp import conv2d_fxp, conv2d_fxp_planned
from repro_torch.kernels.tiling import H100_SMS, align_up, cdiv
from repro_torch.kernels.vmm import ref as vmm_ref
from repro_torch.kernels.vmm import vmm as vmm_mod
from repro_torch.kernels.vmm.fxp import (vmm_bwd_fused_fxp, vmm_fxp,
                                         vmm_fxp_with_splits)
from repro_torch.kernels.vmm.vmm import (SPLIT_CHUNK_K, vmm_bwd_plan,
                                         vmm_max_splits, vmm_slice,
                                         vmm_splits)

#: The four conv layers of Table III at batch 32: (H, Cin, Cout).
TABLE3_CONVS = ((32, 3, 32), (32, 32, 32), (16, 32, 64), (16, 64, 64))
#: The most shared memory one block may use on an H100.
SMEM_PER_BLOCK = 227 * 1024
I16 = 2  # bytes an int16 element


def _valid(plan: ConvPlan, cin: int, k: int):
    assert plan.px in (4, 8) and plan.tco % 4 == 0 and plan.th >= 1
    assert 1 <= plan.threads <= CONV_MAX_THREADS
    assert 1 <= plan.cin_t <= max(cin, 1)
    if cin % 8 == 0:                        # 16-byte int16 copies stay whole
        assert plan.cin_t % 8 == 0
    assert plan.smem_bytes(k, esize=I16) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("cin", [1, 3, 5, 13, 32, 64, 96, 100, 600])
@pytest.mark.parametrize("k", CONV_KS)
def test_fxp_conv_plan_stays_within_shared_memory(cin, k):
    for n, h, w, cout in ((32, 32, 32, 32), (1, 1, 1, 3), (2, 13, 7, 96),
                          (32, 16, 16, 600)):
        _valid(conv_plan(n, h, w, cin, cout, k, esize=I16), cin, k)


@pytest.mark.parametrize("n,h,w,cout", [(32, 32, 32, 3), (1, 13, 7, 96),
                                        (3, 1, 1, 2), (2, 9, 7, 40)])
@pytest.mark.parametrize("cin", [3, 13, 64])
def test_fxp_conv_plan_grid_covers_every_output(n, h, w, cout, cin):
    plan = conv_plan(n, h, w, cin, cout, 3, esize=I16)
    assert cdiv(h, plan.th) * plan.th >= h
    assert cdiv(w, CONV_TILE_W) * CONV_TILE_W >= w
    assert cdiv(cout, plan.tco) * plan.tco >= cout
    assert plan.tco <= max(32, cout)       # no block of idle channels


@pytest.mark.parametrize("h,cin,cout", TABLE3_CONVS)
def test_fxp_conv_plan_on_table3_keeps_the_f32_tile(h, cin, cout):
    """The int16 plan is the f32 rule's tile (about two blocks an SM) with
    a chunk at least as deep: int16 stages take half the bytes, so each
    layer stages all its Cin channels in one chunk."""
    f32, i16 = (conv_plan(32, h, h, cin, cout, 3, esize=e)
                for e in (4, I16))
    assert (i16.th, i16.px, i16.tco) == (f32.th, f32.px, f32.tco)
    assert i16.cin_t == min(cin, 32) >= f32.cin_t
    assert i16.blocks(32, h, h, cout) >= 2 * H100_SMS - 8
    assert i16.smem_bytes(3, esize=I16) <= f32.smem_bytes(3)


def test_smem_bytes_mirrors_the_kernel_layout():
    """Halo rows padded to 16 bytes plus 16, each stage rounded to 16
    bytes: the layout of ``csrc/conv_fwd.cuh`` ``launch_tiled``."""
    p = ConvPlan(16, 8, 32, 3)     # rows of 3 int16 padded to 8, plus 8
    assert p.smem_bytes(3, esize=I16) == 2 * I16 * (18 * 10 * 16 + 9 * 3 * 32)
    # an odd weight slice (K*K*cin_t*tco = 4 elements) rounds its stage up
    q = ConvPlan(1, 4, 4, 1)
    assert q.smem_bytes(1, esize=I16) == 2 * I16 * align_up(1 * 8 * 16 + 4, 8)
    assert q.smem_bytes(1) == 2 * 4 * (1 * 8 * 8 + 4)


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

    for mod in (vmm_mod, conv_mod):
        monkeypatch.setattr(mod, "on_card", lambda name, *ts: True)
        monkeypatch.setattr(mod, "check_kernel_operands",
                            lambda name, *ts: None)
    monkeypatch.setattr(_build, "ptr", ptr)
    monkeypatch.setattr(_build, "launch", launch)
    return out


def _i16(*shape):
    return torch.zeros(shape, dtype=torch.int16)


@pytest.mark.parametrize("n,h,w,cin,cout,k", [
    (2, 9, 7, 8, 12, 3), (1, 13, 7, 3, 32, 1), (2, 5, 9, 13, 40, 5),
    (32, 16, 16, 64, 64, 3), (1, 9, 9, 600, 16, 7)])
def test_fxp_conv_plan_reaches_the_entry_in_argtype_order(
        launches, n, h, w, cin, cout, k):
    conv2d_fxp(_i16(n, h, w, cin), _i16(k, k, cin, cout), _i16(cout))
    (entry, args, _), = launches
    assert entry == "repro_conv2d_fxp_fwd"
    # every argument but the trailing stream, in the order of the argtypes
    assert len(args) + 1 == len(_build.SIGNATURES[entry])
    assert args[4:10] == (n, h, w, cin, cout, k)
    assert args[10:] == conv_plan(n, h, w, cin, cout, k, esize=I16).args()
    assert args[2] is not None             # the bias reaches the epilogue


def test_fxp_conv_k9_and_the_general_plan_get_zeros(launches):
    x = _i16(2, 9, 7, 8)
    conv2d_fxp(x, _i16(9, 9, 8, 12))                         # K = 9
    conv2d_fxp_planned(x, _i16(9, 9, 8, 12), plan=CONV_GENERAL)
    conv2d_fxp_planned(x, _i16(3, 3, 8, 12), plan=CONV_GENERAL)
    forced = ConvPlan(2, 4, 16, 8)
    conv2d_fxp_planned(x, _i16(3, 3, 8, 12), plan=forced)
    assert [a[10:] for _, a, _ in launches] == [(0,) * 4] * 3 + [
        forced.args()]
    assert [a[9] for _, a, _ in launches] == [9, 9, 3, 3]


def test_fxp_conv_planned_raises_on_a_plan_at_k9(launches):
    with pytest.raises(ValueError, match="K in"):
        conv2d_fxp_planned(_i16(1, 8, 8, 8), _i16(9, 9, 8, 8),
                           plan=ConvPlan(8, 8, 32, 8))
    assert not launches


@pytest.mark.parametrize("plan,k", [
    (ConvPlan(8, 5, 32, 8), 3),        # px not 4 or 8
    (ConvPlan(8, 4, 30, 8), 3),        # tco not a multiple of 4
    (ConvPlan(32, 4, 64, 8), 3),       # 1024 threads
    (ConvPlan(8, 4, 32, 0), 3),        # empty chunk
    (ConvPlan(8, 8, 64, 32), 7)])      # > 227 KB of shared memory
def test_fxp_conv_bad_plan_raises(launches, plan, k):
    with pytest.raises(ValueError, match="plan"):
        conv2d_fxp_planned(_i16(1, 8, 8, 64), _i16(k, k, 64, 8), plan=plan)
    assert not launches


def test_fxp_conv_every_plan_runs_the_plain_version_on_the_cpu():
    """On CPU tensors a plan only has to be valid: every plan gives the
    plain version's bits."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(-3000, 3000, (2, 6, 5, 8), generator=gen,
                      dtype=torch.int16)
    w = torch.randint(-9000, 9000, (3, 3, 8, 5), generator=gen,
                      dtype=torch.int16)
    want = conv_ref.conv2d_fxp(x, w)
    for plan in (None, CONV_GENERAL, ConvPlan(1, 8, 4, 1),
                 ConvPlan(4, 4, 8, 8)):
        assert torch.equal(conv2d_fxp_planned(x, w, plan=plan), want)


VMM_SHAPES = [(32, 4096, 128), (32, 128, 10), (32, 1000, 10), (5, 37, 13),
              (33, 1000, 70)]


@pytest.mark.parametrize("m,k,n,splits", [
    (32, 4096, 128, None), (32, 128, 10, None), (33, 1000, 70, None),
    (5, 37, 13, None), (32, 4096, 128, 1), (32, 4096, 128, 64),
    (33, 1000, 70, vmm_max_splits(1000)), (3, 31, 5, vmm_max_splits(31)),
    (130, 520, 300, 9)])
def test_fxp_vmm_workspace_matches_the_split(launches, m, k, n, splits):
    vmm_fxp_with_splits(_i16(m, k), _i16(k, n), _i16(n), splits=splits)
    (entry, args, tensors), = launches
    assert entry == "repro_vmm_fxp_fwd"
    assert len(args) + 1 == len(_build.SIGNATURES[entry])
    assert args[4:7] == (m, k, n)
    s, ks = args[-2:]
    assert ks == vmm_slice(k, vmm_splits(m, k, n) if splits is None
                           else splits)
    assert ks % SPLIT_CHUNK_K == 0 and (s - 1) * ks < k <= s * ks
    part = next((t for t in tensors if t is not None and t.dim() == 3),
                None)
    if s == 1:
        assert part is None and args[-3] is None
    else:
        assert part.shape == (s, m, n) and part.dtype == torch.int32
        assert args[-3] == part.data_ptr()


def test_fxp_vmm_fc0_splits_as_the_f32_forward(launches):
    """FC0 at batch 32: 64 slices x 4 column tiles = 256 blocks."""
    vmm_fxp(_i16(32, 4096), _i16(4096, 128), _i16(128))
    (_, args, _), = launches
    assert args[-2:] == (64, 64) == (vmm_splits(32, 4096, 128),
                                     vmm_slice(4096, 64))


@pytest.mark.parametrize("splits", [0, -1, vmm_max_splits(1000) + 1])
def test_fxp_vmm_bad_split_raises(launches, splits):
    with pytest.raises(ValueError, match="splits"):
        vmm_fxp_with_splits(_i16(33, 1000), _i16(1000, 70), splits=splits)
    assert not launches


@pytest.mark.parametrize("m,k,n", VMM_SHAPES)
def test_fxp_vmm_every_split_runs_the_plain_version_on_the_cpu(m, k, n):
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(-4000, 4000, (m, k), generator=gen, dtype=torch.int16)
    w = torch.randint(-4000, 4000, (k, n), generator=gen, dtype=torch.int16)
    want = vmm_ref.vmm_fxp(x, w)
    for s in sorted({1, vmm_max_splits(k)}):
        assert torch.equal(vmm_fxp_with_splits(x, w, splits=s), want)


@pytest.mark.parametrize("s,m,k,n", [(3, 32, 128, 4096), (1, 4, 13, 21)])
def test_b10_entry_arguments_are_unchanged(launches, s, m, k, n):
    """The int16 fused FC backward keeps its entry and operands (no split,
    no workspace) and, since its tiled template, ends with the four ints of
    ``vmm_bwd_plan``, the f32 backward's plan."""
    mask = masks.pack_mask(torch.ones(m, k, dtype=torch.bool))
    omask = masks.pack_mask(torch.ones(m, n, dtype=torch.bool))
    vmm_bwd_fused_fxp(_i16(s, m, k), _i16(k, n), relu_mask=mask,
                      method="guided", out_relu_mask=omask)
    (entry, args, tensors), = launches
    assert entry == "repro_vmm_bwd_fused_fxp"
    assert len(args) + 1 == len(_build.SIGNATURES[entry]) == 17
    assert args[5:12] == (s, m, k, n, 1, 1, 2)
    assert args[12:] == vmm_bwd_plan(s, m, k, n).args()
    assert len(tensors) == 2
    assert tensors[0] is mask and tensors[1] is omask
