"""The launch choices of the redesigned f32 kernels, on the CPU: the K
split of the FC forward (B4, ``vmm_splits``) and the tile of the conv
forward (B1, ``conv_plan``).  Both are pure functions of the shape, so
what they hand the card can be pinned here, down to the arguments the
wrappers pass to the entry points (with the launch itself stubbed); the
kernels are held against their plain versions by ``test_torch_cuda.py``
and ``chip_smoke.py`` on a card.
"""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import conv2d as conv_mod
from repro_torch.kernels.conv2d.conv2d import (CONV_KS, CONV_MAX_THREADS,
                                               CONV_TILE_W, ConvPlan,
                                               conv2d_planned, conv_plan)
from repro_torch.kernels.tiling import H100_SMS, cdiv
from repro_torch.kernels.vmm import vmm as vmm_mod
from repro_torch.kernels.vmm.vmm import (SPLIT_CHUNK_K, SPLIT_TILE_M,
                                         SPLIT_TILE_N, vmm_max_splits,
                                         vmm_slice, vmm_splits,
                                         vmm_with_splits)

#: The four conv layers of Table III at batch 32: (H, Cin, Cout).
TABLE3_CONVS = ((32, 3, 32), (32, 32, 32), (16, 32, 64), (16, 64, 64))
#: Shared memory of an H100 SM, the most one block may use, and what the
#: card reserves per resident block.
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 228 * 1024, 227 * 1024, 1024

VMM_SHAPES = [(32, 4096, 128), (32, 128, 10), (32, 128, 4096),
              (32, 10, 128), (1, 4096, 128), (96, 4096, 128),
              (130, 4096, 128), (32, 1000, 10), (32, 20, 128), (5, 37, 13),
              (32, 4096, 4096), (7, 100000, 3)]


def _vmm_blocks(m, k, n):
    return (vmm_splits(m, k, n) * cdiv(m, SPLIT_TILE_M)
            * cdiv(n, SPLIT_TILE_N))


def test_vmm_fc0_splits_fill_the_card():
    assert _vmm_blocks(32, 4096, 128) >= H100_SMS


@pytest.mark.parametrize("m,k,n", [(32, 128, 10), (32, 128, 4096),
                                   (32, 10, 128), (32, 20, 128)])
def test_vmm_short_k_runs_one_slice(m, k, n):
    assert vmm_splits(m, k, n) == 1
    assert vmm_slice(k, 1) >= k


@pytest.mark.parametrize("m,k,n", VMM_SHAPES)
def test_vmm_splits_cover_k_with_no_empty_slice(m, k, n):
    s = vmm_splits(m, k, n)
    assert 1 <= s <= min(k, vmm_max_splits(k))
    ks = vmm_slice(k, s)
    assert ks % SPLIT_CHUNK_K == 0
    assert (s - 1) * ks < k <= s * ks      # the last slice holds some K


@pytest.mark.parametrize("m,k,n", VMM_SHAPES)
def test_vmm_splits_only_where_the_tiles_leave_sms_idle(m, k, n):
    tiles = cdiv(m, SPLIT_TILE_M) * cdiv(n, SPLIT_TILE_N)
    if tiles >= H100_SMS:
        assert vmm_splits(m, k, n) == 1
    else:                                    # never more than ~2 per SM
        assert _vmm_blocks(m, k, n) <= 2 * H100_SMS + tiles


@pytest.mark.parametrize("h,cin,cout", TABLE3_CONVS)
def test_conv_plan_puts_two_blocks_per_sm_on_table3(h, cin, cout):
    plan = conv_plan(32, h, h, cin, cout, 3)
    blocks = plan.blocks(32, h, h, cout)
    resident = min(SMEM_PER_SM // (plan.smem_bytes(3) + SMEM_RESERVED),
                   2048 // plan.threads, 32)
    # 256 blocks on 132 SMs: two on all but 8 of them, all resident at once
    assert blocks >= 2 * H100_SMS or (
        resident >= 2 and blocks >= 1.9 * H100_SMS)


def _valid(plan: ConvPlan, cin: int, k: int):
    assert plan.px in (4, 8) and plan.tco % 4 == 0 and plan.th >= 1
    assert 1 <= plan.threads <= CONV_MAX_THREADS
    assert 1 <= plan.cin_t <= max(cin, 1)
    if cin % 4 == 0:                          # 16-byte copies stay whole
        assert plan.cin_t % 4 == 0
    assert plan.smem_bytes(k) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("cin", [1, 3, 13, 32, 64, 96, 100, 600])
@pytest.mark.parametrize("k", CONV_KS)
def test_conv_plan_stays_within_shared_memory(cin, k):
    for n, h, w, cout in ((32, 32, 32, 32), (1, 1, 1, 3), (2, 13, 7, 96),
                          (32, 16, 16, 600)):
        _valid(conv_plan(n, h, w, cin, cout, k), cin, k)


@pytest.mark.parametrize("n,h,w,cout", [(32, 32, 32, 3), (1, 13, 7, 96),
                                        (3, 1, 1, 2), (2, 9, 7, 40)])
def test_conv_plan_grid_covers_the_output(n, h, w, cout):
    plan = conv_plan(n, h, w, 8, cout, 3)
    assert cdiv(h, plan.th) * plan.th >= h
    assert cdiv(w, CONV_TILE_W) * CONV_TILE_W >= w
    assert cdiv(cout, plan.tco) * plan.tco >= cout
    assert plan.tco <= max(32, cout)       # no block of idle channels


def test_conv_plan_rejects_kernel_sizes_it_was_not_built_for():
    with pytest.raises(ValueError, match="K in"):
        conv_plan(1, 8, 8, 4, 4, 9)


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


@pytest.mark.parametrize("m,k,n,splits", [
    (32, 4096, 128, None), (32, 128, 10, None), (32, 1000, 10, None),
    (5, 37, 13, None), (32, 4096, 128, 1), (32, 4096, 128, 100),
    (3, 31, 5, vmm_max_splits(31)), (130, 520, 300, vmm_max_splits(520))])
def test_vmm_workspace_matches_the_split(launches, m, k, n, splits):
    x, w = torch.zeros(m, k), torch.zeros(k, n)
    vmm_with_splits(x, w, torch.zeros(n), splits=splits)
    (entry, args, tensors), = launches
    assert entry == "repro_vmm_fwd"
    s, ks = args[-2:]
    assert args[4:7] == (m, k, n)
    assert ks == vmm_slice(k, vmm_splits(m, k, n) if splits is None
                           else splits)
    assert ks % SPLIT_CHUNK_K == 0 and (s - 1) * ks < k <= s * ks
    part = next((t for t in tensors if t is not None and t.dim() == 3),
                None)
    if s == 1:
        assert part is None and args[-3] is None
    else:
        assert part.shape == (s, m, n) and part.dtype == torch.float32


def test_conv_plan_reaches_the_entry_and_other_k_runs_untiled(launches):
    x = torch.zeros(2, 9, 7, 8)
    conv2d_planned(x, torch.zeros(3, 3, 8, 12))
    conv2d_planned(x, torch.zeros(9, 9, 8, 12))
    (e3, a3, _), (e9, a9, _) = launches
    assert e3 == e9 == "repro_conv2d_fwd"
    assert a3[4:10] == (2, 9, 7, 8, 12, 3)
    assert a3[10:] == conv_plan(2, 9, 7, 8, 12, 3).args()
    assert a9[9:] == (9, 0, 0, 0, 0)       # the general-K kernel
    with pytest.raises(ValueError, match="K in"):
        conv2d_planned(x, torch.zeros(9, 9, 8, 12),
                       plan=ConvPlan(8, 8, 32, 8))
