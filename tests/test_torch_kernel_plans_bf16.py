"""The launch choices of the bf16 forwards on the tensor cores, on the CPU:
the route and tile of the conv forward (B1 bf16, ``conv_bf16_plan`` /
``conv_mma_plan``) and the cluster plan of the FC forward (B4 bf16,
``vmm_mma_plan``).  Both are pure functions of the shape, so what they
hand the card is pinned here, down to the arguments the wrappers pass to
the bf16 entry points (with the launch itself stubbed); the kernels are
held against their plain versions by ``test_torch_cuda.py`` and
``chip_smoke.py`` on a card.
"""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import conv2d as conv_mod
from repro_torch.kernels.conv2d import ref as conv_ref
from repro_torch.kernels.conv2d.conv2d import (CONV_KS, CONV_MAX_THREADS,
                                               CONV_MMA_TW, ConvMmaPlan,
                                               ConvPlan, conv2d,
                                               conv2d_planned,
                                               conv_bf16_plan,
                                               conv_mma_candidates,
                                               conv_mma_plan, conv_plan)
from repro_torch.kernels.tiling import H100_SMS, cdiv
from repro_torch.kernels.vmm import ref as vmm_ref
from repro_torch.kernels.vmm import vmm as vmm_mod
from repro_torch.kernels.vmm.vmm import (MMA_CHUNK_K, MMA_MAX_CLUSTER,
                                         MMA_PORTABLE_CLUSTER, VmmMmaPlan,
                                         vmm, vmm_mma_candidates,
                                         vmm_mma_plan, vmm_planned,
                                         vmm_with_splits)

BF = torch.bfloat16
#: The four conv layers of Table III at batch 32: (H, Cin, Cout).
TABLE3_CONVS = ((32, 3, 32), (32, 32, 32), (16, 32, 64), (16, 64, 64))
#: The most shared memory one H100 block may use.
SMEM_PER_BLOCK = 227 * 1024

VMM_SHAPES = [(32, 4096, 128), (32, 128, 10), (32, 128, 4096),
              (32, 10, 128), (1, 4096, 128), (96, 4096, 128),
              (130, 4096, 128), (32, 1000, 10), (32, 20, 128), (5, 37, 13),
              (32, 4096, 4096), (7, 100000, 3), (130, 520, 300)]


# -- the conv forward: route and tile --------------------------------------


@pytest.mark.parametrize("h,cin,cout", TABLE3_CONVS)
def test_table3_layers_1_to_3_take_the_tensor_cores_layer_0_ffma(h, cin,
                                                                 cout):
    plan = conv_bf16_plan(32, h, h, cin, cout, 3)
    if cin == 3:            # layer 0: the FFMA instance
        assert plan == conv_plan(32, h, h, cin, cout, 3, esize=2)
    else:
        assert plan == conv_mma_plan(32, h, h, cin, cout, 3)
        # a block of 8 warps per SM (the SMs rounded down to a power of 2)
        assert plan.blocks(32, h, h, cout) == 128 < H100_SMS
        assert plan.threads == 256


@pytest.mark.parametrize("cin", [1, 3, 5, 13, 24, 100, 600])
def test_cin_off_the_k16_step_takes_ffma(cin):
    assert isinstance(conv_bf16_plan(2, 9, 7, cin, 40, 3), ConvPlan)
    with pytest.raises(ValueError, match="multiple of 16"):
        conv_mma_plan(2, 9, 7, cin, 40, 3)


def _valid_mma(plan: ConvMmaPlan, cin: int, k: int):
    assert plan.mt in (1, 2) and plan.th % plan.mt == 0
    assert plan.tco % 32 == 0 and plan.cin_t % 16 == 0
    assert 16 <= plan.cin_t <= max(cin, 16)
    assert 32 <= plan.threads <= CONV_MAX_THREADS
    assert plan.smem_bytes(k, cin) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("cin", [16, 32, 48, 64, 96, 608])
@pytest.mark.parametrize("k", CONV_KS)
def test_conv_mma_plan_stays_within_shared_memory(cin, k):
    for n, h, w, cout in ((32, 32, 32, 32), (1, 1, 1, 3), (2, 13, 7, 96),
                          (32, 16, 16, 600), (1, 5, 9, 96)):
        _valid_mma(conv_mma_plan(n, h, w, cin, cout, k), cin, k)


def test_conv_mma_smem_one_stage_for_one_chunk():
    one = ConvMmaPlan(4, 2, 32, 64)
    assert one.smem_bytes(3, 64) * 2 == one.smem_bytes(3, 128)
    stage = (4 + 2) * (16 + 2) * (64 + 8) + 9 * 64 * (32 + 8)
    assert one.smem_bytes(3, 64) == 2 * stage


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (32, 32, 32, 16, 3), (1, 13, 7, 48, 96), (3, 1, 1, 16, 2),
    (2, 9, 7, 16, 40), (2, 5, 9, 96, 96), (32, 16, 16, 64, 64)])
def test_conv_mma_grid_covers_the_output(n, h, w, cin, cout):
    for k in CONV_KS:
        plan = conv_mma_plan(n, h, w, cin, cout, k)
        assert cdiv(h, plan.th) * plan.th >= h
        assert cdiv(w, CONV_MMA_TW) * CONV_MMA_TW >= w
        assert cdiv(cout, plan.tco) * plan.tco >= cout
        assert plan.blocks(n, h, w, cout) == (
            cdiv(h, plan.th) * cdiv(w, CONV_MMA_TW)
            * cdiv(cout, plan.tco) * n)


def test_conv_plans_refuse_kernel_sizes_they_were_not_built_for():
    for k in (9, 11):
        with pytest.raises(ValueError, match="K in"):
            conv_mma_plan(1, 8, 8, 16, 4, k)
        with pytest.raises(ValueError, match="K in"):
            conv_bf16_plan(1, 8, 8, 16, 4, k)


@pytest.mark.parametrize("h,cin,cout", TABLE3_CONVS[1:])
def test_sweep_candidates_are_valid_and_hold_the_rule(h, cin, cout):
    cands = conv_mma_candidates(h, h, cin, cout, 3)
    assert conv_mma_plan(32, h, h, cin, cout, 3) in cands
    for p in cands:
        _valid_mma(p, cin, 3)


# -- the FC forward: the cluster plan --------------------------------------


@pytest.mark.parametrize("m,k,n", VMM_SHAPES)
def test_vmm_mma_slices_cover_k_with_none_empty(m, k, n):
    plan = vmm_mma_plan(m, k, n)
    ks = plan.slice(k)
    assert ks % MMA_CHUNK_K == 0
    assert (plan.cluster - 1) * ks < k <= plan.cluster * ks
    assert 1 <= plan.cluster <= MMA_MAX_CLUSTER


def test_vmm_mma_fc0_a_cluster_of_16_a_tile_fc1_a_chunk_a_block():
    fc0 = vmm_mma_plan(32, 4096, 128)
    # 16 a cluster: past the portable 8, csrc/vmm_fwd_bf16.cu sets the
    # non-portable attribute for it
    assert fc0 == VmmMmaPlan(16, 16) and fc0.cluster > MMA_PORTABLE_CLUSTER
    assert fc0.blocks(32, 128) == 128 and fc0.slice(4096) == 256
    fc1 = vmm_mma_plan(32, 128, 10)
    assert fc1 == VmmMmaPlan(16, 2) and fc1.slice(128) == MMA_CHUNK_K


@pytest.mark.parametrize("m,k,n", VMM_SHAPES)
def test_vmm_mma_candidates_are_valid(m, k, n):
    cands = vmm_mma_candidates(m, k, n)
    if (m, k, n) in ((32, 4096, 128), (32, 128, 10)):   # FC0, FC1
        assert vmm_mma_plan(m, k, n) in cands
    for p in cands:
        assert p.bn in (16, 32) and p.cluster <= MMA_MAX_CLUSTER
        assert (p.cluster - 1) * p.slice(k) < k


def test_bad_plans_raise():
    x, w = torch.zeros(2, 8, 8, 16, dtype=BF), torch.zeros(3, 3, 16, 8,
                                                            dtype=BF)
    for bad in (ConvMmaPlan(3, 2, 32, 16), ConvMmaPlan(2, 3, 32, 16),
                ConvMmaPlan(2, 2, 48, 16), ConvMmaPlan(2, 2, 32, 8),
                ConvMmaPlan(32, 2, 64, 16)):         # 512 threads
        with pytest.raises(ValueError, match="invalid tile plan"):
            conv2d_planned(x, w, plan=bad)
    with pytest.raises(ValueError, match="invalid tile plan"):   # Cin 8
        conv2d_planned(torch.zeros(1, 4, 4, 8, dtype=BF),
                       torch.zeros(3, 3, 8, 8, dtype=BF),
                       plan=ConvMmaPlan(2, 2, 32, 16))
    with pytest.raises(ValueError, match="bf16's only"):
        conv2d_planned(x.float(), w.float(), plan=ConvMmaPlan(2, 2, 32, 16))
    xv, wv = torch.zeros(4, 128, dtype=BF), torch.zeros(128, 8, dtype=BF)
    for bad in (VmmMmaPlan(8, 1), VmmMmaPlan(16, 17), VmmMmaPlan(16, 3),
                VmmMmaPlan(32, 0)):                  # 3 x 64 leaves one empty
        with pytest.raises(ValueError, match="invalid tensor-core plan"):
            vmm_planned(xv, wv, plan=bad)
    with pytest.raises(TypeError, match="x must be torch.bfloat16"):
        vmm_planned(xv.float(), wv.float())


def test_every_plan_is_the_plain_version_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 9, 7, 32, generator=g).to(BF)
    w = (torch.randn(3, 3, 32, 40, generator=g) * 0.1).to(BF)
    b = torch.randn(40, generator=g).to(BF)
    want = conv_ref.conv2d_bf16(x, w) + b
    for p in conv_mma_candidates(9, 7, 32, 40, 3) + [None]:
        assert torch.equal(conv2d_planned(x, w, b, plan=p), want)
    xv = torch.randn(5, 300, generator=g).to(BF)
    wv = (torch.randn(300, 13, generator=g) * 0.1).to(BF)
    want = vmm_ref.vmm_bf16(xv, wv)
    for p in vmm_mma_candidates(5, 300, 13):
        assert torch.equal(vmm_planned(xv, wv, plan=p), want)
    assert torch.equal(vmm(xv, wv), want)


# -- the entry arguments, launch stubbed -------------------------------------


@pytest.fixture
def launches(monkeypatch):
    """Stub the card: the wrappers take their kernel route on CPU tensors
    and record ``(entry, args, tensors handed to _build.ptr)``, and in
    ``.routes`` the route each launch is counted under."""
    seen, routes = [], []

    class Launches(list):
        pass
    out = Launches()
    real_ptr = _build.ptr

    def ptr(t):
        seen.append(t)
        return real_ptr(t)

    def launch(counter, entry, device, *args, route=None):
        out.append((entry, args, list(seen)))
        routes.append(route)
        seen.clear()

    for mod in (vmm_mod, conv_mod):
        monkeypatch.setattr(mod, "on_card", lambda name, *ts: True)
        monkeypatch.setattr(mod, "check_kernel_operands",
                            lambda name, *ts: None)
    monkeypatch.setattr(_build, "ptr", ptr)
    monkeypatch.setattr(_build, "launch", launch)
    out.routes = routes
    return out


def test_signatures_of_the_bf16_forwards():
    conv = _build.SIGNATURES["repro_conv2d_fwd_bf16"]
    assert conv[:4] == [_build._P] * 4 and conv[4:-1] == [_build._I] * 11
    fc = _build.SIGNATURES["repro_vmm_fwd_bf16"]
    assert fc == (_build.SIGNATURES["repro_vmm_fwd"][:7] + [_build._I] * 3
                  + [_build._P])


def test_fc0_bf16_passes_no_workspace(launches):
    m, k, n = 32, 4096, 128
    vmm(torch.zeros(m, k, dtype=BF), torch.zeros(k, n, dtype=BF),
        torch.zeros(n, dtype=BF))
    (entry, args, tensors), = launches
    assert entry == "repro_vmm_fwd_bf16"
    assert len(args) + 1 == len(_build.SIGNATURES[entry])
    assert args[4:7] == (m, k, n)
    plan = vmm_mma_plan(m, k, n)
    # no workspace: the cluster's slices, their length, the column tile
    assert args[7:] == (plan.cluster, plan.slice(k), plan.bn)
    assert not any(t is not None and t.dim() == 3 for t in tensors)


@pytest.mark.parametrize("m,k,n", [(32, 128, 10), (5, 37, 13),
                                   (130, 520, 300)])
def test_vmm_planned_hands_the_plan_in_argtype_order(launches, m, k, n):
    for plan in vmm_mma_candidates(m, k, n):
        vmm_planned(torch.zeros(m, k, dtype=BF), torch.zeros(k, n, dtype=BF),
                    plan=plan)
        entry, args, _ = launches.pop()
        assert args[7:] == plan.args(k)
        assert plan.args(k) == (plan.cluster, plan.slice(k), plan.bn)


@pytest.mark.parametrize("splits", [None, 1, 2, 64])
def test_bf16_has_no_split_k_route(launches, splits):
    """The split-K forward is f32's: bf16 takes the tensor cores only."""
    with pytest.raises(TypeError, match="x must be torch.float32"):
        vmm_with_splits(torch.zeros(32, 4096, dtype=BF),
                        torch.zeros(4096, 128, dtype=BF), splits=splits)
    assert launches == []


def test_conv_bf16_entry_gets_route_then_plan(launches):
    x16 = torch.zeros(2, 9, 7, 16, dtype=BF)
    w16 = torch.zeros(3, 3, 16, 12, dtype=BF)
    conv2d(x16, w16)                                   # tensor cores
    x3 = torch.zeros(2, 9, 7, 3, dtype=BF)
    conv2d(x3, torch.zeros(3, 3, 3, 12, dtype=BF))     # FFMA
    ffma = ConvPlan(2, 4, 16, 8)
    conv2d_planned(x16, w16, plan=ffma)                # FFMA forced
    for p in conv_mma_candidates(9, 7, 16, 12, 3):
        conv2d_planned(x16, w16, plan=p)
    (e0, a0, _), (e1, a1, _), (e2, a2, _) = launches[:3]
    # each launch counted under the kernel its route selects
    assert launches.routes == (
        ["conv2d_fwd_bf16_mma", "conv2d_fwd_bf16_ffma", "conv2d_fwd_bf16_ffma"]
        + ["conv2d_fwd_bf16_mma"] * (len(launches) - 3))
    assert set(launches.routes) <= set(_build.ROUTE_LAUNCHES)
    assert e0 == e1 == e2 == "repro_conv2d_fwd_bf16"
    for _, args, _ in launches:
        assert len(args) + 1 == len(_build.SIGNATURES[e0])
    assert a0[4:10] == (2, 9, 7, 16, 12, 3)
    assert a0[10:] == (1,) + conv_mma_plan(2, 9, 7, 16, 12, 3).args()
    assert a1[10:] == (0,) + conv_plan(2, 9, 7, 3, 12, 3, esize=2).args()
    assert a2[10:] == (0,) + ffma.args()
    for (_, args, _), p in zip(launches[3:],
                               conv_mma_candidates(9, 7, 16, 12, 3)):
        assert args[10:] == (1,) + p.args()
    p = conv_mma_plan(2, 9, 7, 16, 12, 3)   # the C entry's (th, p, tco, cin_t)
    assert p.args() == (p.th, p.mt, p.tco, p.cin_t)


def test_f32_entries_keep_their_arguments(launches):
    conv2d(torch.zeros(2, 9, 7, 16), torch.zeros(3, 3, 16, 12))
    vmm(torch.zeros(32, 4096), torch.zeros(4096, 128))
    (ec, ac, _), (ev, av, _) = launches
    assert launches.routes == [None, None]
    assert ec == "repro_conv2d_fwd" and ev == "repro_vmm_fwd"
    assert ac[10:] == conv_plan(2, 9, 7, 16, 12, 3).args()
    assert len(av) + 1 == len(_build.SIGNATURES[ev])
