"""The CUDA kernels of repro_torch against their plain versions, on a card.

``chip_smoke.py`` checks the kernels at the Table III shapes; these cases
cover what the main path does not reach: ragged channel counts and spatial
sizes, K = 1 and 5, several Cin chunks and Cout tiles, a fused backward
whose prologue needs more than 48 KB of shared memory, misaligned
pointers, the conv forward's tile plans (all bitwise equal) and its
general kernel for K > 7, the FC forward's K splits (1 to the most, M and
N past one tile), each bitwise equal run to run, and one launch per wrapper call — for the f32 kernels
and for the int16 ones of the fxp16 path, which must equal their plain
versions bit for bit (also where the int32 accumulator wraps) — for the
gate and unpool kernels of the autograd paths (bitwise), with those paths
end to end against the CPU, and for the selective scan (B13: ragged S, D
off the block size, N < 16, f32 and bf16 x, the knobs bitwise) with
falcon-mamba's SMOKE LM against the CPU.
Every test needs a CUDA device and skips without one.  This file imports neither JAX nor the JAX package, so on a
machine without JAX run it without the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import fixedpoint, masks
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.conv2d import ref as conv_ref
from repro_torch.kernels.conv2d.conv2d import (ConvPlan, conv2d,
                                               conv2d_bwd_fused,
                                               conv2d_bwd_fused_plain,
                                               conv2d_planned, conv_plan)
from repro_torch.kernels.conv2d.fxp import (conv2d_bwd_fused_fxp,
                                            conv2d_bwd_fused_fxp_plain,
                                            conv2d_fxp)
from repro_torch.kernels.pool import ref as pool_ref
from repro_torch.kernels.pool.fxp import maxpool_fwd_fxp, unpool_bwd_fxp
from repro_torch.kernels.pool.pool import maxpool_fwd, unpool_bwd
from repro_torch.kernels.relu_mask import ref as relu_ref
from repro_torch.kernels.relu_mask.relu_mask import relu_bwd, relu_fwd
from repro_torch.kernels.vmm import ref as vmm_ref
from repro_torch.kernels.vmm.fxp import (vmm_bwd_fused_fxp,
                                         vmm_bwd_fused_fxp_plain, vmm_fxp)
from repro_torch.kernels.vmm.vmm import (vmm, vmm_bwd_fused,
                                         vmm_bwd_fused_plain, vmm_max_splits,
                                         vmm_splits, vmm_with_splits)

METHODS = ("saliency", "deconvnet", "guided")
TOL = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item()


def _launched(counter, fn):
    before = LAUNCHES[counter]
    out = fn()
    assert LAUNCHES[counter] == before + 1
    return out


@pytest.mark.parametrize("r,c", [(5, 3), (16, 13), (3, 128), (7, 1000)])
def test_relu_fwd_bitwise(gen, r, c):
    x = _randn(gen, r, c)
    x[0, : c // 2] = 0.0
    y, m = _launched("relu_fwd", lambda: relu_fwd(x))
    yr, mr = relu_ref.relu_fwd(x)
    assert torch.equal(y, yr) and torch.equal(m, mr)


def test_relu_fwd_misaligned_pointer(gen):
    flat = _randn(gen, 8 * 16 + 1)
    x = flat[1:].view(8, 16)          # 4-byte offset: no 16-byte loads
    y, m = relu_fwd(x)
    yr, mr = relu_ref.relu_fwd(x)
    assert torch.equal(y, yr) and torch.equal(m, mr)


@pytest.mark.parametrize("n,h,w,c", [(2, 4, 4, 3), (1, 8, 6, 13),
                                     (1, 2, 2, 5), (3, 6, 10, 64)])
def test_maxpool_fwd_bitwise(gen, n, h, w, c):
    x = torch.clamp_min(_randn(gen, n, h, w, c), 0)
    x[:, :2, :2] = 0.0                # tied all-zero windows
    y, i = _launched("maxpool_fwd", lambda: maxpool_fwd(x))
    yr, ir = pool_ref.maxpool_fwd(x)
    assert torch.equal(y, yr) and torch.equal(i, ir)


@pytest.mark.parametrize("n,h,w,cin,cout,k", [
    (2, 6, 10, 5, 3, 3),              # ragged spatial and channels
    (1, 8, 8, 16, 8, 5),              # K = 5
    (2, 9, 7, 100, 40, 3),            # several Cin chunks, two Cout tiles
    (1, 1, 1, 3, 2, 3),               # all padding
    (2, 13, 7, 96, 3, 3),             # ragged tile, Cout = 3 (layer 0's dx)
    (1, 13, 7, 3, 96, 1),             # Cin = 3, K = 1
    (2, 5, 9, 96, 96, 5),             # K = 5, three Cin stages
    (3, 1, 1, 96, 96, 3),             # 1 x 1: only the centre tap
    (1, 13, 7, 3, 3, 5),              # both channel counts 3, K = 5
    (2, 16, 16, 64, 64, 3),           # a Table III layer, batch 2
    (2, 9, 7, 8, 12, 9),              # K = 9: the general-K kernel
    (1, 13, 7, 3, 3, 11),             # K = 11, both channel counts 3
])
def test_conv2d(gen, n, h, w, cin, cout, k):
    x = _randn(gen, n, h, w, cin)
    wt = _randn(gen, k, k, cin, cout, scale=0.2)
    b = _randn(gen, cout)
    _close(_launched("conv2d_fwd", lambda: conv2d(x, wt, b)),
           conv_ref.conv2d(x, wt) + b)
    _close(conv2d(x, wt), conv_ref.conv2d(x, wt))


def test_conv2d_misaligned_pointer(gen):
    flat = _randn(gen, 2 * 6 * 5 * 8 + 1)
    x = flat[1:].view(2, 6, 5, 8)     # 4-byte offset: 4-byte copies only
    wt = _randn(gen, 3, 3, 8, 12, scale=0.2)
    b = _randn(gen, 12)
    _close(conv2d(x, wt, b), conv_ref.conv2d(x, wt) + b)


@pytest.mark.parametrize("n,h,w,cin,cout", [(4, 32, 32, 3, 32),
                                            (4, 16, 16, 64, 64),
                                            (2, 13, 7, 96, 3)])
def test_conv2d_bitwise_run_to_run_and_across_plans(gen, n, h, w, cin, cout):
    x = _randn(gen, n, h, w, cin)
    wt = _randn(gen, 3, 3, cin, cout, scale=0.2)
    b = _randn(gen, cout)
    first = conv2d(x, wt, b)
    plans = [ConvPlan(1, 8, 4, 1), ConvPlan(16, 4, 16, 8),
             ConvPlan(2, 8, 64, 32), conv_plan(n, h, w, cin, cout, 3)]
    for got in [conv2d(x, wt, b)] + [
            _launched("conv2d_fwd", lambda p=p: conv2d_planned(x, wt, b,
                                                               plan=p))
            for p in plans]:
        torch.cuda.synchronize()
        assert torch.equal(got, first)
    _close(first, conv_ref.conv2d(x, wt) + b)


# (n, h, w, c, cout', pooled, seeds, epilogue)
BWD_CASES = [
    (2, 8, 8, 13, 9, True, 3, False),
    (1, 6, 10, 32, 3, True, 1, True),       # Hg = 3, Cout' < 8
    (2, 7, 5, 20, 40, False, 2, True),      # odd spatial, two Cout tiles
    (1, 8, 8, 600, 16, True, 2, False),     # prologue state > 48 KB
]


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused(gen, case, method):
    n, h, w, c, cout, pooled, s, epilogue = case
    y = _randn(gen, n, h, w, c)
    mask = None if method == "deconvnet" else masks.pack_mask(y > 0)
    idx = pool_ref.maxpool_fwd(torch.clamp_min(y, 0))[1] if pooled else None
    hg, wg = (h // 2, w // 2) if pooled else (h, w)
    g = _randn(gen, s, n, hg, wg, c)
    wt = _randn(gen, 3, 3, c, cout, scale=0.1)
    omask = None
    if epilogue and method != "deconvnet":
        omask = masks.pack_mask(_randn(gen, n, h, w, cout) > 0)
    kw = dict(pool_idx=idx, relu_mask=mask, gate=True, method=method,
              out_relu_mask=omask, out_gate=epilogue)
    got = _launched("conv2d_bwd_fused", lambda: conv2d_bwd_fused(g, wt, **kw))
    _close(got, conv2d_bwd_fused_plain(g, wt, **kw))


@pytest.mark.parametrize("m,k,n", [(5, 37, 13), (1, 4096, 128),
                                   (33, 128, 10),
                                   (32, 1000, 128),  # K off the slice
                                   (32, 20, 128),    # K below one chunk
                                   (96, 4096, 128),  # three M tiles
                                   (130, 4096, 128),  # ragged M tile
                                   (32, 4096, 10),   # N = 10, split
                                   (32, 4096, 4096)])  # N = 4096
def test_vmm(gen, m, k, n):
    x = _randn(gen, m, k)
    w = _randn(gen, k, n, scale=k ** -0.5)
    b = _randn(gen, n)
    _close(_launched("vmm_fwd", lambda: vmm(x, w, b)), vmm_ref.vmm(x, w) + b)


@pytest.mark.parametrize("m,k,n", [(32, 4096, 128), (32, 1000, 10),
                                   (130, 520, 300), (3, 31, 5)])
def test_vmm_forced_splits(gen, m, k, n):
    x = _randn(gen, m, k)
    w = _randn(gen, k, n, scale=k ** -0.5)
    b = _randn(gen, n)
    want = vmm_ref.vmm(x, w) + b
    # one slice, the most, and a count that leaves slices of K unfilled
    # (the wrapper then runs as many as K fills)
    for splits in (1, vmm_max_splits(k), vmm_max_splits(k) // 2 + 1):
        _close(_launched("vmm_fwd", lambda: vmm_with_splits(x, w, b,
                                                      splits=splits)), want)
    with pytest.raises(ValueError, match="splits"):
        vmm_with_splits(x, w, b, splits=vmm_max_splits(k) + 1)


def test_vmm_bitwise_run_to_run(gen):
    for m, k, n in ((32, 4096, 128), (32, 128, 10)):
        x = _randn(gen, m, k)
        w = _randn(gen, k, n, scale=k ** -0.5)
        b = _randn(gen, n)
        first = vmm(x, w, b)
        again = vmm(x, w, b)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
    assert vmm_splits(32, 4096, 128) > 1 and vmm_splits(32, 128, 10) == 1


def test_vmm_misaligned_pointers(gen):
    fx, fw = _randn(gen, 32 * 512 + 1), _randn(gen, 512 * 128 + 1)
    x = fx[1:].view(32, 512)          # 4-byte offsets: scalar loads
    w = fw[1:].view(512, 128)
    _close(vmm(x, w), vmm_ref.vmm(x, w))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("s,m,k,n,epilogue", [(1, 4, 13, 21, True),
                                              (3, 33, 128, 300, False)])
def test_vmm_bwd_fused(gen, method, s, m, k, n, epilogue):
    g = _randn(gen, s, m, k)
    w = _randn(gen, k, n, scale=k ** -0.5)
    mask = (None if method == "deconvnet"
            else masks.pack_mask(_randn(gen, m, k) > 0))
    omask = (masks.pack_mask(_randn(gen, m, n) > 0)
             if epilogue and method != "deconvnet" else None)
    kw = dict(relu_mask=mask, gate=True, method=method, out_relu_mask=omask,
              out_gate=epilogue)
    got = _launched("vmm_bwd_fused", lambda: vmm_bwd_fused(g, w, **kw))
    _close(got, vmm_bwd_fused_plain(g, w, **kw))


def test_engine_on_card_matches_cpu_twin(gen):
    from repro_torch.engine import CNNModel, EngineSpec, TopK, build
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(in_hw=(8, 8), channels=(4, 4), fc=(16,),
                        num_classes=4)
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((3, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    for method in METHODS:
        spec = dict(method=method, targets=TopK(2))
        card = build(EngineSpec(CNNModel(params, cfg), **spec))
        cpu = build(EngineSpec(CNNModel(params, cfg, device="cpu"), **spec))
        logits, rel, res = card.predict_then_explain(x)
        logits_c, rel_c, res_c = cpu.predict_then_explain(x)
        _close(logits.cpu(), logits_c)
        seeds, _ = cpu._seeds(logits_c, None, 2)
        again = card.replay(cnn.residuals_to(res_c, "cuda"), seeds)
        torch.cuda.synchronize()
        err = (again.cpu() - rel_c).abs().max().item()
        assert err <= 1e-4 * rel_c.abs().max().item()


# -- the int16 kernels of the fxp16 path: bitwise against the plain versions


def _q(gen, *shape, scale=1.0, frac=fixedpoint.ACT_FRAC):
    return fixedpoint.to_fixed(_randn(gen, *shape, scale=scale), frac)


def _qw(gen, *shape, scale=0.2):
    return _q(gen, *shape, scale=scale, frac=fixedpoint.WGT_FRAC)


def _rails(gen, *shape):
    sign = torch.randint(0, 2, shape, generator=gen, device="cuda") * 2 - 1
    return (sign * fixedpoint.INT16_LIM).to(torch.int16)


def _same(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int16
    assert torch.equal(got, want)


@pytest.mark.parametrize("r,c", [(5, 3), (16, 13), (3, 128), (7, 1000)])
def test_relu_fwd_int16_bitwise(gen, r, c):
    x = _q(gen, r, c, scale=0.02)
    x[0, : c // 2] = 0
    y, m = _launched("relu_fwd", lambda: relu_fwd(x))
    yr, mr = relu_ref.relu_fwd(x)
    _same(y, yr)
    assert torch.equal(m, mr)


def test_relu_fwd_int16_misaligned_pointer(gen):
    flat = _q(gen, 8 * 16 + 1)
    x = flat[1:].view(8, 16)          # 2-byte offset: no 16-byte loads
    y, m = relu_fwd(x)
    yr, mr = relu_ref.relu_fwd(x)
    _same(y, yr)
    assert torch.equal(m, mr)


@pytest.mark.parametrize("n,h,w,c", [(2, 4, 4, 3), (1, 8, 6, 13),
                                     (3, 6, 10, 64)])
def test_maxpool_fwd_int16_bitwise(gen, n, h, w, c):
    x = torch.clamp_min(_q(gen, n, h, w, c, scale=0.01), 0)  # many ties
    x[:, :2, :2] = 0
    y, i = _launched("maxpool_fwd", lambda: maxpool_fwd_fxp(x))
    yr, ir = pool_ref.maxpool_fwd(x)
    _same(y, yr)
    assert torch.equal(i, ir)


@pytest.mark.parametrize("n,h,w,cin,cout,k", [
    (2, 6, 10, 5, 3, 3),              # ragged spatial and channels
    (1, 8, 8, 16, 8, 5),              # K = 5
    (2, 9, 7, 100, 40, 3),            # several Cin chunks, two Cout tiles
    (1, 1, 1, 3, 2, 3),               # all padding
])
def test_conv2d_fxp_bitwise(gen, n, h, w, cin, cout, k):
    x = _q(gen, n, h, w, cin)
    wt = _qw(gen, k, k, cin, cout)
    b = _q(gen, cout, scale=4.0)
    got = _launched("conv2d_fxp_fwd", lambda: conv2d_fxp(x, wt, b))
    _same(got, fixedpoint.sat_add(conv_ref.conv2d_fxp(x, wt), b))
    _same(conv2d_fxp(x, wt), conv_ref.conv2d_fxp(x, wt))


def test_conv2d_fxp_accumulator_wraps(gen):
    x, wt = _rails(gen, 2, 5, 6, 200), _rails(gen, 3, 3, 200, 40)
    x[0] = fixedpoint.INT16_LIM
    wt[..., 0] = fixedpoint.INT16_LIM  # channel 0 of image 0: 1800 * 2^30
    _same(conv2d_fxp(x, wt), conv_ref.conv2d_fxp(x, wt))


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused_fxp_bitwise(gen, case, method):
    n, h, w, c, cout, pooled, s, epilogue = case
    y = _q(gen, n, h, w, c)
    mask = None if method == "deconvnet" else masks.pack_mask(y > 0)
    idx = (pool_ref.maxpool_fwd(torch.clamp_min(y, 0))[1] if pooled
           else None)
    hg, wg = (h // 2, w // 2) if pooled else (h, w)
    g = _q(gen, s, n, hg, wg, c, scale=2.0)
    wt = _qw(gen, 3, 3, c, cout, scale=0.1)
    omask = None
    if epilogue and method != "deconvnet":
        omask = masks.pack_mask(_randn(gen, n, h, w, cout) > 0)
    kw = dict(pool_idx=idx, relu_mask=mask, gate=True, method=method,
              out_relu_mask=omask, out_gate=epilogue)
    got = _launched("conv2d_bwd_fused_fxp",
                    lambda: conv2d_bwd_fused_fxp(g, wt, **kw))
    _same(got, conv2d_bwd_fused_fxp_plain(g, wt, **kw))


@pytest.mark.parametrize("m,k,n", [(5, 37, 13), (1, 4096, 128),
                                   (33, 128, 10)])
def test_vmm_fxp_bitwise(gen, m, k, n):
    x = _q(gen, m, k)
    w = _qw(gen, k, n, scale=k ** -0.5)
    b = _q(gen, n, scale=4.0)
    got = _launched("vmm_fxp_fwd", lambda: vmm_fxp(x, w, b))
    _same(got, fixedpoint.sat_add(vmm_ref.vmm_fxp(x, w), b))
    _same(vmm_fxp(x, w), vmm_ref.vmm_fxp(x, w))


def test_vmm_fxp_accumulator_wraps(gen):
    x, w = _rails(gen, 3, 4096), _rails(gen, 4096, 20)
    x[0] = fixedpoint.INT16_LIM
    w[:, 0] = fixedpoint.INT16_LIM     # row 0, col 0: 4096 * 2^30
    _same(vmm_fxp(x, w), vmm_ref.vmm_fxp(x, w))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("s,m,k,n,epilogue", [(1, 4, 13, 21, True),
                                              (3, 33, 128, 300, False)])
def test_vmm_bwd_fused_fxp_bitwise(gen, method, s, m, k, n, epilogue):
    g = _q(gen, s, m, k, scale=3.0)
    w = _qw(gen, k, n, scale=k ** -0.5)
    mask = (None if method == "deconvnet"
            else masks.pack_mask(_randn(gen, m, k) > 0))
    omask = (masks.pack_mask(_randn(gen, m, n) > 0)
             if epilogue and method != "deconvnet" else None)
    kw = dict(relu_mask=mask, gate=True, method=method, out_relu_mask=omask,
              out_gate=epilogue)
    got = _launched("vmm_bwd_fused_fxp",
                    lambda: vmm_bwd_fused_fxp(g, w, **kw))
    _same(got, vmm_bwd_fused_fxp_plain(g, w, **kw))


def test_fxp16_engine_on_card_matches_cpu_twin_bitwise(gen):
    from repro_torch.engine import CNNModel, EngineSpec, TopK, build
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(in_hw=(8, 8), channels=(4, 4), fc=(16,),
                        num_classes=4)
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((3, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    for method in METHODS:
        spec = dict(method=method, precision="fxp16", targets=TopK(2))
        card = build(EngineSpec(CNNModel(params, cfg), **spec))
        cpu = build(EngineSpec(CNNModel(params, cfg, device="cpu"), **spec))
        logits, rel, res = card.predict_then_explain(x)
        logits_c, rel_c, res_c = cpu.predict_then_explain(x)
        torch.cuda.synchronize()
        assert torch.equal(logits.cpu(), logits_c)
        assert torch.equal(rel.cpu(), rel_c)
        for a, b in zip(res["fc"], res_c["fc"]):
            assert (a is None and b is None) or torch.equal(a.cpu(), b)
        again = card.replay(cnn.residuals_to(res_c, "cuda"),
                            cpu._seeds(logits_c, None, 2)[0])
        torch.cuda.synchronize()
        assert torch.equal(again.cpu(), rel_c)


# -- the gate (B11) and unpool (B12) kernels of the autograd paths, bitwise


def _grad(gen, *shape):
    g = _randn(gen, *shape)
    g.view(-1)[::7] = 0.0                  # zeros and signed zeros: g > 0 is
    g.view(-1)[3::11] = -0.0               # strict, and the sign must survive
    return g


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("r,c", [(5, 3), (17, 13), (3, 128), (7, 1000),
                                 (33, 64)])
def test_relu_bwd_bitwise(gen, method, r, c):
    _, m = relu_fwd(_randn(gen, r, c))
    g = _grad(gen, r, c)
    got = _launched("relu_bwd", lambda: relu_bwd(m, g, method))
    torch.cuda.synchronize()
    assert torch.equal(got, relu_ref.relu_bwd(m, g, method))
    if method == "deconvnet":              # no mask read at all
        assert torch.equal(relu_bwd(None, g, method), got)


def test_relu_bwd_misaligned_pointer(gen):
    _, m = relu_fwd(_randn(gen, 8, 16))
    flat = _grad(gen, 8 * 16 + 1)
    g = flat[1:].view(8, 16)               # 4-byte offset: no 16-byte loads
    for method in METHODS:
        want = relu_ref.relu_bwd(m, g, method)
        assert torch.equal(relu_bwd(m, g, method), want)


@pytest.mark.parametrize("n,hp,wp,c", [(2, 2, 2, 3), (1, 4, 3, 13),
                                       (3, 3, 5, 64), (1, 1, 1, 6)])
def test_unpool_bwd_bitwise(gen, n, hp, wp, c):
    x = torch.clamp_min(_randn(gen, n, 2 * hp, 2 * wp, c), 0)
    x[:, :2, :2] = 0.0                     # tied all-zero windows
    _, idx = maxpool_fwd(x)
    g = _grad(gen, n, hp, wp, c)
    got = _launched("unpool_bwd", lambda: unpool_bwd(idx, g))
    torch.cuda.synchronize()
    assert torch.equal(got, pool_ref.unpool_bwd(idx, g))


@pytest.mark.parametrize("c", [13, 64])
def test_unpool_bwd_int16_bitwise(gen, c):
    x = torch.clamp_min(_q(gen, 2, 6, 4, c, scale=0.01), 0)   # many ties
    _, idx = maxpool_fwd_fxp(x)
    g = _q(gen, 2, 3, 2, c)
    got = _launched("unpool_bwd", lambda: unpool_bwd_fxp(idx, g))
    _same(got, pool_ref.unpool_bwd(idx, g))


def test_unpool_bwd_misaligned_pointer(gen):
    _, idx = maxpool_fwd(_randn(gen, 1, 4, 4, 8))
    flat = _grad(gen, 2 * 2 * 8 + 1)
    g = flat[1:].view(1, 2, 2, 8)          # 4-byte offset: no vector stores
    assert torch.equal(unpool_bwd(idx, g), pool_ref.unpool_bwd(idx, g))
    flat16 = _q(gen, 2 * 2 * 8 + 1)
    g16 = flat16[1:].view(1, 2, 2, 8)      # 2-byte offset
    _same(unpool_bwd_fxp(idx, g16), pool_ref.unpool_bwd(idx, g16))


def test_autograd_paths_on_card_match_cpu_twin(gen):
    """The vjp engine through the fused blocks and through the standalone
    ops (B11/B12 in the backward), and the parameter gradients of the
    autodiff training loss, on the card against the CPU."""
    from repro_torch.engine import (CNNModel, EngineSpec, FnModel, TopK,
                                    build)
    from repro_torch.kernels import reset_launches
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(in_hw=(8, 8), channels=(4, 12), fc=(16,),
                        num_classes=5)
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((3, 8, 8, 3), generator=torch.Generator().manual_seed(1))

    def unfused(device):
        p = cnn.params_to(params, device)
        return FnModel(lambda m: lambda v: cnn.apply(
            p, v, cfg, method=m, use_pallas=True, fused=False), device)

    def launches(fused, method):
        """Per explain with K = 2 seeds (two backward passes), this cfg."""
        want = {k: 0 for k in LAUNCHES}
        relus = 0 if fused and method == "deconvnet" else 3
        want.update(conv2d_fwd=2, relu_fwd=relus, maxpool_fwd=1, vmm_fwd=2)
        if fused:
            want.update(conv2d_bwd_fused=4, vmm_bwd_fused=4)
        else:         # B1/B4 reused for dx, B11 at 3 ReLUs, B12 at 1 pool
            want.update(conv2d_fwd=6, vmm_fwd=6, relu_bwd=6, unpool_bwd=2)
        return want

    for method in METHODS:
        for fused, model in ((True, lambda d: CNNModel(params, cfg, device=d)),
                             (False, unfused)):
            spec = dict(method=method, backward="vjp", targets=TopK(2))
            reset_launches()
            logits, rel = build(EngineSpec(model("cuda"), **spec)).explain(x)
            torch.cuda.synchronize()
            assert dict(LAUNCHES) == launches(fused, method)
            logits_c, rel_c = build(EngineSpec(model("cpu"), **spec)).explain(x)
            _close(logits.cpu(), logits_c)
            err = (rel.cpu() - rel_c).abs().max().item()
            assert err <= 1e-4 * rel_c.abs().max().item()
    y = torch.tensor([0, 3, 4])
    grads = []
    for device in ("cuda", "cpu"):
        p = cnn.params_to(params, device)
        leaves = [t.requires_grad_() for q in p["conv"] + p["fc"]
                  for t in q.values()]
        loss = torch.nn.functional.cross_entropy(
            cnn.apply(p, x.to(device), cfg, use_pallas=True), y.to(device))
        grads.append(torch.autograd.grad(loss, leaves))
    for g, g_c in zip(*grads):    # four layers of reordered f32 sums
        err = (g.cpu() - g_c).abs().max().item()
        assert err <= 1e-4 * g_c.abs().max().item()


# -- B13: the selective scan of LM token attribution ---------------------------

SCAN_ATOL, SCAN_RTOL = 2e-4, 2e-3      # tests/test_kernels_ssm.py
SCAN_BF16_RTOL = 2.0 ** -7             # a bf16 y: one rounding step apart


def _scan_inputs(gen, b, s, d, n, dtype=torch.float32):
    dt = torch.nn.functional.softplus(_randn(gen, b, s, d) - 2)
    x = _randn(gen, b, s, d).to(dtype)
    bm, cm = _randn(gen, b, s, n), _randn(gen, b, s, n)
    a = -torch.exp(_randn(gen, d, n) * 0.3)
    return dt, x, bm, cm, a, _randn(gen, b, d, n)


def _scan_close(got, want, rtol=SCAN_RTOL):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=SCAN_ATOL,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d,n,d_tile,chunk", [
    (1, 8, 16, 4, 16, 16),             # a block of 16 channels
    (2, 13, 200, 16, 200, 5),          # ragged S; D not a multiple of 128
    (2, 33, 256, 7, 64, 64),           # N < 16, four blocks of 64
    (1, 300, 384, 16, 384, 128),       # staging chunk capped by smem
    (3, 1, 8, 1, 8, 4),                # S = 1, N = 1, D < a warp
])
def test_selective_scan(gen, b, s, d, n, d_tile, chunk, dtype):
    from repro_torch.kernels.ssm_scan import ref as scan_ref
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan
    args = _scan_inputs(gen, b, s, d, n, dtype)
    y, h = _launched("selective_scan", lambda: selective_scan(
        *args, d_tile=d_tile, chunk=chunk))
    yr, hr = scan_ref.selective_scan(*args)
    _scan_close(y, yr, SCAN_BF16_RTOL if dtype == torch.bfloat16
                else SCAN_RTOL)
    _scan_close(h, hr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_selective_scan_knobs_keep_the_bits(gen, dtype):
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan
    args = _scan_inputs(gen, 2, 77, 512, 16, dtype)
    outs = [selective_scan(*args, d_tile=dtl, chunk=ck)
            for dtl, ck in ((512, 128), (256, 64), (32, 7), (512, 1))]
    torch.cuda.synchronize()
    for y, h in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(h, outs[0][1])


def test_selective_scan_rejects_what_it_cannot_hold(gen):
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan
    args = _scan_inputs(gen, 1, 4, 32, 17)
    with pytest.raises(ValueError, match="N <= 16"):
        selective_scan(*args, d_tile=32, chunk=4)
    args = _scan_inputs(gen, 1, 4, 32, 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        selective_scan(args[0].cpu(), *args[1:], d_tile=32, chunk=4)


def test_selective_scan_strided_operands(gen):
    """B and C as views of one projection, as mamba_core passes them."""
    from repro_torch.kernels.ssm_scan import ref as scan_ref
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan
    dt, x, _, _, a, h0 = _scan_inputs(gen, 2, 9, 64, 8)
    bc = _randn(gen, 2, 9, 3 + 16)
    bm, cm = bc[..., 3:11], bc[..., 11:]
    y, h = selective_scan(dt, x, bm, cm, a, h0, d_tile=64, chunk=4)
    yr, hr = scan_ref.selective_scan(dt, x, bm, cm, a, h0)
    _scan_close(y, yr)
    _scan_close(h, hr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_explain_on_card_matches_cpu_twin(gen, dtype):
    """falcon-mamba SMOKE: greedy decode, per-token explains and the
    engine on the card against the CPU; B13 once per layer per explain and
    never in decode."""
    from repro_torch import configs, lm
    from repro_torch.engine import EngineSpec, LMModel, build
    from repro_torch.kernels import reset_launches
    from repro_torch.models import transformer as tf
    cfg = configs.get_smoke("falcon-mamba-7b").with_(dtype=dtype)
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    card = tf.params_to(params, "cuda")
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    reset_launches()
    res = lm.decode(card, cfg, toks, max_new=3)
    assert LAUNCHES["selective_scan"] == 0
    res_c = lm.decode(params, cfg, toks, max_new=3)
    if dtype == "float32":
        assert torch.equal(res.tokens.cpu(), res_c.tokens)
    sc = lm.explain_generated(card, cfg, lm.DecodeResult(
        res_c.tokens.cuda(), res_c.runners_up.cuda(), res_c.prompt_len))
    torch.cuda.synchronize()
    assert LAUNCHES["selective_scan"] == 3 * cfg.n_layers
    sc_c = lm.explain_generated(params, cfg, res_c)
    tol = 1e-4 if dtype == "float32" else 5e-2
    err = (sc.cpu() - sc_c).abs().max().item()
    assert err <= tol * sc_c.abs().max().item()
    for t in range(3):
        assert bool((sc[:, t, 12 + t:] == 0).all())
    eng = build(EngineSpec(LMModel(params, cfg), method="guided"))
    eng_c = build(EngineSpec(LMModel(params, cfg, device="cpu"),
                             method="guided"))
    for mode in ("ixg", "grad_norm", "contrastive"):
        (lg, s), (lg_c, s_c) = (e.explain_tokens({"tokens": toks}, mode=mode)
                                for e in (eng, eng_c))
        assert (lg.cpu() - lg_c).abs().max().item() <= (
            1e-5 if dtype == "float32" else 1e-2) * lg_c.abs().max().item()
        assert (s.cpu() - s_c).abs().max().item() <= tol * \
            s_c.abs().max().item()
