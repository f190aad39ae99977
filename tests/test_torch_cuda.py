"""The CUDA kernels of repro_torch against their plain versions, on a card.

``chip_smoke.py`` checks the kernels at the Table III shapes; these cases
cover what the main path does not reach: ragged channel counts and spatial
sizes, K = 1 and 5, several Cin chunks and Cout tiles, a fused backward
whose prologue needs more than 48 KB of shared memory, misaligned
pointers, the conv forwards' tile plans (f32 and int16, all bitwise
equal) and their general kernels (K > 7, the plan of zeros), the fused
backward's tile plans (f32: bitwise the general kernel's; int16: the plain
version's) at K = 1 to 7 and its general kernel at K = 9, the FC
forwards' K splits (1 to the most, M and N past one tile; int16: every
split, also at the rails), the fused FC backward's tile plans (every plan
of the sweep's grid at six shapes, three methods, with and without the
epilogue gate: f32 bitwise the general kernel's, int16 the plain
version's; misaligned views; the int32 wrap), each bitwise equal run to
run, and one launch
per wrapper call — for the f32 kernels and for the int16 ones of the fxp16
path, which must equal their plain
versions bit for bit (also where the int32 accumulator wraps) — for the
gate and unpool kernels of the autograd paths (bitwise), with those paths
end to end against the CPU, for the ReLU / pool template (B2, B3 and
their fused pass, f32 and int16, mask on and off, under every block size:
bitwise the plain version and the general route, also on misaligned
views, -0.0, all-negative windows and the int16 rails), and for the
selective scan (B13: ragged S, D
off the block size, N < 16, f32 and bf16 x, the knobs bitwise) and its
backward kernel (all six gradients within 1e-4 * max|ref| of the plain
reverse recurrence, N in {1, 4, 7, 8, 16}, ragged S, several windows,
strided B/C, gh absent, subsets of the gradients, the knobs and a second
run bitwise, the rejects, and the autograd Function against the CPU)
with falcon-mamba's SMOKE LM against the CPU; and the bf16 instances,
among them the bf16 forwards on the tensor cores (every conv tile of
``conv_mma_candidates`` and every FC cluster size of
``vmm_mma_candidates`` within one bf16 step of the plain version, a
route's plans bitwise equal, the conv's FFMA route within the same bound;
ragged H/W and Cout, Cin 16/48/96, K = 1, 5, 7, misaligned views) and the
bf16 backwards on the tensor cores (every plan of
``conv_bwd_mma_candidates`` and ``vmm_bwd_mma_candidates`` bitwise equal
to the rule's and to a repeat, within one bf16 step of the plain version;
K 1 to 7, Cout' 3 to 64, pooled or not, the epilogue gate on and off, the
three methods, S 1, 3 and 4, FC K = 10, 13 and 37, misaligned views; C =
13 on the FFMA route), and the explanation server on the card
(``repro_torch.serve``, tiny config: a cache hit bitwise the cold explain
and launching only the backward kernels, in f32, bf16 and fxp16; the
cache owning exactly ``bits_stored / 8`` bytes on the device; the dispatch
clock read after a synchronise, so a batch whose kernels outlast its
launches reads slow).
Every test needs a CUDA device and skips without one.  This file imports
neither JAX nor the JAX package, so on a machine without JAX run it
without the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import fixedpoint, masks
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.conv2d import ref as conv_ref
from repro_torch.kernels.conv2d.conv2d import (CONV_BWD_GENERAL,
                                               CONV_GENERAL, ConvBwdMmaPlan,
                                               ConvBwdPlan, ConvPlan, conv2d,
                                               conv2d_bwd_fused,
                                               conv2d_bwd_fused_plain,
                                               conv2d_planned,
                                               conv_bwd_bf16_plan,
                                               conv_bwd_mma_candidates,
                                               conv_bwd_plan,
                                               conv_mma_candidates, conv_plan)
from repro_torch.kernels.conv2d.fxp import (conv2d_bwd_fused_fxp,
                                            conv2d_bwd_fused_fxp_plain,
                                            conv2d_fxp, conv2d_fxp_planned)
from repro_torch.kernels.pool import ref as pool_ref
from repro_torch.kernels.pool.fxp import (maxpool_fwd_fxp, relu_pool_fwd_fxp,
                                          unpool_bwd_fxp)
from repro_torch.kernels.pool.pool import (maxpool_fwd, relu_pool_fwd,
                                           unpool_bwd)
from repro_torch.kernels.relu_mask import ref as relu_ref
from repro_torch.kernels.relu_mask.relu_mask import relu_bwd, relu_fwd
from repro_torch.kernels.tiling import RELU_POOL_GENERAL, RELU_POOL_THREADS
from repro_torch.kernels.vmm import ref as vmm_ref
from repro_torch.kernels.vmm.fxp import (vmm_bwd_fused_fxp,
                                         vmm_bwd_fused_fxp_plain, vmm_fxp,
                                         vmm_fxp_with_splits)
from repro_torch.kernels.vmm.vmm import (VMM_BWD_GENERAL, VmmBwdPlan, vmm,
                                         vmm_bwd_candidates, vmm_bwd_fused,
                                         vmm_bwd_fused_plain,
                                         vmm_bwd_mma_candidates,
                                         vmm_bwd_mma_plan, vmm_bwd_plan,
                                         vmm_max_splits, vmm_mma_candidates,
                                         vmm_mma_plan, vmm_planned,
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


# The ReLU / pool template (csrc/relu_pool.cuh): every instance under every
# block size, against its plain version and against the general route (B2
# then B3 on their first kernels), bitwise, f32 and int16, at ragged C.
RELU_POOL_MAPS = [(2, 4, 4, 3), (1, 8, 6, 13), (3, 6, 10, 64),
                  (2, 8, 8, 32), (1, 2, 2, 5)]


def _relu_pool_input(gen, shape, dtype):
    if dtype == torch.int16:
        x = _q(gen, *shape, scale=0.02)
        x[..., ::5] = fixedpoint.INT16_LIM            # the rails
        x[..., 1::7] = -fixedpoint.INT16_LIM - 1
    else:
        x = _randn(gen, *shape)
    x[:, :2, :2] = x[:, :2, :2].clamp(max=-1)         # all-negative window
    x[:, -2:, -2:] = 0                                # exact zeros
    if dtype == torch.float32:
        x.view(-1)[::13] = -0.0                       # -0.0 maps to +0.0
    return x


def _general_relu_pool(x, mask):
    n, h, w, c = x.shape
    y, m = relu_fwd(x.reshape(-1, c), threads=RELU_POOL_GENERAL)
    y, idx = maxpool_fwd(y.reshape(x.shape), threads=RELU_POOL_GENERAL)
    return y, (m.reshape(n, h, w, -1) if mask else None), idx


def _equal_all(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)
            if g.dtype == torch.float32:       # +0.0 and -0.0 differ here
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("threads", RELU_POOL_THREADS + (None,))
@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("shape", RELU_POOL_MAPS)
def test_relu_pool_fwd_bitwise(gen, shape, dtype, mask, threads):
    x = _relu_pool_input(gen, shape, dtype)
    before = {k: LAUNCHES[k] for k in ("relu_fwd", "maxpool_fwd")}
    got = _launched("relu_pool_fwd",
                    lambda: relu_pool_fwd(x, mask, threads=threads))
    assert {k: LAUNCHES[k] for k in before} == before
    _equal_all(got, pool_ref.relu_pool_fwd(x, mask))
    _equal_all(got, _general_relu_pool(x, mask))
    if dtype == torch.int16 and threads is None:
        _equal_all(relu_pool_fwd_fxp(x, mask), got)


@pytest.mark.parametrize("threads", RELU_POOL_THREADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("shape", RELU_POOL_MAPS)
def test_relu_fwd_and_maxpool_fwd_every_block_size_equal_general(
        gen, shape, dtype, threads):
    x = _relu_pool_input(gen, shape, dtype)
    x2 = x.reshape(-1, shape[-1])
    got = _launched("relu_fwd", lambda: relu_fwd(x2, threads=threads))
    _equal_all(got, relu_fwd(x2, threads=RELU_POOL_GENERAL))
    _equal_all(got, relu_ref.relu_fwd(x2))
    got = _launched("maxpool_fwd", lambda: maxpool_fwd(x, threads=threads))
    _equal_all(got, maxpool_fwd(x, threads=RELU_POOL_GENERAL))
    _equal_all(got, pool_ref.maxpool_fwd(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
def test_relu_pool_fwd_misaligned_pointers(gen, dtype):
    shape = (2, 4, 6, 16)
    n = 2 * 4 * 6 * 16
    base = _relu_pool_input(gen, shape, dtype).reshape(-1)
    for off in (1, 3):                 # no 16-byte loads: the scalar path
        flat = torch.zeros(n + 3, dtype=dtype, device="cuda")
        flat[off:off + n] = base
        x = flat[off:off + n].view(shape)
        _equal_all(relu_pool_fwd(x), pool_ref.relu_pool_fwd(x))
        _equal_all(maxpool_fwd(x), pool_ref.maxpool_fwd(x))
        x2 = x.reshape(-1, 16)
        _equal_all(relu_fwd(x2), relu_ref.relu_fwd(x2))


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


def _bwd_inputs(gen, case, method, k=3, fxp=False, g_flat=False):
    """``(g, wt, kw)`` of one fused-backward case: f32, or int16 (Q7.8
    gradients, Q1.14 weights) with ``fxp``; ``g_flat`` makes g a view one
    element into its storage (a misaligned pointer)."""
    n, h, w, c, cout, pooled, s, epilogue = case
    y = _q(gen, n, h, w, c) if fxp else _randn(gen, n, h, w, c)
    mask = None if method == "deconvnet" else masks.pack_mask(y > 0)
    idx = pool_ref.maxpool_fwd(torch.clamp_min(y, 0))[1] if pooled else None
    hg, wg = (h // 2, w // 2) if pooled else (h, w)
    shape = (s, n, hg, wg, c)
    numel = s * n * hg * wg * c + (1 if g_flat else 0)
    g = (_q(gen, numel, scale=2.0) if fxp else _randn(gen, numel))
    g = (g[1:] if g_flat else g).view(shape)
    wt = (_qw(gen, k, k, c, cout, scale=0.1) if fxp
          else _randn(gen, k, k, c, cout, scale=0.1))
    omask = None
    if epilogue and method != "deconvnet":
        omask = masks.pack_mask(_randn(gen, n, h, w, cout) > 0)
    kw = dict(pool_idx=idx, relu_mask=mask, gate=True, method=method,
              out_relu_mask=omask, out_gate=epilogue)
    return g, wt, kw


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused(gen, case, method):
    g, wt, kw = _bwd_inputs(gen, case, method)
    got = _launched("conv2d_bwd_fused", lambda: conv2d_bwd_fused(g, wt, **kw))
    _close(got, conv2d_bwd_fused_plain(g, wt, **kw))


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused_tiled_equals_general_kernel_bitwise(gen, case,
                                                              method):
    """K = 3: the tiled kernel sums each output in conv_kernel's order."""
    g, wt, kw = _bwd_inputs(gen, case, method)
    got = _launched("conv2d_bwd_fused", lambda: conv2d_bwd_fused(g, wt, **kw))
    general = _launched("conv2d_bwd_fused", lambda: conv2d_bwd_fused(
        g, wt, plan=CONV_BWD_GENERAL, **kw))
    torch.cuda.synchronize()
    assert torch.equal(got, general)


#: Tile plans of the fused backward beside conv_bwd_plan's: one row of 4
#: channels a block and a 1-channel chunk, seed groups of 2 (a partial
#: last group at S = 3) and 3, a 64-channel block, seeds in thread slices
BWD_PLANS = [ConvBwdPlan(1, 8, 4, 1, 1), ConvBwdPlan(16, 4, 16, 8, 2),
             ConvBwdPlan(2, 4, 64, 32, 3), ConvBwdPlan(4, 4, 8, 4, 3),
             ConvBwdPlan(8, 8, 32, 16, 1), ConvBwdPlan(8, 4, 4, 8, 1, 3),
             ConvBwdPlan(2, 4, 16, 8, 2, 2)]


@pytest.mark.parametrize("case", BWD_CASES)
def test_conv2d_bwd_fused_bitwise_run_to_run_and_across_plans(gen, case):
    g, wt, kw = _bwd_inputs(gen, case, "guided")
    first = conv2d_bwd_fused(g, wt, **kw)
    for got in [conv2d_bwd_fused(g, wt, **kw)] + [
            _launched("conv2d_bwd_fused", lambda p=p: conv2d_bwd_fused(
                g, wt, plan=p, **kw)) for p in BWD_PLANS]:
        torch.cuda.synchronize()
        assert torch.equal(got, first)
    _close(first, conv2d_bwd_fused_plain(g, wt, **kw))


@pytest.mark.parametrize("k", [1, 5, 7, 9])
@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused_other_kernel_sizes(gen, k, method):
    """K = 1, 5, 7 on the tiled kernel (bitwise the general one's), K = 9
    on the general kernel."""
    g, wt, kw = _bwd_inputs(gen, (2, 10, 6, 24, 12, True, 3, True), method,
                            k=k)
    got = _launched("conv2d_bwd_fused", lambda: conv2d_bwd_fused(g, wt, **kw))
    _close(got, conv2d_bwd_fused_plain(g, wt, **kw))
    general = conv2d_bwd_fused(g, wt, plan=CONV_BWD_GENERAL, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, general)


def test_conv2d_bwd_fused_misaligned_pointers(gen):
    """g one float into its storage, wt too: 4-byte copies only."""
    g, wt, kw = _bwd_inputs(gen, (2, 8, 8, 16, 12, True, 3, True), "guided",
                            g_flat=True)
    wt = torch.cat([wt.new_zeros(1), wt.flatten()])[1:].view(wt.shape)
    got = conv2d_bwd_fused(g, wt, **kw)
    _close(got, conv2d_bwd_fused_plain(g, wt, **kw))
    assert torch.equal(got, conv2d_bwd_fused(g, wt, plan=CONV_BWD_GENERAL,
                                             **kw))


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


def _conv_fxp_want(x, wt, b=None):
    y = conv_ref.conv2d_fxp(x, wt)
    return y if b is None else fixedpoint.sat_add(y, b)


#: Tile plans of the int16 forward beside conv_plan's: one row of 4
#: channels and a 1-channel chunk, a 16-row tile at 4 pixels a thread, a
#: 64-channel block, a 4-channel chunk (8-byte copies)
FXP_PLANS = [ConvPlan(1, 8, 4, 1), ConvPlan(16, 4, 16, 8),
             ConvPlan(2, 8, 64, 32), ConvPlan(4, 4, 8, 4)]


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("cin", [3, 13, 64])
def test_conv2d_fxp_kernel_sizes_and_channel_counts(gen, k, cin):
    """K = 1 to 7 on the tiled kernel, K = 9 on the general one; Cin = 3
    (6-byte rows: ordinary loads) and 13 (odd) beside 64 (16-byte
    copies); both kernels give the plain version's bits."""
    x = _q(gen, 2, 9, 7, cin)
    wt = _qw(gen, k, k, cin, 20)
    b = _q(gen, 20, scale=4.0)
    want = _conv_fxp_want(x, wt, b)
    _same(_launched("conv2d_fxp_fwd", lambda: conv2d_fxp(x, wt, b)), want)
    _same(_launched("conv2d_fxp_fwd", lambda: conv2d_fxp_planned(
        x, wt, b, plan=CONV_GENERAL)), want)


@pytest.mark.parametrize("n,h,w,cin,cout", [(4, 32, 32, 3, 32),
                                            (4, 16, 16, 64, 64),
                                            (2, 13, 7, 96, 3)])
def test_conv2d_fxp_bitwise_run_to_run_and_across_plans(gen, n, h, w, cin,
                                                         cout):
    x = _q(gen, n, h, w, cin)
    wt = _qw(gen, 3, 3, cin, cout)
    b = _q(gen, cout, scale=4.0)
    want = _conv_fxp_want(x, wt, b)
    first = conv2d_fxp(x, wt, b)
    _same(first, want)
    _same(conv2d_fxp(x, wt, b), first)
    chosen = conv_plan(n, h, w, cin, cout, 3, esize=2)
    for p in FXP_PLANS + [chosen, CONV_GENERAL]:
        _same(_launched("conv2d_fxp_fwd", lambda p=p: conv2d_fxp_planned(
            x, wt, b, plan=p)), want)


def test_conv2d_fxp_misaligned_pointers(gen):
    """x, w and b one int16 into their storage (2 bytes off 16): no copy
    width is aligned, so the stages fill by ordinary loads; y stays
    aligned."""
    x = _q(gen, 2 * 6 * 5 * 16 + 1)[1:].view(2, 6, 5, 16)
    wt = _qw(gen, 3 * 3 * 16 * 12 + 1)[1:].view(3, 3, 16, 12)
    b = _q(gen, 13, scale=4.0)[1:]
    want = _conv_fxp_want(x, wt, b)
    for p in [None] + FXP_PLANS:
        _same(conv2d_fxp_planned(x, wt, b, plan=p), want)


def test_conv2d_fxp_accumulator_wraps_under_every_plan(gen):
    """The rails through every plan and the general kernel: image 0's
    channel 0 sums 576 products of 2^30, past 2^31."""
    x, wt = _rails(gen, 2, 16, 16, 64), _rails(gen, 3, 3, 64, 64)
    x[0] = fixedpoint.INT16_LIM
    wt[..., 0] = fixedpoint.INT16_LIM
    want = _conv_fxp_want(x, wt)
    for p in [None, CONV_GENERAL] + FXP_PLANS:
        _same(conv2d_fxp_planned(x, wt, plan=p), want)


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused_fxp_bitwise(gen, case, method):
    g, wt, kw = _bwd_inputs(gen, case, method, fxp=True)
    got = _launched("conv2d_bwd_fused_fxp",
                    lambda: conv2d_bwd_fused_fxp(g, wt, **kw))
    _same(got, conv2d_bwd_fused_fxp_plain(g, wt, **kw))


@pytest.mark.parametrize("case", BWD_CASES)
def test_conv2d_bwd_fused_fxp_bitwise_across_plans(gen, case):
    """Every tile plan and the general kernel: the plain version's bits."""
    g, wt, kw = _bwd_inputs(gen, case, "saliency", fxp=True)
    want = conv2d_bwd_fused_fxp_plain(g, wt, **kw)
    for p in BWD_PLANS + [CONV_BWD_GENERAL]:
        _same(_launched("conv2d_bwd_fused_fxp", lambda p=p:
                        conv2d_bwd_fused_fxp(g, wt, plan=p, **kw)), want)


@pytest.mark.parametrize("k", [1, 5, 7, 9])
def test_conv2d_bwd_fused_fxp_other_kernel_sizes(gen, k):
    g, wt, kw = _bwd_inputs(gen, (2, 10, 6, 24, 12, True, 3, True), "guided",
                            k=k, fxp=True)
    _same(_launched("conv2d_bwd_fused_fxp",
                    lambda: conv2d_bwd_fused_fxp(g, wt, **kw)),
          conv2d_bwd_fused_fxp_plain(g, wt, **kw))


@pytest.mark.parametrize("method", ["saliency", "deconvnet"])
def test_conv2d_bwd_fused_fxp_accumulator_wraps(gen, method):
    """Rails through the backward: at channel 0 of image 0 every routed
    gradient and weight is +32767 (the gates keep them), so each output sums
    hundreds of products of 2^30, past 2^31: the int32 sum wraps."""
    n, h, w, c, cout = 2, 10, 6, 200, 40
    g, wt = _rails(gen, 3, n, h // 2, w // 2, c), _rails(gen, 3, 3, c, cout)
    g[:, 0] = fixedpoint.INT16_LIM
    wt[..., 0] = fixedpoint.INT16_LIM
    y = _randn(gen, n, h, w, c)
    y[0] = 1.0                             # image 0: every mask bit set
    _, idx = pool_ref.maxpool_fwd(torch.clamp_min(y, 0))
    kw = dict(pool_idx=idx, gate=True, method=method, relu_mask=None
              if method == "deconvnet" else masks.pack_mask(y > 0))
    want = conv2d_bwd_fused_fxp_plain(g, wt, **kw)
    _same(conv2d_bwd_fused_fxp(g, wt, **kw), want)
    _same(conv2d_bwd_fused_fxp(g, wt, plan=CONV_BWD_GENERAL, **kw), want)


def test_conv2d_bwd_fused_fxp_misaligned_pointers(gen):
    """int16 g and wt one element into their storage (2-byte offsets):
    ordinary loads where no 4-byte copy is aligned."""
    g, wt, kw = _bwd_inputs(gen, (2, 8, 8, 16, 12, True, 3, True), "guided",
                            fxp=True, g_flat=True)
    wt = torch.cat([wt.new_zeros(1), wt.flatten()])[1:].view(wt.shape)
    _same(conv2d_bwd_fused_fxp(g, wt, **kw),
          conv2d_bwd_fused_fxp_plain(g, wt, **kw))


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


def test_vmm_fxp_every_split_bitwise(gen):
    """Ragged M and N tiles, K = 1000 off the 32-deep chunk: every split
    (1 to 32 slices) gives the plain version's bits, each one launch."""
    m, k, n = 33, 1000, 70
    x = _q(gen, m, k)
    w = _qw(gen, k, n, scale=k ** -0.5)
    b = _q(gen, n, scale=4.0)
    want = fixedpoint.sat_add(vmm_ref.vmm_fxp(x, w), b)
    for splits in range(1, vmm_max_splits(k) + 1):
        _same(_launched("vmm_fxp_fwd", lambda: vmm_fxp_with_splits(
            x, w, b, splits=splits)), want)
    with pytest.raises(ValueError, match="splits"):
        vmm_fxp_with_splits(x, w, b, splits=vmm_max_splits(k) + 1)


@pytest.mark.parametrize("m,k,n", [(5, 37, 13), (3, 20, 8), (32, 100, 128)])
def test_vmm_fxp_k_off_the_chunk(gen, m, k, n):
    """K not a multiple of the chunk (or of 8: scalar x loads)."""
    x, w, b = _q(gen, m, k), _qw(gen, k, n), _q(gen, n)
    want = fixedpoint.sat_add(vmm_ref.vmm_fxp(x, w), b)
    for splits in sorted({1, vmm_max_splits(k)}):
        _same(vmm_fxp_with_splits(x, w, b, splits=splits), want)


def test_vmm_fxp_misaligned_pointers(gen):
    """x and w one int16 into their storage: scalar loads, every split."""
    x = _q(gen, 32 * 512 + 1)[1:].view(32, 512)
    w = _qw(gen, 512 * 128 + 1, scale=0.05)[1:].view(512, 128)
    want = vmm_ref.vmm_fxp(x, w)
    for splits in (1, 4, 16):
        _same(vmm_fxp_with_splits(x, w, splits=splits), want)


def test_vmm_fxp_rails_wrap_at_fc0_under_several_splits(gen):
    """FC0 at the rails: row 0 x column 0 sums 4096 products of 2^30; the
    slices' int32 partial sums wrap like the whole sum."""
    x, w = _rails(gen, 32, 4096), _rails(gen, 4096, 128)
    x[0] = fixedpoint.INT16_LIM
    w[:, 0] = fixedpoint.INT16_LIM
    want = vmm_ref.vmm_fxp(x, w)
    first = vmm_fxp(x, w)
    _same(first, want)
    _same(vmm_fxp(x, w), first)
    for splits in (1, 2, 8, 64, 128):
        _same(vmm_fxp_with_splits(x, w, splits=splits), want)


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


# -- the tiled fused FC backward (B6 f32, B10 int16: csrc/vmm_bwd.cuh)

#: (S, M, K, N): ragged K and N (13, 21, 65, 200, 300), M off the row tile
#: (33, 7), K below one mask byte's chunk, and the main path's FC1 and FC0
#: at S = 3 (seed-batched) and S = 1 (vjp and training).
VMM_BWD_SHAPES = [(1, 4, 13, 21), (3, 33, 128, 300), (3, 32, 10, 128),
                  (3, 32, 128, 4096), (1, 32, 128, 4096), (5, 7, 200, 65)]


def _vmm_bwd_gates(gen, m, k, n):
    """``(method, epilogue, kw)`` for the three methods, without and with
    the epilogue gate."""
    for method in METHODS:
        mask = (None if method == "deconvnet"
                else masks.pack_mask(_randn(gen, m, k) > 0))
        for epilogue in (False, True):
            omask = (masks.pack_mask(_randn(gen, m, n) > 0)
                     if epilogue and method != "deconvnet" else None)
            yield method, epilogue, dict(
                relu_mask=mask, gate=True, method=method,
                out_relu_mask=omask, out_gate=epilogue)


@pytest.mark.parametrize("s,m,k,n", VMM_BWD_SHAPES)
def test_vmm_bwd_fused_every_plan_equals_general_kernel_bitwise(gen, s, m,
                                                                k, n):
    """f32: vmm_bwd_plan's tile and every plan of the sweep give the bits of
    the general 16x16 kernel (one thread sums k ascending with fmaf), which
    is within TOL of the plain version."""
    g = _randn(gen, s, m, k)
    w = _randn(gen, k, n, scale=k ** -0.5)
    plans = vmm_bwd_candidates(s, m, k, n)
    assert plans
    for method, epilogue, kw in _vmm_bwd_gates(gen, m, k, n):
        general = vmm_bwd_fused(g, w, plan=VMM_BWD_GENERAL, **kw)
        _close(general, vmm_bwd_fused_plain(g, w, **kw))
        got = _launched("vmm_bwd_fused", lambda: vmm_bwd_fused(g, w, **kw))
        torch.cuda.synchronize()
        assert torch.equal(got, general), (method, epilogue)
        for p in plans:
            got = vmm_bwd_fused(g, w, plan=p, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, general), (method, epilogue, p)


@pytest.mark.parametrize("s,m,k,n", VMM_BWD_SHAPES)
def test_vmm_bwd_fused_fxp_every_plan_bitwise(gen, s, m, k, n):
    """int16: vmm_bwd_plan's tile, every plan of the sweep and the general
    kernel give the plain version's bits."""
    g = _q(gen, s, m, k, scale=3.0)
    w = _qw(gen, k, n, scale=k ** -0.5)
    plans = vmm_bwd_candidates(s, m, k, n)
    for method, epilogue, kw in _vmm_bwd_gates(gen, m, k, n):
        want = vmm_bwd_fused_fxp_plain(g, w, **kw)
        _same(_launched("vmm_bwd_fused_fxp",
                        lambda: vmm_bwd_fused_fxp(g, w, **kw)), want)
        for p in plans + [VMM_BWD_GENERAL]:
            _same(vmm_bwd_fused_fxp(g, w, plan=p, **kw), want)


def test_vmm_bwd_fused_misaligned_pointers(gen):
    """g and w one element into their storage (f32: 4-byte, int16: 2-byte
    offsets): the narrow copies, bitwise as before."""
    s, m, k, n = 3, 33, 128, 300
    g = _randn(gen, s * m * k + 1)[1:].view(s, m, k)
    w = _randn(gen, k * n + 1, scale=k ** -0.5)[1:].view(k, n)
    gi = _q(gen, s * m * k + 1, scale=3.0)[1:].view(s, m, k)
    wi = _qw(gen, k * n + 1, scale=k ** -0.5)[1:].view(k, n)
    mask = masks.pack_mask(_randn(gen, m, k) > 0)
    omask = masks.pack_mask(_randn(gen, m, n) > 0)
    kw = dict(relu_mask=mask, method="guided", out_relu_mask=omask)
    general = vmm_bwd_fused(g, w, plan=VMM_BWD_GENERAL, **kw)
    _close(general, vmm_bwd_fused_plain(g, w, **kw))
    want = vmm_bwd_fused_fxp_plain(gi, wi, **kw)
    for p in (None, VmmBwdPlan(8, 16, 8, 2), VmmBwdPlan(64, 64, 128, 4)):
        got = vmm_bwd_fused(g, w, plan=p, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, general)
        _same(vmm_bwd_fused_fxp(gi, wi, plan=p, **kw), want)


def test_vmm_bwd_fused_bitwise_run_to_run(gen):
    """The main path's two launches at S = 3 and 1, twice each."""
    for s, m, k, n in ((3, 32, 128, 4096), (1, 32, 128, 4096),
                       (3, 32, 10, 128)):
        g = _randn(gen, s, m, k)
        w = _randn(gen, k, n, scale=k ** -0.5)
        kw = dict(relu_mask=masks.pack_mask(_randn(gen, m, k) > 0))
        first = vmm_bwd_fused(g, w, **kw)
        again = vmm_bwd_fused(g, w, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
        assert vmm_bwd_plan(s, m, k, n) != VMM_BWD_GENERAL


def test_vmm_bwd_fused_fxp_accumulator_wraps_under_every_plan(gen):
    """FC0 at the rails: row 0 x column 0 sums 128 products of 2^30, past
    2^31; the wrap is the plain version's under every plan."""
    s, m, k, n = 1, 32, 128, 4096
    g, w = _rails(gen, s, m, k), _rails(gen, k, n)
    g[:, 0] = fixedpoint.INT16_LIM
    w[:, 0] = fixedpoint.INT16_LIM
    want = vmm_bwd_fused_fxp_plain(g, w)
    for p in vmm_bwd_candidates(s, m, k, n) + [None, VMM_BWD_GENERAL]:
        _same(vmm_bwd_fused_fxp(g, w, plan=p), want)


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
        want.update(conv2d_fwd=2, relu_fwd=3, maxpool_fwd=1, vmm_fwd=2)
        if fused:     # the pooled layer's ReLU and pool: one fused launch
            relus = 0 if method == "deconvnet" else 2
            want.update(relu_fwd=relus, maxpool_fwd=0, relu_pool_fwd=1,
                        conv2d_bwd_fused=4, vmm_bwd_fused=4)
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
    assert LAUNCHES["selective_scan"] == LAUNCHES["selective_scan_bwd"] == 0
    res_c = lm.decode(params, cfg, toks, max_new=3)
    if dtype == "float32":
        assert torch.equal(res.tokens.cpu(), res_c.tokens)
    sc = lm.explain_generated(card, cfg, lm.DecodeResult(
        res_c.tokens.cuda(), res_c.runners_up.cuda(), res_c.prompt_len))
    torch.cuda.synchronize()
    assert LAUNCHES["selective_scan"] == 3 * cfg.n_layers
    assert LAUNCHES["selective_scan_bwd"] == 3 * cfg.n_layers
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


# -- B13 backward: the reverse scan of the LM explain's backward ---------------

SCAN_GRAD_TOL = 1e-4                   # x max|ref|, per gradient
SCAN_GRADS = ("ddt", "dx", "dB", "dC", "dA", "dh0")


def _scan_bwd_inputs(gen, b, s, d, n, dtype=torch.float32):
    args = _scan_inputs(gen, b, s, d, n, dtype)
    gy = _randn(gen, b, s, d).to(dtype)
    return args, gy, _randn(gen, b, d, n)


def _grads_close(got, want):
    """Each gradient within SCAN_GRAD_TOL * max|ref|, plus one bf16 step
    (2^-7 relative) where the gradient is bf16."""
    torch.cuda.synchronize()
    for name, g, w in zip(SCAN_GRADS, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        d = (g.float() - w.float()).abs()
        bound = SCAN_GRAD_TOL * w.float().abs().max()
        if g.dtype == torch.bfloat16:
            bound = bound + SCAN_BF16_RTOL * w.float().abs()
        assert bool((d <= bound).all()), (name, d.max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d,n,d_tile,chunk", [
    (1, 8, 16, 4, 16, 16),             # one block, mostly dead channels
    (2, 13, 200, 16, 200, 5),          # ragged S and window; D % 32 != 0
    (2, 33, 256, 7, 64, 64),           # N = 7: B/C rows read by scalars
    (2, 20, 96, 8, 96, 16),            # N = 8, as falcon-mamba SMOKE
    (2, 40, 64, 4, 64, 8),             # N = 4, one segment a window
    (1, 300, 384, 16, 384, 128),       # three windows of 128 steps
    (3, 1, 8, 1, 8, 4),                # S = 1, N = 1, D < a warp
])
def test_selective_scan_bwd(gen, b, s, d, n, d_tile, chunk, dtype):
    from repro_torch.kernels.ssm_scan import ref as scan_ref
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan_bwd
    args, gy, gh = _scan_bwd_inputs(gen, b, s, d, n, dtype)
    got = _launched("selective_scan_bwd", lambda: selective_scan_bwd(
        *args, gy, gh, d_tile=d_tile, chunk=chunk))
    _grads_close(got, scan_ref.selective_scan_bwd(*args, gy, gh))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_selective_scan_bwd_knobs_and_runs_keep_the_bits(gen, dtype):
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan_bwd
    args, gy, gh = _scan_bwd_inputs(gen, 2, 77, 512, 16, dtype)
    outs = [selective_scan_bwd(*args, gy, gh, d_tile=dtl, chunk=ck)
            for dtl, ck in ((512, 128), (256, 64), (32, 7), (512, 1),
                            (512, 128))]
    torch.cuda.synchronize()
    for out in outs[1:]:
        for g, g0 in zip(out, outs[0]):
            assert torch.equal(g, g0)


@pytest.mark.parametrize("needs", [(False, True, False, False, False, False),
                                   (True, True, True, True, False, False),
                                   (False, False, False, True, True, False),
                                   (False, False, False, False, False, True)])
def test_selective_scan_bwd_computes_what_is_asked(gen, needs):
    """A subset of the gradients: None elsewhere, the full call's bits on
    what is asked."""
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan_bwd
    args, gy, gh = _scan_bwd_inputs(gen, 2, 19, 96, 16, torch.bfloat16)
    full = selective_scan_bwd(*args, gy, gh, d_tile=96, chunk=128)
    part = selective_scan_bwd(*args, gy, gh, d_tile=96, chunk=128,
                              needs=needs)
    torch.cuda.synchronize()
    for w, g, g0 in zip(needs, part, full):
        assert (g is None) != w
        if w:
            assert torch.equal(g, g0)


def test_selective_scan_bwd_strided_operands_and_no_gh(gen):
    """B and C as views of one projection; gh None (h_last unused)."""
    from repro_torch.kernels.ssm_scan import ref as scan_ref
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan_bwd
    (dt, x, _, _, a, h0), gy, _ = _scan_bwd_inputs(gen, 2, 9, 64, 8)
    bc = _randn(gen, 2, 9, 3 + 16)
    bm, cm = bc[..., 3:11], bc[..., 11:]
    got = selective_scan_bwd(dt, x, bm, cm, a, h0, gy, None, d_tile=64,
                             chunk=4)
    _grads_close(got, scan_ref.selective_scan_bwd(dt, x, bm, cm, a, h0, gy))


def test_selective_scan_bwd_rejects_what_it_cannot_hold(gen):
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan_bwd
    args, gy, gh = _scan_bwd_inputs(gen, 1, 4, 32, 17)
    with pytest.raises(ValueError, match="N <= 16"):
        selective_scan_bwd(*args, gy, gh, d_tile=32, chunk=4)
    args, gy, gh = _scan_bwd_inputs(gen, 1, 4, 32, 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        selective_scan_bwd(*args, gy, gh.cpu(), d_tile=32, chunk=4)
    with pytest.raises(TypeError, match="gy must be"):
        selective_scan_bwd(*args, gy.to(torch.bfloat16), gh, d_tile=32,
                           chunk=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_scan_function_backward_on_card_matches_cpu(gen, dtype):
    """ops.selective_scan through autograd: the kernel backward on the card
    (one launch), the plain reverse recurrence on the CPU, B and C bf16
    views as mamba_core passes them; each gradient in its input's dtype."""
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    (dt, x, _, _, a, h0), gy, _ = _scan_bwd_inputs(gen, 2, 21, 128, 16,
                                                   dtype)
    bc = _randn(gen, 2, 21, 4 + 32).to(torch.bfloat16)
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).detach().requires_grad_(w) for t, w in zip(
            (dt, x, bc, a, h0), (True, True, True, False, False))]
        bm, cm = leaves[2][..., 4:20], leaves[2][..., 20:]
        y, _ = scan_ops.selective_scan(leaves[0], leaves[1], bm, cm,
                                       leaves[3], leaves[4], d_tile=128,
                                       chunk=128)
        before = LAUNCHES["selective_scan_bwd"]
        grads.append(torch.autograd.grad(y, leaves[:3], gy.to(dev)))
        if dev == "cuda":
            assert LAUNCHES["selective_scan_bwd"] == before + 1
    for g, g_c, t in zip(*grads, (dt, x, bc)):
        assert g.dtype == t.dtype
        err = (g.float().cpu() - g_c.float()).abs()
        bound = SCAN_GRAD_TOL * g_c.float().abs().max()
        if g.dtype == torch.bfloat16:
            bound = bound + SCAN_BF16_RTOL * g_c.float().abs()
        assert bool((err <= bound).all())


# -- the bf16 instances of B1-B6 and of the fused pass (the bf16 path) ------
#
# The ReLU / pool instances compare and select only: bitwise their plain
# version and the general route.  The conv and FC instances sum the
# widened operands in f32 in the f32 instances' order and round once (the
# forward's bias after the rounding, then once more); the plain version
# sums in cuDNN's or cuBLAS's order, so an output may land one rounding
# step away: |got - want| <= 2^-7 * (|sum| + |want|), one bf16 step of the
# unrounded f32 sum and one of the output, plus the f32 kernels' own
# TOL * max|sum| for the reordered sum itself (it dominates where a long
# sum cancels to near 0: C = 600 at K = 5).  Every tile plan of a kernel
# keeps its order, so plans give the same bits.  The bf16 FC forward runs
# on the tensor cores, the same bits under each plan of one cluster size;
# the bf16 conv forward has two routes, the tensor cores (Cin a multiple of
# 16) and FFMA, each the same bits under each of its plans, and the two,
# which sum in other orders, held to each other within the same bound.

BF = torch.bfloat16
BF16_STEP = 2.0 ** -7


def _bf(gen, *shape, scale=1.0):
    return _randn(gen, *shape, scale=scale).to(BF)


def _bf16_close(got, want, acc):
    """Within one bf16 step of the f32 sum ``acc`` and one of ``want``,
    plus the reordered f32 sum's own tolerance."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == BF and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    bound = (BF16_STEP * (acc.abs() + want.float().abs())
             + TOL * acc.abs().max())
    assert bool((err <= bound).all()), (err - bound).max().item()


def _equal_bits(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype
            if g.dtype == BF:              # +0.0 and -0.0 differ here
                g, w = g.view(torch.int16), w.view(torch.int16)
            assert torch.equal(g, w)


def _relu_pool_input_bf16(gen, shape):
    x = _bf(gen, *shape)
    x[:, :2, :2] = x[:, :2, :2].clamp(max=-1)         # all-negative window
    x[:, -2:, -2:] = 0                                # exact zeros
    x.view(-1)[::13] = -0.0                           # -0.0 maps to +0.0
    x.view(-1)[1::17] = x.view(-1)[2::17][:x.view(-1)[1::17].numel()]
    return x                                          # and tied neighbours


@pytest.mark.parametrize("threads", RELU_POOL_THREADS + (None,))
@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("shape", RELU_POOL_MAPS)
def test_relu_pool_fwd_bf16_bitwise(gen, shape, mask, threads):
    x = _relu_pool_input_bf16(gen, shape)
    got = _launched("relu_pool_fwd",
                    lambda: relu_pool_fwd(x, mask, threads=threads))
    _equal_bits(got, pool_ref.relu_pool_fwd(x, mask))
    _equal_bits(got, _general_relu_pool(x, mask))


@pytest.mark.parametrize("threads", RELU_POOL_THREADS)
@pytest.mark.parametrize("shape", RELU_POOL_MAPS)
def test_relu_fwd_and_maxpool_fwd_bf16_every_block_size_equal_general(
        gen, shape, threads):
    x = _relu_pool_input_bf16(gen, shape)
    x2 = x.reshape(-1, shape[-1])
    got = _launched("relu_fwd", lambda: relu_fwd(x2, threads=threads))
    _equal_bits(got, relu_fwd(x2, threads=RELU_POOL_GENERAL))
    _equal_bits(got, relu_ref.relu_fwd(x2))
    got = _launched("maxpool_fwd", lambda: maxpool_fwd(x, threads=threads))
    _equal_bits(got, maxpool_fwd(x, threads=RELU_POOL_GENERAL))
    _equal_bits(got, pool_ref.maxpool_fwd(x))


def test_relu_pool_fwd_bf16_misaligned_pointers(gen):
    shape = (2, 4, 6, 16)
    n = 2 * 4 * 6 * 16
    base = _relu_pool_input_bf16(gen, shape).reshape(-1)
    for off in (1, 3):                 # no 16-byte loads: the scalar path
        flat = torch.zeros(n + 3, dtype=BF, device="cuda")
        flat[off:off + n] = base
        x = flat[off:off + n].view(shape)
        _equal_bits(relu_pool_fwd(x), pool_ref.relu_pool_fwd(x))
        _equal_bits(maxpool_fwd(x), pool_ref.maxpool_fwd(x))
        x2 = x.reshape(-1, 16)
        _equal_bits(relu_fwd(x2), relu_ref.relu_fwd(x2))


@pytest.mark.parametrize("n,h,w,cin,cout,k", [
    (2, 6, 10, 5, 3, 3),              # ragged spatial and channels
    (1, 8, 8, 16, 8, 5),              # K = 5, tensor cores
    (2, 9, 7, 100, 40, 3),            # several Cin chunks, two Cout tiles
    (1, 13, 7, 3, 96, 1),             # Cin = 3, K = 1
    (2, 5, 9, 96, 96, 7),             # K = 7, three Cin stages
    (4, 32, 32, 3, 32, 3),            # Table III layer 0, batch 4
    (2, 16, 16, 64, 64, 3),           # a Table III layer, batch 2
    (2, 7, 9, 48, 20, 3),             # odd H/W, Cout 20, Cin 48
    (1, 9, 5, 16, 13, 1),             # K = 1, Cout 13
    (2, 6, 11, 96, 36, 5),            # K = 5, Cin 96, Cout 36
    (1, 11, 19, 32, 70, 7),           # K = 7, three Cout tiles, W > 16
])
def test_conv2d_bf16(gen, n, h, w, cin, cout, k):
    x = _bf(gen, n, h, w, cin)
    wt = _bf(gen, k, k, cin, cout, scale=0.2)
    b = _bf(gen, cout)
    got = _launched("conv2d_fwd", lambda: conv2d(x, wt, b))
    acc = conv_ref.conv2d_widened(x, wt)
    _bf16_close(got, conv_ref.conv2d_bf16(x, wt) + b, acc)
    _bf16_close(conv2d(x, wt), conv_ref.conv2d_bf16(x, wt), acc)
    _equal_bits((conv2d(x, wt, b),), (got,))             # run to run
    # each route: the same bits under every plan; the rule's route is the
    # tensor cores where Cin is a multiple of 16; the routes agree within
    # one bf16 step
    ffma = [ConvPlan(1, 8, 4, 1), ConvPlan(2, 4, 16, 8),
            conv_plan(n, h, w, cin, cout, k, esize=2)]
    routes = [ffma]
    if cin % 16 == 0:
        routes.append(conv_mma_candidates(h, w, cin, cout, k))
    firsts = []
    for plans in routes:
        first = conv2d_planned(x, wt, b, plan=plans[0])
        for p in plans[1:]:
            _equal_bits((conv2d_planned(x, wt, b, plan=p),), (first,))
        firsts.append(first)
    _equal_bits((firsts[-1],), (got,))
    for first in firsts:
        _bf16_close(first, got, acc)


def test_conv2d_bf16_has_no_general_kernel(gen):
    x = _bf(gen, 1, 8, 8, 4)
    with pytest.raises(ValueError, match="bf16 has no general kernel"):
        conv2d(x, _bf(gen, 9, 9, 4, 4))
    with pytest.raises(ValueError, match="bf16 has no general kernel"):
        conv2d_planned(x, _bf(gen, 3, 3, 4, 4), plan=CONV_GENERAL)
    g = _bf(gen, 1, 1, 8, 8, 4)
    with pytest.raises(ValueError, match="bf16 has no general kernel"):
        conv2d_bwd_fused(g, _bf(gen, 3, 3, 4, 4), plan=CONV_BWD_GENERAL)
    with pytest.raises(ValueError, match="bf16 has no general kernel"):
        vmm_bwd_fused(_bf(gen, 1, 2, 8), _bf(gen, 8, 4),
                      plan=VMM_BWD_GENERAL)
    with pytest.raises(TypeError):                    # bf16 x, f32 kernel
        conv2d(x, _randn(gen, 3, 3, 4, 4))


def test_conv2d_bf16_misaligned_pointer(gen):
    flat = _bf(gen, 2 * 6 * 5 * 8 + 1)
    x = flat[1:].view(2, 6, 5, 8)     # 2-byte offset: ordinary loads
    wt = _bf(gen, 3, 3, 8, 12, scale=0.2)
    b = _bf(gen, 12)
    _bf16_close(conv2d(x, wt, b), conv_ref.conv2d_bf16(x, wt) + b,
                conv_ref.conv2d_widened(x, wt))


def test_conv2d_bf16_tensor_cores_misaligned_pointers(gen):
    """The tensor-core route's copies by ordinary loads (x or w 2 bytes
    off), 4-byte and 8-byte copies (4 and 8 bytes off 16): the aligned
    result's bits."""
    n, h, w, cin, cout = 2, 6, 5, 32, 24
    x0 = _bf(gen, n, h, w, cin)
    w0 = _bf(gen, 3, 3, cin, cout, scale=0.2)
    b = _bf(gen, cout)
    want = conv2d(x0, w0, b)
    for off in (1, 2, 4):
        fx = torch.zeros(x0.numel() + off, dtype=BF, device="cuda")
        fx[off:] = x0.reshape(-1)
        fw = torch.zeros(w0.numel() + off, dtype=BF, device="cuda")
        fw[off:] = w0.reshape(-1)
        x, wt = fx[off:].view(x0.shape), fw[off:].view(w0.shape)
        _equal_bits((conv2d(x, w0, b),), (want,))
        _equal_bits((conv2d(x0, wt, b),), (want,))
    _bf16_close(want, conv_ref.conv2d_bf16(x0, w0) + b,
                conv_ref.conv2d_widened(x0, w0))


def _bwd_inputs_bf16(gen, case, method, k=3, g_flat=False):
    g, wt, kw = _bwd_inputs(gen, case, method, k=k, g_flat=g_flat)
    return g.to(BF) if not g_flat else g, wt.to(BF), kw


def _bwd_acc(g, wt, kw):
    """The f32 sum the bf16 backward rounds: the plain dataflow on the
    widened operands, before the rounding."""
    from repro_torch.kernels.conv2d.conv2d import bwd_fused_plain
    return bwd_fused_plain(conv_ref.conv2d_widened, g, wt, **kw)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused_bf16(gen, case, method, k):
    """The rule's route within one bf16 step of the plain version; the FFMA
    route's plans the same bits, and within one bf16 step of the tensor
    cores where C is a multiple of 16 (C = 32 here), whose rule's plan is
    the route's bits again."""
    g, wt, kw = _bwd_inputs_bf16(gen, case, method, k=k)
    got = _launched("conv2d_bwd_fused", lambda: conv2d_bwd_fused(g, wt, **kw))
    acc = _bwd_acc(g, wt, kw)
    _bf16_close(got, conv2d_bwd_fused_plain(g, wt, **kw), acc)
    n, h, w, c, cout, pooled, s, _ = case
    plan = conv_bwd_bf16_plan(s, n, h, w, c, cout, k, pooled=pooled)
    assert isinstance(plan, ConvBwdMmaPlan) == (c % 16 == 0)
    _equal_bits((conv2d_bwd_fused(g, wt, plan=plan, **kw),), (got,))
    ffma = [conv_bwd_plan(s, n, h, w, c, cout, k, pooled=pooled, esize=2),
            ConvBwdPlan(2, 4, 8, 4, 1, 2), ConvBwdPlan(4, 8, 4, 8, 1, 1)]
    first = conv2d_bwd_fused(g, wt, plan=ffma[0], **kw)
    for p in ffma[1:]:
        _equal_bits((conv2d_bwd_fused(g, wt, plan=p, **kw),), (first,))
    _bf16_close(first, got, acc)


def test_conv2d_bwd_fused_bf16_misaligned_pointers(gen):
    case = (2, 8, 8, 16, 12, True, 3, True)
    flat = _bf(gen, 3 * 2 * 4 * 4 * 16 + 1)
    g = flat[1:].view(3, 2, 4, 4, 16)  # 2-byte offset: ordinary loads
    _, wt, kw = _bwd_inputs_bf16(gen, case, "guided")
    _bf16_close(conv2d_bwd_fused(g, wt, **kw),
                conv2d_bwd_fused_plain(g, wt, **kw), _bwd_acc(g, wt, kw))


# -- B5 bf16 on the tensor cores --------------------------------------------
#
# The tensor-core route (csrc/conv_bwd_mma.cu): every plan of
# conv_bwd_mma_candidates the same bits as the rule's plan and as a repeat,
# each within one bf16 step of the plain version; K 1 to 7, Cout' 3 to 64
# (one n8 fragment a block up to 8), pooled or not, the epilogue gate on and
# off, the three methods and S 1, 3 and 4 (a second seed group) spread over
# the cases, and misaligned views.

_MMA_BWD_COUTS = (3, 8, 13, 32, 64)


@pytest.mark.parametrize("pooled", [True, False], ids=["pool", "nopool"])
@pytest.mark.parametrize("cout", _MMA_BWD_COUTS)
@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_conv2d_bwd_fused_bf16_tensor_core_plans(gen, k, cout, pooled):
    i = [1, 3, 5, 7].index(k) + _MMA_BWD_COUTS.index(cout) + int(pooled)
    method, s = METHODS[i % 3], (1, 3, 4)[i % 3]
    epilogue, c = i % 2 == 0, (16, 32)[i % 2]
    case = (1, 6, 18, c, cout, pooled, s, epilogue)
    g, wt, kw = _bwd_inputs_bf16(gen, case, method, k=k)
    before = dict(_build.ROUTE_LAUNCHES)
    got = _launched("conv2d_bwd_fused", lambda: conv2d_bwd_fused(g, wt, **kw))
    assert _build.ROUTE_LAUNCHES["conv2d_bwd_fused_bf16_mma"] == \
        before["conv2d_bwd_fused_bf16_mma"] + 1
    _bf16_close(got, conv2d_bwd_fused_plain(g, wt, **kw), _bwd_acc(g, wt, kw))
    _equal_bits((conv2d_bwd_fused(g, wt, **kw),), (got,))         # again
    plans = conv_bwd_mma_candidates(s, 6, 18, c, cout, k, pooled=pooled)
    assert plans
    for p in plans:
        _equal_bits((conv2d_bwd_fused(g, wt, plan=p, **kw),), (got,))


@pytest.mark.parametrize("s", [1, 3, 4])
@pytest.mark.parametrize("epilogue", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused_bf16_tensor_cores_methods_and_seeds(
        gen, method, epilogue, s):
    """The Table III layer-0 shape (C 32 -> Cout' 3, one n8 fragment) and
    layer 3's (pooled, C 64 -> 64) at N = 1 under every method, seed count
    and epilogue gate."""
    for case in ((1, 32, 32, 32, 3, False, s, epilogue),
                 (1, 16, 16, 64, 64, True, s, epilogue)):
        g, wt, kw = _bwd_inputs_bf16(gen, case, method)
        got = conv2d_bwd_fused(g, wt, **kw)
        _bf16_close(got, conv2d_bwd_fused_plain(g, wt, **kw),
                    _bwd_acc(g, wt, kw))
        n, h, w, c, cout, pooled, _, _ = case
        plan = conv_bwd_bf16_plan(s, n, h, w, c, cout, 3, pooled=pooled)
        assert isinstance(plan, ConvBwdMmaPlan)
        other = ConvBwdMmaPlan(2, 1, min(plan.tco, 32), 16, 1, min(s, 3))
        _equal_bits((conv2d_bwd_fused(g, wt, plan=other, **kw),), (got,))


def test_conv2d_bwd_fused_bf16_tensor_cores_misaligned_pointers(gen):
    """The tensor-core route's copies by ordinary loads (g or wt 2 bytes
    off), 4- and 8-byte copies (4 and 8 bytes off 16): the aligned
    result's bits."""
    case = (2, 8, 8, 32, 24, True, 3, True)
    g0, w0, kw = _bwd_inputs_bf16(gen, case, "guided")
    want = conv2d_bwd_fused(g0, w0, **kw)
    for off in (1, 2, 4):
        fg = torch.zeros(g0.numel() + off, dtype=BF, device="cuda")
        fg[off:] = g0.reshape(-1)
        fw = torch.zeros(w0.numel() + off, dtype=BF, device="cuda")
        fw[off:] = w0.reshape(-1)
        g, wt = fg[off:].view(g0.shape), fw[off:].view(w0.shape)
        _equal_bits((conv2d_bwd_fused(g, w0, **kw),), (want,))
        _equal_bits((conv2d_bwd_fused(g0, wt, **kw),), (want,))
    _bf16_close(want, conv2d_bwd_fused_plain(g0, w0, **kw),
                _bwd_acc(g0, w0, kw))


def test_conv2d_bwd_fused_bf16_c13_takes_ffma(gen):
    """C off the 16-channel step reaches the FFMA instance (route 0)."""
    case = (2, 8, 8, 13, 9, True, 3, False)
    g, wt, kw = _bwd_inputs_bf16(gen, case, "saliency")
    assert isinstance(conv_bwd_bf16_plan(3, 2, 8, 8, 13, 9, 3, pooled=True),
                      ConvBwdPlan)
    before = dict(_build.ROUTE_LAUNCHES)
    got = conv2d_bwd_fused(g, wt, **kw)
    assert {k: v - before[k] for k, v in _build.ROUTE_LAUNCHES.items()
            if v != before[k]} == {"conv2d_bwd_fused_bf16_ffma": 1}
    _bf16_close(got, conv2d_bwd_fused_plain(g, wt, **kw), _bwd_acc(g, wt, kw))


@pytest.mark.parametrize("m,k,n", [(5, 37, 13), (1, 4096, 128),
                                   (32, 4096, 128), (32, 128, 10),
                                   (3, 20, 8), (130, 520, 300)])
def test_vmm_bf16(gen, m, k, n):
    x, w, b = _bf(gen, m, k), _bf(gen, k, n, scale=k ** -0.5), _bf(gen, n)
    got = _launched("vmm_fwd", lambda: vmm(x, w, b))
    acc = vmm_ref.vmm_widened(x, w)
    _bf16_close(got, vmm_ref.vmm_bf16(x, w) + b, acc)
    _equal_bits((vmm(x, w, b),), (got,))               # run to run


def test_vmm_bf16_misaligned_pointers(gen):
    flat = _bf(gen, 7 * 64 + 1)
    x = flat[1:].view(7, 64)           # 2-byte offset: element loads
    w, b = _bf(gen, 64, 12, scale=0.125), _bf(gen, 12)
    _bf16_close(vmm(x, w, b), vmm_ref.vmm_bf16(x, w) + b,
                vmm_ref.vmm_widened(x, w))
    fw = _bf(gen, 64 * 12 + 3)
    wv = fw[3:].view(64, 12)           # 6 bytes off: 2-byte element loads
    _equal_bits((vmm(x, wv.clone(), b),), (vmm(x, wv, b),))
    _bf16_close(vmm(x, wv, b), vmm_ref.vmm_bf16(x, wv) + b,
                vmm_ref.vmm_widened(x, wv))


@pytest.mark.parametrize("m,k,n", [(32, 4096, 128), (32, 128, 10),
                                   (130, 520, 300), (5, 37, 13),
                                   (1, 4096, 128), (33, 1000, 40)])
def test_vmm_bf16_tensor_core_plans(gen, m, k, n):
    """Every cluster size and column tile of the sweep's grid within one
    bf16 step of the plain version, one launch each; the two column tiles
    of one cluster size the same bits, and again."""
    x, w, b = _bf(gen, m, k), _bf(gen, k, n, scale=k ** -0.5), _bf(gen, n)
    acc = vmm_ref.vmm_widened(x, w)
    want = vmm_ref.vmm_bf16(x, w) + b
    got = _launched("vmm_fwd", lambda: vmm(x, w, b))
    _equal_bits((vmm_planned(x, w, b, plan=vmm_mma_plan(m, k, n)),), (got,))
    by_cluster = {}
    for p in vmm_mma_candidates(m, k, n):
        y = _launched("vmm_fwd", lambda: vmm_planned(x, w, b, plan=p))
        _bf16_close(y, want, acc)
        _equal_bits((vmm_planned(x, w, b, plan=p),), (y,))
        first = by_cluster.setdefault(p.cluster, y)
        _equal_bits((y,), (first,))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("s,m,k,n,epilogue", [(1, 4, 13, 21, True),
                                              (3, 32, 128, 4096, False),
                                              (3, 32, 10, 128, False),
                                              (2, 7, 64, 40, True),
                                              (3, 50, 37, 20, True),
                                              (4, 33, 200, 9, False)])
def test_vmm_bwd_fused_bf16_every_plan(gen, method, s, m, k, n, epilogue):
    """The tensor-core kernel (csrc/vmm_bwd_bf16.cu) within one bf16 step
    of the plain version, one launch counted under its route; every plan of
    vmm_bwd_mma_candidates, and a repeat, the same bits (K = 10, 13 and 37
    zero-filled to the next k16 step; more than 128 rows: two row
    blocks)."""
    g, w = _bf(gen, s, m, k), _bf(gen, k, n, scale=k ** -0.5)
    mask = (None if method == "deconvnet"
            else masks.pack_mask(_randn(gen, m, k) > 0))
    omask = (masks.pack_mask(_randn(gen, m, n) > 0)
             if epilogue and method != "deconvnet" else None)
    kw = dict(relu_mask=mask, gate=True, method=method,
              out_relu_mask=omask, out_gate=epilogue)
    before = _build.ROUTE_LAUNCHES["vmm_bwd_fused_bf16_mma"]
    got = _launched("vmm_bwd_fused", lambda: vmm_bwd_fused(g, w, **kw))
    assert _build.ROUTE_LAUNCHES["vmm_bwd_fused_bf16_mma"] == before + 1
    from repro_torch.kernels.vmm.vmm import bwd_fused_plain
    acc = bwd_fused_plain(vmm_ref.vmm_widened, g, w, **kw)
    _bf16_close(got, vmm_bwd_fused_plain(g, w, **kw), acc)
    _equal_bits((vmm_bwd_fused(g, w, **kw),), (got,))             # again
    assert vmm_bwd_mma_plan(s, m, k, n) in vmm_bwd_mma_candidates(s, m, k, n)
    for p in vmm_bwd_mma_candidates(s, m, k, n):
        _equal_bits((vmm_bwd_fused(g, w, plan=p, **kw),), (got,))


def test_vmm_bwd_fused_bf16_misaligned_pointers(gen):
    """Copies by ordinary loads (g 2 bytes off, w 6 bytes off) and 4-byte
    copies (K = 10): the aligned result's bits."""
    for s, m, k, n in ((3, 7, 64, 12), (3, 32, 10, 128)):
        g0, w0 = _bf(gen, s, m, k), _bf(gen, k, n, scale=k ** -0.5)
        mask = masks.pack_mask(_randn(gen, m, k) > 0)
        kw = dict(relu_mask=mask, method="guided")
        want = vmm_bwd_fused(g0, w0, **kw)
        fg = _bf(gen, g0.numel() + 1)
        fg[1:] = g0.reshape(-1)
        fw = _bf(gen, w0.numel() + 3)
        fw[3:] = w0.reshape(-1)
        _equal_bits((vmm_bwd_fused(fg[1:].view(g0.shape), w0, **kw),),
                    (want,))
        _equal_bits((vmm_bwd_fused(g0, fw[3:].view(w0.shape), **kw),),
                    (want,))
        from repro_torch.kernels.vmm.vmm import bwd_fused_plain
        _bf16_close(want, vmm_bwd_fused_plain(g0, w0, **kw),
                    bwd_fused_plain(vmm_ref.vmm_widened, g0, w0, **kw))


def test_vmm_bwd_fused_bf16_refuses_the_ffma_plans(gen):
    """bf16 has no FFMA FC backward: a VmmBwdPlan raises, before any
    launch."""
    g, w = _bf(gen, 3, 32, 128), _bf(gen, 128, 64)
    with pytest.raises(ValueError, match="VmmBwdMmaPlan"):
        vmm_bwd_fused(g, w, plan=vmm_bwd_plan(3, 32, 128, 64))


def test_bf16_engine_on_card_matches_cpu_twin(gen):
    """A small CNN in bf16: one launch of an instance per layer, the
    logits within 2^-6 * max of the CPU twin's (the bound of
    tests/test_torch_cnn_bf16.py), and the relevance within it of the
    CPU's replay of the card's stored bits."""
    from repro_torch.engine import CNNModel, EngineSpec, TopK, build
    from repro_torch.kernels import reset_launches
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(in_hw=(8, 8), channels=(8, 8), fc=(16,),
                        num_classes=4)
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((3, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    for method in METHODS:
        spec = dict(method=method, precision="bf16", targets=TopK(2))
        card = build(EngineSpec(CNNModel(params, cfg), **spec))
        cpu = build(EngineSpec(CNNModel(params, cfg, device="cpu"), **spec))
        reset_launches()
        logits, rel, res = card.predict_then_explain(x)
        torch.cuda.synchronize()
        want = {"conv2d_fwd": 2, "relu_fwd": 2, "relu_pool_fwd": 1,
                "vmm_fwd": 2, "conv2d_bwd_fused": 2, "vmm_bwd_fused": 2}
        if method == "deconvnet":
            want["relu_fwd"] = 0
        assert {k: v for k, v in LAUNCHES.items() if v} == {
            k: v for k, v in want.items() if v}
        logits_c, _, _ = cpu.predict_then_explain(x)
        assert logits.dtype == rel.dtype == BF
        err = (logits.cpu().float() - logits_c.float()).abs().max()
        assert err <= 2.0 ** -6 * logits_c.float().abs().max()
        seeds, _ = card._seeds(logits, None, 2)
        back = cpu.replay(cnn.residuals_to(res, "cpu"), seeds.cpu())
        err = (rel.cpu().float() - back.float()).abs().max()
        assert err <= 2.0 ** -6 * back.float().abs().max()


# -- the explanation server on the card (repro_torch.serve) -------------------


def _serve_setup(precision="f32"):
    from repro_torch.engine import CNNModel, EngineSpec, build
    from repro_torch.models import cnn
    from repro_torch.serve import CNNAdapter, ExplanationServer
    cfg = cnn.CNNConfig(in_hw=(8, 8), channels=(4, 4), fc=(16,))
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((4, 8, 8, 3),
                    generator=torch.Generator().manual_seed(1)).numpy()
    eng = build(EngineSpec(CNNModel(params, cfg), precision=precision))
    adapter = CNNAdapter.from_engine(eng)

    def server(**kw):
        kw.setdefault("max_batch", 4)
        kw.setdefault("max_delay_s", 0.0)
        return ExplanationServer(adapter, **kw)
    return adapter, server, x


def _burst(srv, reqs):
    for r in reqs:
        srv.submit(r)
    return srv.drain()


#: kernels of the forward pass (a hit must launch none of them)
FORWARD_COUNTERS = ("conv2d_fwd", "relu_fwd", "relu_pool_fwd", "vmm_fwd",
                    "maxpool_fwd", "conv2d_fxp_fwd", "vmm_fxp_fwd")


@pytest.mark.parametrize("precision", ["f32", "bf16", "fxp16"])
@pytest.mark.parametrize("method,topk", [("saliency", None), ("guided", 3),
                                         ("deconvnet", None)])
def test_serve_hit_is_bitwise_the_cold_explain_and_launches_no_forward(
        gen, precision, method, topk):
    from repro_torch.kernels import reset_launches
    from repro_torch.serve import Request
    adapter, server, x = _serve_setup(precision)
    warm = server()
    _burst(warm, [Request(uid=f"u{i}", kind="predict", x=x[i])
                  for i in range(3)])
    reset_launches()
    hot = _burst(warm, [Request(uid=f"u{i}", kind="explain", x=x[i],
                                method=method, topk=topk) for i in range(3)])
    torch.cuda.synchronize()
    rose = {k: v for k, v in LAUNCHES.items() if v}
    bwd = ("conv2d_bwd_fused_fxp", "vmm_bwd_fused_fxp") if (
        precision == "fxp16") else ("conv2d_bwd_fused", "vmm_bwd_fused")
    assert rose == {bwd[0]: 2, bwd[1]: 2}
    assert not any(LAUNCHES[k] for k in FORWARD_COUNTERS)
    cold = _burst(server(), [Request(uid=f"u{i}", kind="explain", x=x[i],
                                     method=method, topk=topk)
                             for i in range(3)])
    assert all(r.cache_hit for r in hot)
    assert not any(r.cache_hit for r in cold)
    for h, c in zip(hot, cold):
        assert h.relevance.is_cuda and h.targets == c.targets
        assert torch.equal(h.relevance, c.relevance)
        assert torch.equal(h.logits, c.logits)


def test_serve_cache_owns_exactly_bits_stored(gen):
    from repro_torch.serve import Request
    from repro_torch.serve.residual_cache import owned_bytes
    _, server, x = _serve_setup()
    srv = server(cache_capacity=3)
    _burst(srv, [Request(uid=f"u{i}", kind="predict", x=x[i % 4])
                 for i in range(6)])
    assert len(srv.cache) == 3 and srv.cache.stats.evictions == 3
    entry = srv.cache.peek("u5")
    assert entry.residuals["fc"][0].is_cuda
    assert owned_bytes(srv.cache) * 8 == srv.cache.stats.bits_stored > 0


def test_serve_syncs_before_the_dispatch_clock_is_read(gen):
    """A batch whose kernels outlast its launches reads its service time:
    the adapter queues a ~50 ms sleep kernel after the forward and returns
    at once; the dispatch duration the admission estimator observes must
    cover it."""
    from repro_torch.serve import AdmissionConfig, Request
    adapter, server, x = _serve_setup()
    srv = server(admission=AdmissionConfig(capacity=8))
    real = adapter.predict

    def slow(xb):
        out = real(xb)
        torch.cuda._sleep(int(2e6 * 50))       # cycles, ~2 GHz SM clock
        return out
    adapter.predict = slow
    try:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(int(2e6 * 50))
        b.record()
        torch.cuda.synchronize()
        sleep_s = a.elapsed_time(b) / 1e3
        (resp,) = _burst(srv, [Request(uid="a", kind="predict", x=x[0])])
    finally:
        del adapter.predict
    assert resp.ok
    assert srv.admission.estimator.estimate("predict") >= 0.9 * sleep_s
    assert resp.latency_s >= 0.9 * sleep_s
