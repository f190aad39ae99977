"""The fused ReLU+mask+pool of repro_torch against the JAX package, bitwise.

``relu_pool_fwd`` and ``relu_pool_fwd_fxp`` are B2 and B3 in one launch on
the card (``csrc/relu_pool.cuh``); on the CPU they run their plain version,
``pool.ref.relu_pool_fwd``.  The reference is the pair the JAX package's
pooled conv blocks run: ``maxpool_fwd_pallas(relu_fwd_pallas(x))`` (int16:
``maxpool_fwd_fxp``), the Pallas kernels in interpret mode, on NumPy inputs
from a seed.  Values (as bits, so -0.0 is not +0.0), mask bytes and crumb
bytes must be equal, with the mask and without it, at C in {3, 13, 32, 64},
on all-negative windows, exact zeros and -0.0, and at the int16 rails.

Then the CNN: ``_conv_block_fwd_res`` runs the fused wrapper at exactly the
pooled layers (a spy in ``_KERNELS``), and the residuals still equal the
JAX package's for all three methods.  Last, what the wrappers hand the
card, with the launch stubbed: the block size of ``relu_pool_threads``,
a null mask pointer for deconvnet, the general route of B2 / B3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.spec import CNNModel as JCNNModel
from repro.kernels.pool.fxp import maxpool_fwd_fxp as jmaxpool_fwd_fxp
from repro.kernels.pool.pool import maxpool_fwd_pallas
from repro.kernels.relu_mask.relu_mask import relu_fwd_pallas
from repro.models import cnn as jcnn
from repro_torch.kernels import _build
from repro_torch.kernels.pool import pool as pool_mod
from repro_torch.kernels.pool.fxp import relu_pool_fwd_fxp
from repro_torch.kernels.pool.pool import maxpool_fwd, relu_pool_fwd
from repro_torch.kernels.relu_mask import relu_mask as relu_mod
from repro_torch.kernels.relu_mask.relu_mask import relu_fwd
from repro_torch.kernels.tiling import (H100_SMS, RELU_POOL_GENERAL,
                                        RELU_POOL_THREADS, cdiv, mask_bytes,
                                        relu_pool_threads)
from repro_torch.models import cnn

METHODS = ("saliency", "deconvnet", "guided")
INT16_MIN, INT16_MAX = -32768, 32767


def _map(shape, dtype, seed):
    """An NHWC map with an all-negative window at (0, 0), an all-zero one
    at the last, -0.0 scattered (f32), the rails scattered (int16)."""
    rs = np.random.RandomState(seed)
    if dtype == np.int16:
        x = rs.randint(-600, 600, size=shape).astype(np.int16)
        x[..., ::5] = INT16_MAX
        x[..., 1::7] = INT16_MIN
        x[..., 2::9] = -INT16_MAX
    else:
        x = rs.randn(*shape).astype(np.float32)
    x[:, :2, :2] = np.minimum(x[:, :2, :2], -1)
    x[:, -2:, -2:] = 0
    if dtype == np.float32:
        x.reshape(-1)[::13] = -0.0
    return x


def _jax_pair(x, mask):
    """repro's pooled block: relu_fwd_pallas, then the pool, as NumPy."""
    n, h, w, c = x.shape
    yr, m = relu_fwd_pallas(jnp.asarray(x.reshape(-1, c)))
    pool = jmaxpool_fwd_fxp if x.dtype == np.int16 else maxpool_fwd_pallas
    y, idx = pool(yr.reshape(x.shape))
    m = np.asarray(m).reshape(n, h, w, -1) if mask else None
    return np.asarray(y), m, np.asarray(idx)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("c", [3, 13, 32, 64])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_relu_pool_fwd_bitwise_vs_pallas(dtype, c, mask):
    x = _map((2, 4, 6, c), dtype, seed=c)
    fn = relu_pool_fwd_fxp if dtype == np.int16 else relu_pool_fwd
    got = fn(torch.from_numpy(x), mask)
    want = _jax_pair(x, mask)
    _assert_bitwise(got, want)
    y, m, idx = got
    assert idx.dtype == torch.uint8 and tuple(idx.shape) == want[2].shape
    assert not idx[:, 0, 0].any()        # all-negative window: crumbs 0
    if mask:
        assert m.dtype == torch.uint8 and not m[:, :2, :2].any()
    if dtype == np.float32:
        assert not np.signbit(y.numpy()).any()      # -0.0 became +0.0


@pytest.mark.parametrize("mask", [True, False])
def test_relu_pool_fwd_int16_rails_and_ties(mask):
    x = np.full((1, 4, 4, 8), INT16_MIN, np.int16)
    x[0, 0:2, 0:2] = INT16_MAX           # a window tied at the top rail
    x[0, 0, 3, :4] = INT16_MAX           # and one max at candidate (0,1)
    x[0, 2:4, 0:2] = -INT16_MAX          # an all-negative window
    got = relu_pool_fwd_fxp(torch.from_numpy(x), mask)
    _assert_bitwise(got, _jax_pair(x, mask))
    assert got[0][0, 0, 0].eq(INT16_MAX).all() and got[2][0, 0, 0].eq(0).all()


def test_relu_fwd_maps_negative_zero_to_zero_as_pallas_does():
    x = np.array([[-0.0, 0.0, -1.0, 2.0, -0.0, 3.0, -0.0, -0.0, 1.0]],
                 np.float32)
    yj, mj = relu_fwd_pallas(jnp.asarray(x))
    _assert_bitwise(relu_fwd(torch.from_numpy(x)), (yj, mj))


def test_relu_pool_fwd_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="even H, W"):
        relu_pool_fwd(torch.zeros(1, 3, 4, 8))
    with pytest.raises(TypeError):
        relu_pool_fwd(torch.zeros(1, 2, 2, 8, dtype=torch.float64))
    with pytest.raises(TypeError):
        relu_pool_fwd_fxp(torch.zeros(1, 2, 2, 8))
    with pytest.raises(ValueError, match="threads"):
        relu_pool_fwd(torch.zeros(1, 2, 2, 8), threads=RELU_POOL_GENERAL)
    with pytest.raises(ValueError, match="threads"):
        relu_fwd(torch.zeros(4, 8), threads=48)


# --- the CNN: the fused pass at the pooled layers, residuals as repro's ---

SIZES = {
    # tests/golden/generate.py CFG: one pooled layer (1)
    "tiny": dict(in_hw=(8, 8), in_ch=3, channels=(4, 4), kernel=3,
                 fc=(16,), num_classes=4),
    # two pooled layers (1 and 3), as Table III has
    "two_pools": dict(in_hw=(8, 8), in_ch=3, channels=(4, 4, 8, 8),
                      kernel=3, fc=(16,), num_classes=4),
}
MODEL_CASES = [("tiny", "f32"), ("tiny", "fxp16"), ("two_pools", "fxp16")]


def _spy_forward(monkeypatch, precision):
    """Patch the blocks so each call of the fused wrapper, the standalone
    pool and the standalone ReLU records the conv layer it ran in."""
    calls = {"relu_pool": [], "pool": [], "relu": []}
    layer = [-1]
    real_block, k = cnn._conv_block_fwd_res, cnn._KERNELS[precision]

    def block(*a, **kw):
        layer[0] += 1
        return real_block(*a, **kw)

    def spy(key, fn):
        def wrapped(*a, **kw):
            calls[key].append((layer[0], kw.get("mask")))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(cnn, "_conv_block_fwd_res", block)
    monkeypatch.setitem(k, "relu_pool", spy("relu_pool", k["relu_pool"]))
    monkeypatch.setitem(k, "pool", spy("pool", k["pool"]))
    monkeypatch.setattr(cnn, "relu_fwd", spy("relu", cnn.relu_fwd))
    return calls


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("size,precision", MODEL_CASES)
def test_pooled_layers_run_the_fused_pass_and_residuals_match_repro(
        monkeypatch, size, precision, method):
    kw = SIZES[size]
    jcfg, cfg = jcnn.CNNConfig(**kw), cnn.CNNConfig(**kw)
    jparams = jcnn.init(jax.random.PRNGKey(0), jcfg)
    params = cnn.params_from_jax(jax.tree.map(np.asarray, jparams))
    x = np.random.RandomState(1).randn(2, 8, 8, 3).astype(np.float32)
    fwd, _ = JCNNModel(jparams, jcfg).pair(method, precision)
    jlogits, jres = jax.jit(fwd)(jnp.asarray(x))

    calls = _spy_forward(monkeypatch, precision)
    logits, res = cnn.forward_with_residuals(params, torch.from_numpy(x),
                                             cfg, method, precision)
    pooled = [i for i in range(len(cfg.channels))
              if (i + 1) % cfg.pool_every == 0]
    keep = method != "deconvnet"
    assert calls["relu_pool"] == [(i, keep) for i in pooled]
    assert calls["pool"] == []
    unpooled = [i for i in range(len(cfg.channels)) if i not in pooled]
    # the standalone ReLU: unpooled conv layers, then FC0 (layer index of
    # the last conv block); none for deconvnet, which stores no mask
    want_relu = unpooled + [len(cfg.channels) - 1] if keep else []
    assert [i for i, _ in calls["relu"]] == want_relu

    for (jm, ji), (tm, ti) in zip(jres["conv"], res["conv"]):
        assert (jm is None) == (tm is None) and (ji is None) == (ti is None)
        for j, t in ((jm, tm), (ji, ti)):
            if j is not None:
                assert t.dtype == torch.uint8
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for jm, tm in zip(jres["fc"], res["fc"]):
        assert (jm is None) == (tm is None)
        if jm is not None:
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jl = np.asarray(jlogits)
    if precision == "fxp16":
        np.testing.assert_array_equal(logits.numpy(), jl)
    else:
        assert np.abs(logits.numpy() - jl).max() <= 1e-5 * np.abs(jl).max()


# --- what the wrappers hand the card, the launch stubbed ---


@pytest.fixture
def launches(monkeypatch):
    """Stub the card: the wrappers take their kernel route on CPU tensors
    and record ``(counter, entry, args)``."""
    out = []

    def launch(counter, entry, device, *args):
        out.append((counter, entry, args))

    for mod in (pool_mod, relu_mod):
        monkeypatch.setattr(mod, "on_card", lambda name, *ts: True)
        monkeypatch.setattr(mod, "check_kernel_operands",
                            lambda name, *ts: None)
    monkeypatch.setattr(_build, "launch", launch)
    return out


#: The main path's launches of the template at batch 32: B2's three
#: rectifiers of the unpooled layers and the two fused pooled layers.
MAIN_PATH = [("relu", (32 * 32 * 32, 32)), ("relu", (32 * 16 * 16, 64)),
             ("relu", (32, 128)), ("pool", (32, 32, 32, 32)),
             ("pool", (32, 16, 16, 64))]


@pytest.mark.parametrize("kind,shape", MAIN_PATH)
def test_relu_pool_threads_give_every_sm_a_block(kind, shape):
    if kind == "relu":
        r, c = shape
        work = r * mask_bytes(c)
    else:
        n, h, w, c = shape
        work = n * (h // 2) * (w // 2) * mask_bytes(c)
    t = relu_pool_threads(work)
    assert t in RELU_POOL_THREADS and t <= 128
    if work >= H100_SMS * RELU_POOL_THREADS[0]:
        assert cdiv(work, t) >= H100_SMS
        bigger = [b for b in RELU_POOL_THREADS if t < b <= 128]
        assert all(cdiv(work, b) < H100_SMS for b in bigger)
    else:
        assert t == RELU_POOL_THREADS[0]


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, ""),
                                          (torch.int16, "_i16")])
@pytest.mark.parametrize("mask", [True, False])
def test_fused_entry_gets_the_rule_and_a_null_mask_for_deconvnet(
        launches, dtype, suffix, mask):
    x = torch.zeros(2, 6, 4, 16, dtype=dtype)
    y, m, idx = relu_pool_fwd(x, mask)
    (counter, entry, args), = launches
    assert counter == "relu_pool_fwd"
    assert entry == "repro_relu_pool_fwd" + suffix
    assert (args[2] is None) == (not mask) and (m is None) == (not mask)
    assert args[4:] == (2, 6, 4, 16, relu_pool_threads(2 * 3 * 2 * 2))
    assert tuple(y.shape) == (2, 3, 2, 16) and tuple(idx.shape) == (2, 3, 2, 4)
    if mask:
        assert tuple(m.shape) == (2, 6, 4, 2)


@pytest.mark.parametrize("threads", [None, RELU_POOL_GENERAL, 512])
def test_b2_and_b3_entries_take_the_block_size_or_the_general_route(
        launches, threads):
    relu_fwd(torch.zeros(40, 13), threads=threads)
    maxpool_fwd(torch.zeros(1, 4, 4, 13, dtype=torch.int16), threads=threads)
    (c2, e2, a2), (c3, e3, a3) = launches
    assert (c2, e2, c3, e3) == ("relu_fwd", "repro_relu_fwd", "maxpool_fwd",
                                "repro_maxpool_fwd_i16")
    want2 = relu_pool_threads(40 * 2) if threads is None else threads
    want3 = relu_pool_threads(4 * 2) if threads is None else threads
    assert a2[3:] == (40, 13, want2)
    assert a3[3:] == (1, 4, 4, 13, want3)
