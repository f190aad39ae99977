"""The port's train step against ``repro.launch.steps`` (CPU, SMOKE
configs; the tolerances and the MoE reference are ``tests/_torch_train.py``'s):
the compute cast set, the loss, one and three steps of the dense configs
at one and two microbatches; and ROADMAP C1's repair: the port's cuDNN
calls run f32 in IEEE precision whatever the process-wide TF32 flags.
Other archs: ``tests/test_torch_train_{zoo,moe,bf16,loop}.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.kernels.conv2d import ref as conv_ref
from repro_torch.launch import steps
from repro_torch.models import cnn
from repro_torch.models import transformer as tf

from _torch_train import check_run, flat, run_both


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_cast_set_equals_reference(arch):
    """Every leaf of the compute tree has the reference's name, shape and
    dtype: matrices, stacked norm scales and routers cast, SSM dynamics
    and the final norm f32."""
    jcfg = jconfigs.get_smoke(arch)
    jc = jax.eval_shape(lambda k: jsteps.cast_for_compute(
        jsteps.make_train_state_init(jcfg)(k).params, jcfg),
        jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in flat(jc).items()}
    cfg = configs.get_smoke(arch)
    p = steps.make_train_state_init(cfg)(torch.Generator().manual_seed(0),
                                         "cpu").params
    assert all(v.dtype == torch.float32 for v in flat(p).values())
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in flat(steps.cast_for_compute(p, cfg)).items()}
    assert got == want
    if jcfg.dtype == "bfloat16":
        assert got["/final_norm/w"][1] == "float32"
        assert got["/segments/0/norm1/w"][1] == "bfloat16"


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llava-next-mistral-7b"])
def test_ce_loss_matches(arch):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    rs = np.random.RandomState(0)
    s = 6 + (cfg.n_patches if cfg.frontend == "patches" else 0)
    logits = (rs.randn(3, s, cfg.vocab) * 4).astype(np.float32)
    labels = rs.randint(0, cfg.vocab, (3, 6)).astype(np.int32)
    want = float(jsteps.ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                jcfg))
    got = float(steps.ce_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels), cfg))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_state_from_jax_and_init():
    """``state_from_jax`` copies the reference's state bit for bit; the
    port's init draws an f32 master of the same tree with zero moments."""
    jcfg = jconfigs.get_smoke("llama3.2-1b")
    js = jax.tree.map(np.asarray, jsteps.make_train_state_init(jcfg)(
        jax.random.PRNGKey(0)))
    ts = steps.state_from_jax(js)
    for j, t in ((js.params, ts.params), (js.opt.mu, ts.opt.mu),
                 (js.opt.nu, ts.opt.nu)):
        jf, tf_ = flat(j), flat(t)
        assert jf.keys() == tf_.keys()
        for k in jf:
            assert tf_[k].numpy().tobytes() == jf[k].tobytes(), k
    assert ts.opt.step.dtype == torch.int32 and int(ts.opt.step) == 0
    mine = steps.make_train_state_init(configs.get_smoke("llama3.2-1b"))(
        torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in flat(mine.params).items()} == \
        {k: v.shape for k, v in flat(js.params).items()}
    assert all(float(v.abs().max()) == 0 for v in flat(mine.opt.nu).values())


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-1.5b"])
def test_train_steps_match(arch, microbatches):
    check_run(*run_both(arch, 3, microbatches))


def test_prefill_and_decode_steps_match():
    """Greedy next tokens of the prefill step and two decode steps equal
    the reference's."""
    arch = "llama3.2-1b"
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = jtf.init(jax.random.PRNGKey(0), jcfg)
    p = tf.params_from_jax(jax.tree.map(np.asarray, jp))
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 7))
    jc = jtf.init_cache(jcfg, 2, 10)
    tc = tf.init_cache(cfg, 2, 10, device="cpu")
    jpre, jdec = jsteps.make_prefill_step(jcfg), jsteps.make_decode_step(jcfg)
    tpre, tdec = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    jn, jc = jpre(jp, {"tokens": jnp.asarray(toks)}, jc)
    tn, tc = tpre(p, {"tokens": torch.from_numpy(toks)}, tc)
    for pos in (7, 8, 9):
        assert tn.dtype == torch.int32 and tuple(tn.shape) == (2, 1)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        if pos == 9:
            break
        jn, jc = jdec(jp, jc, jn, jnp.asarray(pos, jnp.int32))
        tn, tc = tdec(p, tc, tn, pos)


# ---------------------------------------------------------------------------
# ROADMAP C1: cuDNN's f32 setting pinned where the port calls it
# ---------------------------------------------------------------------------


class _ConvSpy(TorchDispatchMode):
    """Records cuDNN's conv f32 setting at every convolution, forward or
    backward, that reaches the dispatcher."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.convolution,
                                   torch.ops.aten.convolution_backward):
            self.seen.append((func.overloadpacket.__name__,
                              torch.backends.cudnn.conv.fp32_precision))
        return func(*args, **(kwargs or {}))


def _conv_calls():
    """The port's conv entry points: the plain conv with its autograd
    input and weight gradients, the weight gradient, and a training step
    of the Table III CNN on each branch."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 8, 3, generator=g, requires_grad=True)
    w = torch.randn(3, 3, 3, 4, generator=g, requires_grad=True)
    conv_ref.conv2d(x, w).square().sum().backward()
    conv_ref.conv2d_weight_grad(x.detach(), w.detach(),
                                torch.randn(2, 8, 8, 4, generator=g))
    cfg = cnn.CNNConfig(in_hw=(8, 8), channels=(4, 4), fc=(8,))
    params = cnn.init(g, cfg)
    leaves = [q[n].requires_grad_() for k in ("conv", "fc")
              for q in params[k] for n in ("w", "b")]
    img = torch.randn(2, 8, 8, 3, generator=g)
    for kw in ({}, {"use_pallas": True}, {"use_pallas": True,
                                          "method": "saliency"}):
        loss = cnn.apply(params, img, cfg, **kw).square().sum()
        torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("api", ["new", "legacy"])
def test_c1_convs_run_ieee_and_restore(api):
    """With TF32 on for cuDNN (PyTorch's default, set through either
    API), every convolution of the port sees it off, and the caller's
    setting is back after each call."""
    cd = torch.backends.cudnn
    before = cd.conv.fp32_precision
    try:
        if api == "new":
            cd.conv.fp32_precision = "tf32"
        else:
            cd.allow_tf32 = True
        setting = cd.conv.fp32_precision
        with _ConvSpy() as spy:
            _conv_calls()
        names = {n for n, _ in spy.seen}
        assert names == {"convolution", "convolution_backward"}
        assert {p for _, p in spy.seen} == {"ieee"}, spy.seen
        assert cd.conv.fp32_precision == setting
        if api == "legacy":
            assert cd.allow_tf32 is True     # the legacy read still works
        with pytest.raises(RuntimeError):    # restored on an exception
            conv_ref.conv2d(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 2, 1))
        assert cd.conv.fp32_precision == setting
    finally:
        cd.conv.fp32_precision = before


def test_c1_plain_conv_bits_unchanged():
    """The pinned plain conv and its gradients are autograd's own
    ``F.conv2d`` bits on the CPU."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 9, 9, 5, generator=g, requires_grad=True)
    w = torch.randn(5, 5, 5, 6, generator=g, requires_grad=True)
    gy = torch.randn(3, 9, 9, 6, generator=g)
    y = conv_ref.conv2d(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), gy)
    y2 = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=2
    ).permute(0, 2, 3, 1)
    dx2, dw2 = torch.autograd.grad(y2, (x, w), gy)
    for a, b in ((y, y2), (dx, dx2), (dw, dw2)):
        assert torch.equal(a, b)
