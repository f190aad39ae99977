"""bf16 composite methods of repro_torch against the JAX package (CPU),
and the engine surfaces they ride.

Under ``precision="bf16"`` the JAX package's ``Engine.model_fn`` is the
differentiable bf16 logits and ``composite_backward`` is None, so its IG,
SmoothGrad, input x gradient, contrastive and ``attribute_classes`` run
``jax.vjp``; the port's do the same through autograd.  On the golden
tiny config, the same NumPy inputs to both packages (the JAX package's
Pallas kernels in interpret mode):

* ``model_fn`` and ``composite_backward`` as ``repro`` returns them for
  every backend resolution (fxp16 keeps its manual pair), ``model_fn``'s
  logits and input gradient within ``TOL``;
* IG, input x gradient, contrastive and ``attribute_classes`` on the vjp
  and the seed-batched engine, ``fold_batched_gradients`` and SmoothGrad
  on shared noise, within ``TOL`` (2^-6 * max|ref|) of ``repro``'s, their
  relevance f32 as ``repro``'s (the pair's ``attribute_classes`` bf16).

Helpers and the module fixture are ``tests/test_torch_vjp_bf16.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.engine import methods as jmethods
from repro_torch.engine import EngineSpec, build, methods
from tests.test_torch_vjp_bf16 import (BF, KINDS, OP_TOL, TOL,  # noqa: F401
                                       _close, _engines, _models, setup)


@pytest.mark.parametrize("backward", ["auto", "vjp", "seed_batched"])
@pytest.mark.parametrize("kind", KINDS)
def test_model_fn_and_composite_backward_as_repro(setup, kind, backward):
    jparams, params, x = setup
    tm, jm = _models(kind, jparams, params)
    tspec = EngineSpec(tm, precision="bf16", backward=backward)
    jspec = jengine.EngineSpec(jm, precision="bf16", backward=backward)
    assert tspec.resolve_backward() == jspec.resolve_backward()
    if tspec.resolve_backward() == "seed_batched" and not tm.has_pair:
        with pytest.raises(ValueError, match="no seed-batched pair"):
            build(tspec)
        return
    teng, jeng = build(tspec), jengine.build(jspec)
    assert teng.supports_replay == jeng.supports_replay
    assert teng.composite_backward is None and jeng.composite_backward \
        is None
    out = teng.model_fn(torch.from_numpy(x))
    jout = jeng.model_fn(jnp.asarray(x))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
    assert jout.dtype == BF
    _close(out, jout, TOL)
    # differentiable: its input gradient is the f32 one repro's vjp gives
    v = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(teng.model_fn(v)[:, 1].sum(), v)
    _, jback = jax.vjp(jeng.model_fn, jnp.asarray(x))
    (jg,) = jback(jnp.zeros_like(jout).at[:, 1].set(1))
    assert g.dtype == torch.float32 and jg.dtype == jnp.float32
    _close(g, jg, TOL)
    # fxp16 keeps its manual pair (integers have no gradient)
    if kind == "fused" and backward != "vjp":
        fx = build(EngineSpec(tm, precision="fxp16", backward=backward))
        jfx = jengine.build(jengine.EngineSpec(jm, precision="fxp16",
                                               backward=backward))
        assert fx.composite_backward is not None
        assert jfx.composite_backward is not None


@pytest.mark.parametrize("backward", ["vjp", "seed_batched"])
def test_bf16_composites_match_jax_engine(setup, backward):
    x = setup[2]
    teng, jeng = _engines(setup, "fused", method="guided", backward=backward)
    jx = jnp.asarray(x)
    tl, trel = teng.attribute_classes(x, [0, 3])
    jl, jrel = jeng.attribute_classes(jx, jnp.asarray([0, 3]))
    # the seed-batched engine replays its pair (bf16), vjp widens (f32)
    assert str(trel.dtype).split(".")[-1] == str(jrel.dtype)
    _close(tl, jl, TOL)
    _close(trel, jrel, TOL)
    for batched in (True, False):
        tl, tig = teng.ig(x, steps=4, batched=batched)
        jl, jig = jeng.ig(jx, steps=4, batched=batched)
        assert tl.dtype == torch.bfloat16 and tig.dtype == torch.float32
        assert jig.dtype == jnp.float32
        _close(tig, jig, TOL)
    _, tixg = teng.input_x_gradient(x, target=2)
    _, jixg = jeng.input_x_gradient(jx, target=jnp.full((3,), 2))
    assert tixg.dtype == torch.float32 and jixg.dtype == jnp.float32
    _close(tixg, jixg, TOL)
    _, tc = teng.contrastive(x, 1, 3)      # JAX takes per-example targets
    _, jc = jeng.contrastive(jx, jnp.full((3,), 1), jnp.full((3,), 3))
    assert tc.dtype == torch.float32 and jc.dtype == jnp.float32
    _close(tc, jc, TOL)


def test_bf16_smoothgrad_and_fold_match_jax_on_shared_noise(setup):
    x = setup[2]
    teng, jeng = _engines(setup, "fused", method="saliency",
                          backward="auto")
    n, sigma = 3, 0.2
    _, sg = teng.smoothgrad(x, torch.Generator().manual_seed(7), n=n,
                            sigma=sigma)
    assert sg.dtype == torch.float32
    noise = torch.randn((n,) + x.shape, generator=torch.Generator()
                        .manual_seed(7))
    xs = (torch.from_numpy(x) + sigma * noise).numpy().copy()
    target = np.array(jnp.argmax(jeng.predict(jnp.asarray(x)), -1))
    jgrads = jmethods.fold_batched_gradients(
        jeng.model_fn, jnp.asarray(xs), jnp.asarray(target), (3,))
    tgrads = methods.fold_batched_gradients(
        teng.model_fn, torch.from_numpy(xs), torch.from_numpy(target), (3,))
    assert tgrads.dtype == torch.float32 and jgrads.dtype == jnp.float32
    _close(tgrads, jgrads, TOL)
    _close(sg, np.asarray(jgrads).mean(axis=0), TOL)
    _, seq = teng.smoothgrad(x, torch.Generator().manual_seed(7), n=n,
                             sigma=sigma, batched=False)
    _close(seq, sg.numpy(), OP_TOL)
