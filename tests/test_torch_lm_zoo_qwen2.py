"""qwen2-1.5b SMOKE (a dense stack with QKV bias) against the JAX package
(CPU), in f32 (bf16: ``tests/test_torch_lm_zoo_qwen2_bf16.py``): the zoo
tests of ``tests/_torch_zoo.py``, then an
``LMAdapter`` server against ``repro.lm.LMAdapter``'s on the same
requests (f32), and the token methods' manual-engine ``backward=`` on a
toy pair against ``repro.engine.methods``'.

Tolerances, relative to the reference's max |value|: logits 1e-5, scores
1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from _torch_zoo import (  # noqa: F401
    Zoo, close, jax_grid, test_attribute_step_matches,
    test_engine_explain_tokens, test_explain_generated_causal_zeros,
    test_forward_logits_match, test_greedy_decode_tokens_match,
    test_params_from_jax_and_init, test_prefill_and_decode_step_match)
from repro import lm as jlm
from repro.engine import methods as jmethods
import repro_torch.serve as tserve
from repro_torch import lm
from repro_torch.engine import EngineSpec, LMModel, build, methods
from repro_torch.models import transformer as tf

ARCH = "qwen2-1.5b"


@pytest.fixture(scope="module")
def zoo():
    return Zoo(ARCH, "float32")


@pytest.fixture(scope="module")
def grid(zoo):
    return jax_grid(zoo)


def _stream(srv, reqs):
    out = []
    for r in reqs:
        srv.submit(r)
        out += srv.poll()
    return out + srv.drain()


def test_lm_adapter_server_matches_reference(zoo):
    """Predicts and token explains (ixg, contrastive) through both
    servers; the port's predict is ``forward``'s last position bitwise and
    its explain ``Engine.explain_tokens`` on the padded batch."""
    z = zoo
    rng = np.random.RandomState(3)
    toks = [rng.randint(0, z.cfg.vocab, size=(s,)).astype(np.int32)
            for s in (8, 8, 8, 16)]
    ad = lm.LMAdapter.from_engine(build(EngineSpec(LMModel(z.p, z.cfg,
                                                           device="cpu"))))
    out = {}
    for name, pkg, adapter in (("ref", jserve, jlm.LMAdapter(z.jp, z.jcfg)),
                               ("port", tserve, ad)):
        reqs = []
        for i, t in enumerate(toks):
            reqs.append(pkg.Request(uid=f"q{i}", kind="predict", x=t))
            reqs.append(pkg.Request(uid=f"q{i}", kind="explain", x=t,
                                    method=("token_ixg", "token_contrastive")
                                    [i % 2]))
        srv = pkg.ExplanationServer(adapter, max_batch=4, max_delay_s=0.0)
        out[name] = _stream(srv, reqs)
    want, got = out["ref"], out["port"]
    assert len(got) == len(want) == 8
    for a, b in zip(want, got):
        assert (b.uid, b.kind, b.method, b.ok, b.targets, b.batch_size) == (
            a.uid, a.kind, a.method, a.ok, a.targets, a.batch_size)
        close(b.logits, a.logits, 1e-5)
        if a.kind == "explain":
            close(b.relevance, a.relevance, 1e-4)
    xb = torch.from_numpy(np.stack(toks[:3]))
    logits, res = ad.predict(xb)
    with torch.no_grad():
        assert res is None and torch.equal(
            logits, tf.forward(z.p, z.cfg, {"tokens": xb.long()})[0][:, -1])
    eng_logits, eng_scores = ad.engine.explain_tokens({"tokens": xb})
    srv = tserve.ExplanationServer(ad, max_batch=3, max_delay_s=0.0)
    resp = _stream(srv, [tserve.Request(uid=f"e{i}", kind="explain",
                                        x=toks[i], method="token_ixg")
                         for i in range(3)])
    for i, r in enumerate(resp):
        np.testing.assert_array_equal(np.asarray(r.relevance),
                                      eng_scores[i].numpy())


def test_token_methods_take_a_manual_backward():
    """``attribute_tokens`` / ``attribute_tokens_contrastive`` with
    ``backward=``: ``f`` returns ``(logits, residuals)`` and the seed at
    ``position`` replays through ``backward``, as in ``repro``; on a
    linear toy pair the replay equals autograd."""
    rng = np.random.RandomState(0)
    w = rng.randn(6, 9).astype(np.float32)
    e = rng.randn(2, 5, 6).astype(np.float32)

    def pair(mod, asarray, mm):
        wt = asarray(w)
        return (lambda x: (mm(x, wt), wt),
                lambda wr, seeds: mm(seeds, wr.T))

    jf, jb = pair(jnp, jnp.asarray, jnp.matmul)
    tf_, tb = pair(torch, torch.from_numpy, torch.matmul)
    for pos in (-1, 2):
        jl, jrel, js = jmethods.attribute_tokens(jf, jnp.asarray(e),
                                                 position=pos, backward=jb)
        tl, trel, ts = methods.attribute_tokens(tf_, torch.from_numpy(e),
                                                position=pos, backward=tb)
        for a, b in ((tl, jl), (trel, jrel), (ts, js)):
            close(a, b, 1e-6)
        _, crel, cs = methods.attribute_tokens_contrastive(
            tf_, torch.from_numpy(e), position=pos, backward=tb)
        _, jcrel, jcs = jmethods.attribute_tokens_contrastive(
            jf, jnp.asarray(e), position=pos, backward=jb)
        close(crel, jcrel, 1e-6)
        close(cs, jcs, 1e-6)
        auto = methods.attribute_tokens_contrastive(
            lambda x: x @ torch.from_numpy(w), torch.from_numpy(e),
            position=pos)
        close(crel, auto[1], 1e-6)

