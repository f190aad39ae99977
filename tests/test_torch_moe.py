"""The port's MoE (``repro_torch.models.moe``) against ``repro.models.moe``
(CPU), on NumPy inputs from a seed, at the SMOKE configs of
llama4-scout-17b-a16e (top-1 of 4, a shared expert) and
moonshot-v1-16b-a3b (top-2 of 8, a shared expert).

* At the SMOKE capacity factor 1.25, on inputs where no expert overflows
  (asserted): outputs within 1e-6 of max and the load-balancing loss
  within 1e-6 of ``repro``'s own ``moe_ffn``; in bf16 within 1e-2 of
  ``first_c_moe_ffn`` run one primitive at a time (``repro``'s bf16
  expert einsums do not run on XLA's CPU backend: ``tests/_torch_zoo.py``).
* Gradients of ``sum(y^2) + aux`` with respect to the router, every
  expert matrix, the shared expert and the input within 1e-5 of max of
  ``jax.grad``'s.  Under top-1 (scout) the renormalized gate is g / g = 1,
  whose router gradient is 0 in exact arithmetic and each package's
  rounding noise in floats (2e-2 of max apart); there the router is held
  on the load-balancing loss alone.
* Overflow (capacity factor 0.25, 32 tokens): the port keeps each
  expert's first C assignments in the stable sort by expert id, held to a
  float64 NumPy version of that rule (1e-5) and to ``first_c_moe_ffn``
  (1e-6); ``repro`` differs exactly at tokens its duplicate scatter drops
  from slot 0 of an overflowing expert (ROADMAP C).
* Ties: equal router probabilities pick the lower expert ids first, as
  ``lax.top_k``; the dispatch keeps each expert's tokens in token order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from _torch_zoo import first_c_moe_ffn
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_map

ARCHS = ("llama4-scout-17b-a16e", "moonshot-v1-16b-a3b")


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _err(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _setup(arch, dtype="float32", **kw):
    jcfg = jconfigs.get_smoke(arch).with_(dtype=dtype, **kw)
    cfg = configs.get_smoke(arch).with_(dtype=dtype, **kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    p = tf.params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, cfg, jp, p


def _x(seed, shape, dtype="float32"):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _counts(p, cfg, tx):
    xt = tx.reshape(-1, cfg.d_model)
    ids = moe.route(p, xt, cfg)[1]
    return torch.bincount(ids.reshape(-1), minlength=cfg.n_experts), \
        moe._capacity(xt.shape[0], cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_repro_without_overflow(arch):
    jcfg, cfg, jp, p = _setup(arch)
    jx, tx = _x(0, (2, 12, cfg.d_model))
    counts, c = _counts(p, cfg, tx)
    assert int(counts.max()) <= c                 # the premise
    want, jaux = jmoe.moe_ffn(jp, jx, jcfg)
    got, aux = moe.moe_ffn(p, tx, cfg)
    assert _err(got, want) <= 1e-6
    assert abs(float(aux) - float(jaux)) <= 1e-6 * float(jaux)
    # the shared expert is in it: without it the outputs differ
    bare = moe.moe_ffn(p, tx, cfg.with_(n_shared_experts=0))[0]
    assert _err(got - bare, moe.layers.ffn(p["shared"], tx, cfg)) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_moe_matches_the_reference(arch):
    jcfg, cfg, jp, p = _setup(arch, "bfloat16")
    jx, tx = _x(0, (2, 12, cfg.d_model), "bfloat16")
    with jax.disable_jit():
        want, jaux = first_c_moe_ffn(jp, jx, jcfg)
    got, aux = moe.moe_ffn(p, tx, cfg)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) <= 1e-2
    assert abs(float(aux) - float(jaux)) <= 1e-6 * float(jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_jax_grad(arch):
    jcfg, cfg, jp, p = _setup(arch)
    jx, tx = _x(1, (1, 16, cfg.d_model))
    counts, c = _counts(p, cfg, tx)
    assert int(counts.max()) <= c

    def jloss(pp, xx):
        y, aux = jmoe.moe_ffn(pp, xx, jcfg)
        return jnp.sum(y ** 2) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = tree_map(lambda t: t.requires_grad_(), p)
    tx.requires_grad_()
    y, aux = moe.moe_ffn(leaves, tx, cfg)
    ((y ** 2).sum() + aux).backward()
    assert _err(tx.grad, jgx) <= 1e-5
    flat_j = jax.tree_util.tree_leaves_with_path(jgp)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        leaves, is_leaf=lambda v: isinstance(v, torch.Tensor)))
    assert len(flat_j) == len(flat_t) >= 5
    for path, g in flat_j:
        if cfg.top_k == 1 and path[0].key == "router":
            continue
        assert _err(flat_t[path].grad, g) <= 1e-5, path
    if cfg.top_k == 1:
        jg = jax.grad(lambda r: jmoe.moe_ffn(dict(jp, router=r), jx,
                                             jcfg)[1])(jp["router"])
        router = p["router"].detach().requires_grad_()
        moe.moe_ffn(dict(p, router=router), tx.detach(), cfg)[1].backward()
        assert _err(router.grad, jg) <= 1e-5


def _first_c_numpy(p, x, cfg):
    """The first-C rule in float64: route, sort the assignments stably by
    expert, keep each expert's first C, run each kept (token, expert) pair
    through its expert scaled by its gate."""
    f = {k: np.asarray(_np(v), np.float64) for k, v in p.items()
         if k != "shared"}
    xt = np.asarray(_np(x), np.float64).reshape(-1, cfg.d_model)
    t, k, e = xt.shape[0], cfg.top_k, cfg.n_experts
    c = moe._capacity(t, cfg)
    logits = xt @ f["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    gates = np.take_along_axis(probs, ids, -1)
    gates /= gates.sum(-1, keepdims=True)
    out = np.zeros_like(xt)
    seen = np.zeros(e, int)
    dropped = []
    for a in np.argsort(ids.reshape(-1), kind="stable"):
        tok, ex = divmod(int(a), k)[0], int(ids.reshape(-1)[a])
        if seen[ex] >= c:
            dropped.append((tok, ex))
            continue
        seen[ex] += 1
        h = xt[tok] @ f["w1"][ex]
        h = h / (1 + np.exp(-h)) * (xt[tok] @ f["w3"][ex])
        out[tok] += gates[tok, list(ids[tok]).index(ex)] * (h @ f["w2"][ex])
    return out.reshape(x.shape), dropped


def test_overflow_keeps_the_first_c_assignments():
    """moonshot SMOKE at capacity factor 0.25 over 32 tokens: C = 8 slots
    an expert for 64 assignments, so experts overflow."""
    arch = "moonshot-v1-16b-a3b"
    jcfg, cfg, jp, p = _setup(arch, capacity_factor=0.25,
                              n_shared_experts=0)
    jx, tx = _x(2, (1, 32, cfg.d_model))
    counts, c = _counts(p, cfg, tx)
    over = [e for e in range(cfg.n_experts) if int(counts[e]) > c]
    assert over                                   # experts overflow
    got, _ = moe.moe_ffn(p, tx, cfg)
    want, dropped = _first_c_numpy(p, tx, cfg)
    assert dropped
    assert _err(got, want) <= 1e-5
    assert _err(got, first_c_moe_ffn(jp, jx, jcfg)[0]) <= 1e-6
    # repro writes every dropped assignment to its expert's slot 0; the
    # token that slot kept loses that expert's output there
    ref = _np(jmoe.moe_ffn(jp, jx, jcfg)[0])[0]
    diff = np.abs(ref - _np(got)[0]).max(axis=-1) > 1e-5 * np.abs(ref).max()
    xt = tx.reshape(-1, cfg.d_model)
    ids = moe.route(p, xt, cfg)[1]
    tok, _, _ = moe.dispatch(ids, cfg, c)
    slot0 = {int(tok[e * c]) for e in over}
    assert diff.any() and set(np.nonzero(diff)[0]) <= slot0


def test_ties_pick_the_lower_expert_and_keep_token_order():
    arch = "moonshot-v1-16b-a3b"
    jcfg, cfg, jp, p = _setup(arch)
    p = dict(p, router=torch.zeros_like(p["router"]))   # all probs equal
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    jx, tx = _x(3, (1, 6, cfg.d_model))
    gates, ids, _ = moe.route(p, tx.reshape(6, -1), cfg)
    probs = jax.nn.softmax(jnp.zeros((6, cfg.n_experts)), axis=-1)
    want = jax.lax.top_k(probs, cfg.top_k)[1]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    assert ids.tolist() == [[0, 1]] * 6
    assert torch.equal(gates, torch.full((6, 2), 0.5))
    tok, assign, slots = moe.dispatch(ids, cfg, 8)
    assert tok[:6].tolist() == list(range(6)) and tok[6:8].tolist() == [6, 6]
    assert tok[8:14].tolist() == list(range(6))
    assert slots.tolist() == [[i, 8 + i] for i in range(6)]
    assert assign[:6].tolist() == [0, 2, 4, 6, 8, 10]
    got, _ = moe.moe_ffn(p, tx, cfg)
    assert _err(got, jmoe.moe_ffn(jp, jx, jcfg)[0]) <= 1e-6
    again, _ = moe.moe_ffn(p, tx, cfg)
    assert torch.equal(got, again)
