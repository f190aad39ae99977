"""Shared set-up of the training parity tests (``tests/test_torch_train*``):
one SMOKE config's ``TrainState`` in both packages (``repro``'s drawn, the
port's ``state_from_jax`` of it), NumPy batches (tokens and labels, plus a
vlm's patches and an encoder-decoder's frames), and the comparisons.

Tolerances (f32):
* metrics (``loss``, ``ce``, ``gnorm``, ``lr``) within 1e-5 relative;
* mu and nu within 1e-5 of each leaf's max |reference|, after every step;
* params: each package's new params are AdamW's update of its previous
  params by its own new mu and nu at its own lr, ``p - lr (m̂ / (√v̂ + ε)
  + wd p)`` recomputed here in float64 (:func:`check_update`), within
  1e-5 of each element's step ``lr (|m̂ / (√v̂ + ε)| + wd |p|)`` plus one
  f32 rounding of the result.  Holding ``repro``'s states to the same
  rule shows that the rule is ``repro``'s.  The params are not compared
  across the packages element by element: where a gradient element sits
  near 0, Adam's normalised step is ill-conditioned (it is ±1 there, and
  one rounding of the gradient flips its sign), so two correct
  implementations differ by up to 2 lr there.  The moments, which are
  well conditioned, carry the comparison.

The MoE reference is ``repro``'s transformer on ``first_c_moe_ffn``
(``tests/_torch_zoo.py``): the SMOKE MoE configs overflow their capacity,
where ``repro``'s MoE drops a kept token (ROADMAP C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
from repro.launch import steps as jsteps
from repro_torch import configs
from repro_torch.launch import steps

from _torch_zoo import reference

B, S, SRC = 4, 8, 6
STEP_KW = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
TOL = 1e-5


def npf(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def batches(cfg, n, seed=0):
    """``n`` NumPy batches of ``B`` rows: tokens, labels (the next
    tokens) and the config's extra inputs."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rs.randint(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend == "patches":
            b["patches"] = rs.randn(B, cfg.n_patches,
                                    cfg.d_model).astype(np.float32)
        if cfg.enc_layers:
            b["frames"] = rs.randn(B, SRC, cfg.d_model).astype(np.float32)
        out.append(b)
    return out


def flat(tree, prefix=""):
    """``{path: leaf}`` of a dict / list tree of either package."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def run_both(arch, n_steps, microbatches=1, dtype="float32"):
    """``n_steps`` train steps of each package from the same state on the
    same batches.  Returns ``(init_np, [(ref_state_np, ref_metrics,
    state, metrics)] per step)``."""
    jcfg = jconfigs.get_smoke(arch).with_(dtype=dtype)
    cfg = configs.get_smoke(arch).with_(dtype=dtype)
    js = jsteps.make_train_state_init(jcfg)(jax.random.PRNGKey(0))
    init_np = jax.tree.map(np.asarray, js)
    ts = steps.state_from_jax(init_np)
    jstep = jsteps.make_train_step(jcfg, microbatches=microbatches,
                                   **STEP_KW)
    tstep = steps.make_train_step(cfg, microbatches=microbatches, **STEP_KW)
    bf16 = dtype == "bfloat16"
    out = []
    # bf16: the reference op by op (``reference`` disables jit: compiled,
    # XLA rounds fused bf16 chains less often)
    with reference(dtype):
        jfn = jstep if bf16 else jax.jit(jstep)
        for b in batches(cfg, n_steps):
            js, jm = jfn(js, {k: jnp.asarray(v) for k, v in b.items()})
            ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
            out.append((jax.tree.map(np.asarray, js),
                        {k: float(v) for k, v in jm.items()}, ts,
                        {k: float(v) for k, v in tm.items()}))
    return init_np, out


def check_metrics(jm, tm, tol=TOL):
    assert jm.keys() == tm.keys() == {"loss", "ce", "gnorm", "lr"}
    for k in jm:
        assert abs(tm[k] - jm[k]) <= tol * max(abs(jm[k]), 1e-30), (
            k, tm[k], jm[k])


def check_moments(jstate, tstate, tol=TOL, nu_root=False):
    """mu and nu within ``tol`` of each leaf's max |reference|; with
    ``nu_root``, √nu within ``tol`` of each leaf's max √nu."""
    assert int(tstate.opt.step) == int(jstate.opt.step)
    assert tstate.opt.step.dtype == torch.int32
    for name in ("mu", "nu"):
        jf = flat(getattr(jstate.opt, name))
        tf_ = flat(getattr(tstate.opt, name))
        assert jf.keys() == tf_.keys()
        for k in jf:
            want, got = npf(jf[k]), npf(tf_[k])
            assert tf_[k].dtype == torch.float32
            if name == "nu" and nu_root:
                want, got = np.sqrt(want), np.sqrt(got)
            scale = max(np.abs(want).max(), 1e-30)
            err = np.abs(got - want).max() / scale
            assert err <= tol, (name, k, err)


#: ``optim.adamw_update``'s defaults, as the train steps of both packages
#: call it
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1


def check_update(prev_params, state, lr, tol=TOL):
    """``state.params`` is AdamW's update of ``prev_params`` by
    ``state``'s own mu and nu at ``lr`` (either package's tree): the rule
    of the module docstring, elementwise."""
    t = int(state.opt.step)
    bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
    p0, p1 = flat(prev_params), flat(state.params)
    mu, nu = flat(state.opt.mu), flat(state.opt.nu)
    assert p0.keys() == p1.keys() == mu.keys() == nu.keys()
    for k in p0:
        p = npf(p0[k]).astype(np.float64)
        m, v = npf(mu[k]).astype(np.float64), npf(nu[k]).astype(np.float64)
        delta = (m / bc1) / (np.sqrt(v / bc2) + EPS)
        wd = WD if p.ndim >= 2 else 0.0
        want = p - lr * (delta + wd * p)
        got = npf(p1[k]).astype(np.float64)
        bound = tol * lr * (np.abs(delta) + wd * np.abs(p)) + np.spacing(
            np.abs(want).astype(np.float32)).astype(np.float64)
        err = np.abs(got - want)
        assert (err <= bound).all(), (k, float((err / bound).max()))


def check_run(init_np, out):
    """Every step: the metrics, the moments, and each package's update
    rule from its previous params."""
    prev_j = prev_t = init_np.params
    for js, jm, ts, tm in out:
        check_metrics(jm, tm)
        check_moments(js, ts)
        check_update(prev_j, js, jm["lr"])
        check_update(prev_t, ts, tm["lr"])
        prev_j, prev_t = js.params, ts.params
