"""Plans through the port's engine, adapters, LM step and server driver,
against repro's, on the CPU.

* ``EngineSpec(device=...)`` and an explicit ``plan=`` build and explain
  equal to repro's engine with the same spec (f32 within 1e-5 of max
  |logits| / 1e-4 of max |relevance|, fxp16 bitwise), and ``Engine.plan``
  equals repro's entry for entry; the ``h100`` profile (from the H100
  SXM's properties record) explains bitwise as the unplanned engine.
* The fold audit of ``ig(batched=True)``, ``smoothgrad`` and ``perturb``
  keeps the engine, replans or raises exactly where repro's does; a raise
  comes before any kernel wrapper is called.
* ``mesh:<p>:<n>`` with n > 1 builds a data-parallel engine planned at
  the per-shard batch (one rank here: no process group); a bad plan
  raises.
* The LM: ``ssm_scan_tiles(cfg, plan)`` equals repro's for every profile,
  a planned engine's token explain equals the unplanned one bitwise.
* The adapters' ``device=`` / ``autotune=`` and ``launch/serve.py``'s
  ``--device-profile`` / ``--autotune`` / ``--profile-kernels`` reach the
  engine and the drift table; ``python -m repro_torch.obs drift`` reads
  the table back.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.plan as jplan
import repro_torch.configs as configs
from repro import engine as jengine
from repro.launch import steps as jsteps
from repro.models import cnn as jcnn
from repro_torch import engine as tengine
from repro_torch import plan as tplan
from repro_torch.engine import CNNModel, EngineSpec, LMModel, TopK, build
from repro_torch.launch import steps as tsteps
from repro_torch.models import cnn
from repro_torch.models import transformer as tf
from repro_torch.plan import planner as tplanner
from repro_torch.plan.profiles import H100_SXM_PROPERTIES

ROOT = Path(__file__).resolve().parents[1]
H100 = tplan.gpu_profile(H100_SXM_PROPERTIES)
KW = dict(in_hw=(8, 8), channels=(4, 4), fc=(16,))
CFG, JCFG = cnn.CNNConfig(**KW), jcnn.CNNConfig(**KW)
DEVICES = ("detected", "tpu-v4", "edge-small", "edge-tiny",
           "mesh:edge-small:1")
TOL = {"f32": (1e-5, 1e-4)}


@pytest.fixture(scope="module")
def setup():
    jparams = jcnn.init(jax.random.PRNGKey(0), JCFG)
    params = cnn.params_from_jax(jax.tree.map(np.asarray, jparams))
    x = np.random.RandomState(1).randn(3, 8, 8, 3).astype(np.float32)
    tengine.clear_cache()
    yield jparams, params, x
    tengine.clear_cache()


def _tiles(plan):
    return (plan.device, plan.precision,
            [(k, type(t).__name__, dataclasses.astuple(t))
             for k, t in plan.entries])


def _engines(setup, precision, **kw):
    jparams, params, _ = setup
    jkw = dict(kw)
    if isinstance(kw.get("targets"), TopK):
        jkw["targets"] = jengine.TopK(kw["targets"].k)
    jeng = jengine.build(jengine.EngineSpec(
        model=jengine.CNNModel(jparams, JCFG), precision=precision, **jkw))
    teng = build(EngineSpec(model=CNNModel(params, CFG, device="cpu"),
                            precision=precision, **kw))
    return jeng, teng


def _close(got, want, rtol):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("precision", ["f32", "fxp16"])
@pytest.mark.parametrize("device", DEVICES)
def test_planned_engine_matches_repro(setup, device, precision):
    # repro's mesh engine fails under this JAX (ROADMAP C): its one-shard
    # mesh is held bitwise to its core there, so the numbers come from the
    # core's engine and the plan from repro's planner
    core = device.split(":")[1] if device.startswith("mesh:") else device
    jeng, teng = _engines(setup, precision, method="guided",
                          targets=TopK(2), batch=3, device=device)
    if core != device:
        jeng = _engines(setup, precision, method="guided", targets=TopK(2),
                        batch=3, device=core)[0]
    assert _tiles(teng.plan) == _tiles(jplan.plan_cnn(
        JCFG, device, precision, batch=3, seeds=2))
    x = setup[2]
    jl, jr = jeng.explain(jnp.asarray(x))
    tl, tr = teng.explain(x)
    if precision == "fxp16":
        assert np.array_equal(tl.numpy(), np.asarray(jl))
        assert np.array_equal(tr.numpy(), np.asarray(jr))
    else:
        _close(tl, jl, TOL["f32"][0])
        _close(tr, jr, TOL["f32"][1])
    # an explicit plan builds the same engine's numbers
    explicit = build(dataclasses.replace(teng.spec, device=None,
                                         plan=teng.plan))
    assert explicit.plan is teng.plan
    el, er = explicit.explain(x)
    assert torch.equal(el, tl) and torch.equal(er, tr)


@pytest.mark.parametrize("precision", ["f32", "bf16", "fxp16"])
def test_h100_plan_is_bitwise_the_unplanned_engine(setup, precision):
    _, params, x = setup
    base = build(EngineSpec(model=CNNModel(params, CFG, device="cpu"),
                            precision=precision, targets=TopK(2), batch=3))
    eng = build(dataclasses.replace(base.spec, device=H100))
    assert eng.plan.device == "h100" and len(eng.plan.shapes) == 8
    for a, b in zip(eng.explain(x), base.explain(x)):
        assert torch.equal(a, b)
    assert torch.equal(eng.perturb(x, 3, method="rise", n_samples=4,
                                   grid=3)[1],
                       base.perturb(x, 3, method="rise", n_samples=4,
                                    grid=3)[1])


def test_plan_knob_validation(setup):
    _, params, _ = setup
    model = CNNModel(params, CFG, device="cpu")
    eng = build(EngineSpec(model=model, device="mesh:edge-small:4",
                           batch=8))
    assert eng.n_shards == 4
    assert eng.plan.device == "mesh:edge-small:4"
    assert eng.plan.entries == tplan.plan_cnn(CFG, "edge-small",
                                              batch=2).entries
    with pytest.raises(ValueError, match="unknown device profile"):
        EngineSpec(model=model, device="edge-nonexistent")
    with pytest.raises(TypeError, match="TilePlan"):
        EngineSpec(model=model, plan=object())
    assert build(EngineSpec(model=model)).plan is None
    assert build(EngineSpec(model=model, device="edge-small")).plan.device \
        == "edge-small"


def _fold_kind(eng, factor, x, infeasible):
    try:
        sib = eng._engine_for_fold(factor, x)
    except infeasible:
        return ("raise",)
    return ("self",) if sib is eng else ("replan", _tiles(sib.plan))


FOLD_CASES = [  # (device, batch, factor)
    ("edge-small", 3, 16), ("edge-small", 3, 256), ("edge-tiny", 3, 16),
    ("edge-tiny", 3, 256), ("edge-tiny", 1, 4096), ("tpu-v4", 3, 256),
    ("detected", 3, 8), ("edge-small", 64, 2), ("edge-tiny", 3, 1),
    ("edge-small", 8, 64), ("edge-small", 2, 256)]
#: FC0 of 1,024 inputs: its backward's column tile can shrink at a fold
FOLD_KW = dict(in_hw=(16, 16), channels=(8, 16), fc=(64,))


@pytest.mark.parametrize("precision", ["f32", "fxp16"])
def test_fold_audit_matches_repro(precision):
    kinds = set()
    jcfg, cfg = jcnn.CNNConfig(**FOLD_KW), cnn.CNNConfig(**FOLD_KW)
    jparams = jcnn.init(jax.random.PRNGKey(0), jcfg)
    params = cnn.params_from_jax(jax.tree.map(np.asarray, jparams))
    for device, batch, factor in FOLD_CASES:
        jeng = jengine.build(jengine.EngineSpec(
            model=jengine.CNNModel(jparams, jcfg), precision=precision,
            device=device))
        teng = build(EngineSpec(model=CNNModel(params, cfg, device="cpu"),
                                precision=precision, device=device))
        x = np.zeros((batch, 16, 16, 3), np.float32)
        want = _fold_kind(jeng, factor, jnp.asarray(x),
                          jplan.InfeasiblePlanError)
        got = _fold_kind(teng, factor, torch.from_numpy(x),
                         tplan.InfeasiblePlanError)
        assert got == want, (device, batch, factor)
        kinds.add(got[0])
    assert kinds == {"self", "replan", "raise"}


@pytest.mark.parametrize("op", ["ig", "smoothgrad", "perturb"])
def test_infeasible_fold_raises_before_any_launch(setup, monkeypatch, op):
    _, params, _ = setup
    eng = build(EngineSpec(model=CNNModel(params, CFG, device="cpu"),
                           device="edge-tiny",
                           method="rise" if op == "perturb"
                           else "saliency"))
    calls = []
    k = dict(cnn._KERNELS["f32"])
    for name, fn in list(k.items()):
        k[name] = (lambda *a, _n=name, _f=fn, **kw:
                   calls.append(_n) or _f(*a, **kw))
    monkeypatch.setitem(cnn._KERNELS, "f32", k)
    x = np.zeros((16, 8, 8, 3), np.float32)
    with pytest.raises(tplan.InfeasiblePlanError):
        if op == "ig":
            eng.ig(x, steps=512)
        elif op == "smoothgrad":
            eng.smoothgrad(x, torch.Generator().manual_seed(0), n=512)
        else:
            eng.perturb(x, 3, n_samples=512)
    assert calls == []
    # a fold that fits runs (and launches) as before
    small = np.zeros((1, 8, 8, 3), np.float32)
    eng.ig(small, steps=2) if op == "ig" else (
        eng.smoothgrad(small, torch.Generator().manual_seed(0), n=2)
        if op == "smoothgrad" else eng.perturb(small, 3, n_samples=2))
    assert calls


# -- the LM -------------------------------------------------------------------


@pytest.mark.parametrize("device", DEVICES + ("h100",))
def test_ssm_scan_tiles_match_repro(device):
    cfg, jcfg = configs.get_smoke("falcon-mamba-7b"), jconfigs.get_smoke(
        "falcon-mamba-7b")
    prof = H100 if device == "h100" else device
    for batch, seq in ((1, tplan.LM_PLAN_SEQ), (2, 16)):
        plan = tplan.plan_lm(cfg, prof, batch=batch, seq=seq)
        got = tsteps.ssm_scan_tiles(cfg, plan)
        if device == "h100":
            assert got == tsteps.ssm_scan_tiles(cfg)
            continue
        want = jsteps.ssm_scan_tiles(jcfg, jplan.plan_lm(jcfg, device,
                                                         batch=batch,
                                                         seq=seq))
        assert got == want
    assert tsteps.ssm_scan_tiles(cfg) == jsteps.ssm_scan_tiles(jcfg)


@pytest.mark.parametrize("device", ["edge-small", "h100"])
def test_planned_lm_engine_explains_as_unplanned(device):
    cfg = configs.get_smoke("falcon-mamba-7b")
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    prof = H100 if device == "h100" else device
    model = LMModel(params, cfg, device="cpu")
    planned = build(EngineSpec(model=model, device=prof, batch=2))
    assert planned.plan is not None and planned.plan.keys()
    tiles = tsteps.ssm_scan_tiles(cfg, planned.plan)
    want_plan = tplan.plan_lm(cfg, prof, batch=2)
    assert planned.plan == want_plan
    base = build(EngineSpec(model=model, batch=2))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    for mode in ("ixg", "contrastive"):
        a = planned.explain_tokens({"tokens": toks}, mode=mode)
        b = base.explain_tokens({"tokens": toks}, mode=mode)
        assert all(torch.equal(u, v) for u, v in zip(a, b)), (mode, tiles)


# -- adapters and the driver --------------------------------------------------


def test_adapters_thread_the_planner_knobs(setup, monkeypatch, tmp_path):
    from repro_torch import lm
    from repro_torch.engine import spec as spec_mod
    from repro_torch.serve import adapters
    real = spec_mod.resolve_device
    monkeypatch.setattr(spec_mod, "resolve_device",
                        lambda d: real("cpu" if d is None else d))
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "c.json"))
    calls = []
    monkeypatch.setattr(tplanner, "measure_kernel",
                        lambda *a: calls.append(a) or 1.0)
    _, params, _ = setup
    ad = adapters.CNNAdapter(params, CFG, device="edge-small",
                             autotune=True)
    assert ad.engine.spec.device == "edge-small" and ad.engine.spec.autotune
    assert ad.engine.plan.device == "edge-small" and calls
    assert ad.engine_for("guided").plan == ad.engine.plan
    assert ad.with_precision("fxp16").engine.spec.device == "edge-small"
    cfg = configs.get_smoke("falcon-mamba-7b")
    lp = tf.init(cfg, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    lad = lm.LMAdapter(lp, cfg, device="edge-small")
    assert lad.engine.plan == tplan.plan_lm(cfg, "edge-small")
    # an LM on a mesh device builds unsharded, planned per shard
    lmesh = lm.LMAdapter(lp, cfg, device="mesh:edge-small:2")
    assert lmesh.n_shards == 1 and lmesh.engine.mesh is None
    assert lmesh.engine.plan == tplan.plan_lm(cfg, "mesh:edge-small:2")


def _driver(tmp_path, *args):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path),
           "REPRO_TORCH_PLAN_CACHE": str(tmp_path / "tiles.json")}
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)


def test_driver_device_profile_reaches_the_engine(tmp_path):
    r = _driver(tmp_path, "-m", "repro_torch.launch.serve", "--workload",
                "cnn", "--torch-device", "cpu", "--requests", "2",
                "--device-profile", "edge-small")
    assert r.returncode == 0, r.stderr
    assert "planned tiles for device profile 'edge-small'" in r.stdout
    assert "conv0.fwd    ConvTile(co_tile=32)" in r.stdout
    r = _driver(tmp_path, "-m", "repro_torch.launch.serve", "--workload",
                "lm", "--arch", "falcon-mamba-7b", "--torch-device", "cpu",
                "--prompt-len", "8", "--max-new", "1", "--requests", "1",
                "--method", "token_ixg", "--device-profile", "tpu-v4")
    assert r.returncode == 0, r.stderr
    assert "planned ssm_scan tiles for device profile 'tpu-v4'" in r.stdout


def test_driver_autotune_measures_through_the_cache(tmp_path, monkeypatch):
    from repro_torch.launch import serve as driver
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "t.json"))
    calls = []
    monkeypatch.setattr(tplanner, "measure_kernel",
                        lambda *a: calls.append(a) or 1.0)
    tengine.clear_cache()
    driver.main(["--workload", "cnn", "--torch-device", "cpu",
                 "--requests", "2", "--device-profile", "edge-small",
                 "--autotune"])
    stored = json.loads((tmp_path / "t.json").read_text())
    assert calls and len(stored) == 12
    assert all(e["measured_us"] == 1.0 for e in stored.values())


def test_driver_profile_kernels_writes_the_drift_table(tmp_path):
    out = tmp_path / "drift.json"
    r = _driver(tmp_path, "-m", "repro_torch.launch.serve", "--workload",
                "cnn", "--torch-device", "cpu", "--requests", "2",
                "--profile-kernels", "--drift-out", str(out))
    assert r.returncode == 0, r.stderr
    assert "cost-model drift (detected, f32" in r.stdout
    rows = json.loads(out.read_text())["rows"]
    assert [row["key"] for row in rows] == [
        k for k, _, _ in tplan.cnn_kernel_shapes(cnn.CNNConfig())]
    back = _driver(tmp_path, "-m", "repro_torch.obs", "drift", "--path",
                   str(out))
    assert back.returncode == 0 and back.stdout.splitlines()[2].startswith(
        "conv0.fwd")
    missing = _driver(tmp_path, "-m", "repro_torch.obs", "drift", "--path",
                      str(tmp_path / "none.json"))
    assert missing.returncode == 1 and "no drift table" in missing.stderr
