"""repro_torch.obs.profile and ``python -m repro_torch.obs`` against
repro.obs.profile and ``python -m repro.obs``, on the CPU.

* Shape signatures: equal to the reference's on the same shapes, keyword
  order included (the keys the tile planner will join on).
* The disabled path calls straight through (nothing recorded, the
  histogram untouched); an enabled call records count / mean / min / max
  on the injected clock and one ``kernel_launch_seconds`` observation
  labelled (family, shape, precision).
* The seed-batched pair profiled eagerly in both packages records the same
  (family, shape, precision) keys with the same counts; the perturbation
  fold records its families at the folded batch.
* The CLI: ``trace`` writes the reference's trace byte for byte on the same
  seed and passes ``validate``; ``metrics`` prints the catalog (the
  reference's CLI prints an empty registry, as it never imports its
  catalog: ROADMAP C); ``drift`` prints a persisted drift table (exit 1
  where there is none); the driver's ``--profile-kernels`` prints the
  aggregates and the drift table.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro.obs import metrics as jmetrics
from repro.obs import profile as jprofile
from repro_torch import obs
from repro_torch.engine import CNNModel, EngineSpec, build
from repro_torch.kernels.conv2d.conv2d import conv2d, conv2d_bwd_fused
from repro_torch.kernels.pool.pool import maxpool_fwd, relu_pool_fwd
from repro_torch.kernels.vmm.vmm import vmm, vmm_bwd_fused
from repro_torch.models import cnn
from repro_torch.obs import metrics
from repro_torch.obs import profile

ROOT = Path(__file__).resolve().parents[1]
KW = dict(in_hw=(8, 8), channels=(4, 4), fc=(16,))
CFG, JCFG = cnn.CNNConfig(**KW), jcnn.CNNConfig(**KW)


@pytest.fixture(autouse=True)
def no_profiler():
    profile.disable()
    yield
    profile.disable()


# (family, positional shapes, kwargs) on the wrappers' argument layout
SIG_CASES = [
    ("conv2d_fwd", [(2, 8, 8, 3), (3, 3, 3, 4)], {}),
    ("conv2d_fwd", [(5, 32, 16, 32), (5, 5, 32, 64)], {}),
    ("conv2d_bwd", [(3, 2, 4, 4, 8), (3, 3, 8, 4)],
     dict(pool_idx=(2, 4, 4, 2), relu_mask=(2, 8, 8, 1))),
    ("conv2d_bwd", [(2, 8, 8, 4), (3, 3, 4, 3)], dict(gate=True)),
    ("conv2d_bwd", [(2, 8, 8, 4), (3, 3, 4, 3)], dict(gate=False)),
    ("vmm_fwd", [(32, 4096), (4096, 128)], {}),
    ("vmm_bwd", [(3, 32, 10), (10, 128)], dict(relu_mask=(32, 2))),
    ("vmm_bwd", [(32, 128), (128, 4096)], {}),
    ("pool", [(2, 8, 8, 4)], {}),
    ("pool", [(7, 16, 6, 13)], {}),
]


@pytest.mark.parametrize("family,shapes,kw", SIG_CASES)
def test_signatures_equal_the_reference_in_key_order(family, shapes, kw):
    targs = [torch.zeros(s) for s in shapes]
    jargs = [jnp.zeros(s) for s in shapes]
    tkw = {k: (torch.zeros(v, dtype=torch.uint8) if isinstance(v, tuple)
               else v) for k, v in kw.items()}
    jkw = {k: (jnp.zeros(v, jnp.uint8) if isinstance(v, tuple) else v)
           for k, v in kw.items()}
    got = profile._SIG_FNS[family](targs, tkw)
    want = jprofile._SIG_FNS[family](jargs, jkw)
    assert list(got.items()) == list(want.items())
    assert list(profile._SIG_FNS) == list(jprofile._SIG_FNS)


def test_precision_labels():
    for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16"),
                         (torch.int16, "fxp16")):
        assert profile._precision_of(torch.zeros(1, dtype=dtype)) == label
    for dtype, label in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16"),
                         (jnp.int16, "fxp16")):
        assert jprofile._precision_of(jnp.zeros(1, dtype)) == label


def _kernel_series():
    return {tuple(sorted(s["labels"].items())): s["count"]
            for s in metrics.KERNEL_SECONDS.snapshot()}


def test_disabled_path_calls_straight_through():
    x = torch.randn(2, 8, 8, 4)
    before = _kernel_series()
    assert not profile.enabled() and profile.profiler() is None
    y, idx = maxpool_fwd(x)
    assert maxpool_fwd.__wrapped__ is not maxpool_fwd
    y2, idx2 = maxpool_fwd.__wrapped__(x)
    assert torch.equal(y, y2) and torch.equal(idx, idx2)
    assert _kernel_series() == before
    for fn in (conv2d, conv2d_bwd_fused, vmm, vmm_bwd_fused, maxpool_fwd,
               relu_pool_fwd):
        assert fn.__wrapped__.__name__ == fn.__name__
    with pytest.raises(ValueError, match="unknown kernel family"):
        profile.instrument("nope")


class StepClock:
    """Each read advances 1 ms further than the last: call i lasts i ms."""

    def __init__(self):
        self.t, self.reads = 0.0, 0

    def __call__(self):
        self.reads += 1
        self.t += 1e-3 * ((self.reads + 1) // 2)
        return self.t


def test_enabled_calls_record_aggregates_and_the_histogram():
    x = torch.randn(2, 8, 8, 4)
    before = _kernel_series()
    clock = StepClock()
    with profile.profiled(profile.KernelProfiler(clock=clock)) as prof:
        assert profile.enabled() and profile.profiler() is prof
        for _ in range(3):
            relu_pool_fwd(x, False)
        maxpool_fwd(x.to(torch.bfloat16))
    assert not profile.enabled()
    agg = prof.aggregates()
    key = ("pool", (2, 8, 8, 4), "f32")
    assert set(agg) == {key, ("pool", (2, 8, 8, 4), "bf16")}
    a = agg[key]
    assert a["count"] == 3
    assert a["min_us"] < a["mean_us"] < a["max_us"]
    assert a["mean_us"] == pytest.approx(
        (a["min_us"] + a["max_us"]) / 2, rel=1e-6)
    after = _kernel_series()
    lbl = (("family", "pool"), ("precision", "f32"), ("shape", "2x8x8x4"))
    assert after[lbl] - before.get(lbl, 0) == 3
    text = profile.format_aggregates(prof)
    assert "pool" in text and "2x8x8x4" in text and "bf16" in text
    # enable / disable / profiled nest
    outer = profile.enable()
    with profile.profiled() as inner:
        assert profile.profiler() is inner is not outer
    assert profile.profiler() is outer
    profile.disable()
    assert profile.profiler() is None


def test_a_profiler_never_breaks_the_kernel():
    prof = profile.KernelProfiler()
    out = prof.call("pool", lambda *a: "ran", (object(),), {})
    assert out == "ran" and prof.aggregates() == {}


def test_pair_records_the_reference_keys():
    """The seed-batched pair run eagerly under each package's profiler."""
    jparams = jcnn.init(jax.random.PRNGKey(0), JCFG)
    params = cnn.params_from_jax(jax.tree.map(np.asarray, jparams))
    x = np.random.RandomState(1).randn(2, 8, 8, 3).astype(np.float32)
    with jprofile.profiled() as jprof:
        logits, res = jcnn.forward_with_residuals(jparams, jnp.asarray(x),
                                                  JCFG, "saliency")
        seeds = jax.nn.one_hot(jnp.argmax(logits, -1), 10)[None]
        jcnn.backward_seeds(jparams, res, seeds, JCFG, "saliency")
    eng = build(EngineSpec(CNNModel(params, CFG, device="cpu")))
    with profile.profiled() as prof:
        eng.explain(x)
    want = {k: v["count"] for k, v in jprof.aggregates().items()}
    got = {k: v["count"] for k, v in prof.aggregates().items()}
    assert got == want and len(got) == 9


@pytest.mark.parametrize("precision", ["bf16", "fxp16"])
def test_fold_records_the_folded_batch(precision):
    params = cnn.init(torch.Generator().manual_seed(0), CFG)
    eng = build(EngineSpec(CNNModel(params, CFG, device="cpu"),
                           method="occlusion", precision=precision))
    x = torch.randn(2, 8, 8, 3)
    with profile.profiled() as prof:
        eng.perturb(x, window=2, stride=2)
    got = {k: v["count"] for k, v in prof.aggregates().items()}
    fold = 16 * 2
    assert got == {
        ("conv2d_fwd", (n, 8, 8, 3, cin, 4), precision): 1
        for n in (2, fold) for cin in (3, 4)} | {
        ("pool", (n, 8, 8, 4), precision): 1 for n in (2, fold)} | {
        ("vmm_fwd", (n, 64, 16), precision): 1 for n in (2, fold)} | {
        ("vmm_fwd", (n, 16, 10), precision): 1 for n in (2, fold)}


# -- python -m repro_torch.obs -----------------------------------------------


def run_cli(pkg, *args):
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.obs", *args], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"})


def test_cli_trace_and_validate_equal_the_reference(tmp_path):
    out = {}
    for pkg in ("repro", "repro_torch"):
        path = tmp_path / f"{pkg}.json"
        r = run_cli(pkg, "trace", "--out", str(path), "-n", "200",
                    "--seed", "3", "--arrivals", "bursty", "--metrics-out",
                    str(tmp_path / f"{pkg}_metrics.json"))
        assert r.returncode == 0, r.stderr
        out[pkg] = (r.stdout.replace(str(path), "PATH").replace(
            str(tmp_path / f"{pkg}_metrics.json"), "METRICS"),
            path.read_bytes())
        v = run_cli(pkg, "validate", str(path))
        assert v.returncode == 0 and v.stdout.startswith("ok:"), v.stderr
    assert out["repro_torch"] == out["repro"]
    snap = json.loads((tmp_path / "repro_torch_metrics.json").read_text())
    assert snap["serve_requests_total"]["series"]
    bad = tmp_path / "bad.json"
    bad.write_text('{"traceEvents": [{"ph": "X"}]}')
    r = run_cli("repro_torch", "validate", str(bad))
    assert r.returncode == 1 and "PROBLEM" in r.stderr
    bad.write_text("not json")
    r = run_cli("repro_torch", "validate", str(bad))
    assert r.returncode == 1 and "not valid JSON" in r.stderr


def test_cli_metrics_prints_the_catalog():
    r = run_cli("repro_torch", "metrics")
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout)
    ref = subprocess.run(
        [sys.executable, "-c", "import repro.obs.metrics, json; "
         "from repro.obs import registry; "
         "print(json.dumps(registry.snapshot()))"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"})
    assert ref.returncode == 0, ref.stderr
    want = json.loads(ref.stdout)
    assert set(want) == set(jmetrics._R.snapshot())
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name]["kind"] == want[name]["kind"], name
        assert ([s["labels"] for s in got[name]["series"]]
                == [s["labels"] for s in want[name]["series"]]), name
    p = run_cli("repro_torch", "metrics", "--format", "prometheus")
    assert p.returncode == 0 and "# TYPE kernel_launch_seconds histogram" \
        in p.stdout


def test_cli_drift_waits_for_the_planner(tmp_path, capsys):
    from repro_torch.obs.__main__ import main
    from repro_torch.plan.drift import drift_rows, write_drift
    assert main(["drift", "--path", str(tmp_path / "none.json")]) == 1
    path = write_drift(drift_rows(CFG, device="edge-small"),
                       str(tmp_path / "d.json"))
    capsys.readouterr()
    assert main(["drift", "--path", path]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split()[:3] == ["key", "family", "shape"]
    assert [line.split()[0] for line in out[2:]] == [
        "conv0.fwd", "conv0.bwd", "conv1.fwd", "conv1.bwd", "pool1",
        "fc0.fwd", "fc0.bwd", "fc1.fwd", "fc1.bwd"]
    assert obs.VirtualClock is not None


def test_driver_profile_kernels_prints_the_aggregates(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "cnn", "--torch-device", "cpu", "--requests", "2",
         "--profile-kernels", "--precision", "fxp16", "--drift-out",
         str(tmp_path / "drift.json")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert "kernel profile" in r.stdout and "fxp16" in r.stdout
    for family in ("conv2d_fwd", "conv2d_bwd", "vmm_fwd", "vmm_bwd", "pool"):
        assert f"\n{family} " in r.stdout, family
    assert "cost-model drift (detected, fxp16" in r.stdout
    assert (tmp_path / "drift.json").exists()
