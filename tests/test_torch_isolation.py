"""repro_torch stands alone: no JAX, no repro, and nothing built at import.

* An AST scan of every module of the package and of ``chip_smoke.py`` finds
  no import of ``jax``, ``jaxlib`` or ``repro`` (``repro_torch`` itself is
  fine: names are matched exactly, not by prefix).
* With ``jax`` made unimportable, the package imports and explains on the
  CPU at the golden tiny config.
* With ``jax`` made unimportable, the perturbation explainers
  (``repro_torch.perturb``, ``Engine.perturb``, the serve explainers) and
  the kernel profiler run on the CPU, and ``python -m repro_torch.obs
  trace`` replays and validates its trace.
* With ``jax`` made unimportable, ``train_loop`` trains two steps on the
  CPU into a checkpoint and resumes from it.
* Importing every module neither starts ``nvcc`` nor loads the kernel
  library, and a CUDA launch without ``nvcc`` raises instead of running
  the plain version.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15 and files[-1].exists()
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_imports_and_explains_without_jax():
    out = _run("""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["repro"] = None
import numpy as np, torch
from repro_torch.engine import CNNModel, EngineSpec, TopK, build
from repro_torch.models import cnn
cfg = cnn.CNNConfig(in_hw=(8, 8), in_ch=3, channels=(4, 4), kernel=3,
                    fc=(16,), num_classes=4)
params = cnn.init(torch.Generator().manual_seed(0), cfg)
eng = build(EngineSpec(CNNModel(params, cfg, device="cpu"), method="guided",
                       targets=TopK(2)))
x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)
logits, rel = eng.explain(x)
assert tuple(rel.shape) == (2, 2, 8, 8, 3) and torch.isfinite(rel).all()
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok", tuple(logits.shape))
""")
    assert "ok (2, 4)" in out


def test_perturb_and_profiler_without_jax(tmp_path):
    out = _run(f"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np, torch
from repro_torch.engine import CNNModel, EngineSpec, build
from repro_torch.models import cnn
from repro_torch.obs import profile
from repro_torch.serve import CNNAdapter, ExplanationServer, Request
cfg = cnn.CNNConfig(in_hw=(8, 8), channels=(4, 4), fc=(16,))
params = cnn.init(torch.Generator().manual_seed(0), cfg)
x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)
with profile.profiled() as prof:
    for method in ("occlusion", "lime", "rise"):
        eng = build(EngineSpec(CNNModel(params, cfg, device="cpu"),
                               method=method, precision="fxp16"))
        key = None if method == "occlusion" else [1, 2]
        logits, heat = eng.perturb(x, key, n_samples=None
                                   if method == "occlusion" else 8)
        assert heat.shape == (2, 8, 8) and torch.isfinite(heat).all()
assert {{k[0] for k in prof.aggregates()}} == {{"conv2d_fwd", "pool",
                                               "vmm_fwd"}}
srv = ExplanationServer(CNNAdapter.from_engine(eng), max_batch=2,
                        max_delay_s=0.0,
                        method_opts={{"rise": {{"n_samples": 8}}}})
srv.submit(Request(uid="a", kind="explain", x=x[0], method="rise", key=3))
(resp,) = srv.drain()
assert resp.ok and not resp.cache_hit
from repro_torch.obs.__main__ import main
assert main(["trace", "-n", "50", "--out", r"{tmp_path / 't.json'}"]) == 0
assert main(["validate", r"{tmp_path / 't.json'}"]) == 0
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
""")
    assert out.strip().endswith("ok")


def test_train_loop_without_jax(tmp_path):
    out = _run(f"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch import configs
from repro_torch.data import TokenStream
from repro_torch.launch.train import train_loop
cfg = configs.get_smoke("llama3.2-1b")
data = TokenStream(vocab=cfg.vocab, seq_len=8, global_batch=2)
ck = r"{tmp_path / 'ck'}"
state, losses = train_loop(cfg, data, steps=2, ckpt_dir=ck, ckpt_every=1,
                           verbose=False, device="cpu")
assert len(losses) == 2 and int(state.opt.step) == 2
_, more = train_loop(cfg, data, steps=3, ckpt_dir=ck, device="cpu")
assert len(more) == 1
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
""")
    assert "[train] resumed from step 2" in out
    assert out.strip().endswith("ok")


def test_import_builds_and_loads_nothing():
    out = _run("""
import importlib, pkgutil, subprocess
def refuse(*a, **k):
    raise AssertionError("a subprocess was started at import time")
subprocess.Popen = subprocess.run = refuse
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.kernels import _build
assert _build._LIB is None
print("ok", len(_build.LAUNCHES))
""")
    assert "ok 15" in out


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)   # nothing prebuilt
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(ROOT / "no-such-nvcc"))
    monkeypatch.setattr(_build, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
