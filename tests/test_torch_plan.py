"""repro_torch.plan against repro.plan, on the CPU.

* Profiles: the JAX package's (``detected``, ``tpu-v4``, ``edge-*``,
  ``mesh:edge-small:1`` / ``:4``) field for field; mesh-name parsing and
  ``shard_batch_seeds``; ``get_profile("h100")`` raises without a card.
* Plans: ``plan_cnn`` entry for entry over a grid of configs, batches,
  seeds and precisions on every analytic profile, ``InfeasiblePlanError``
  at the same inputs; ``cnn_plan_footprints`` / ``lm_plan_footprints``
  field for field; ``plan_lm`` on falcon-mamba SMOKE and FULL.
* The tuning cache: the reference's battery (round trip, full hit, no
  re-measuring on a warm build, analytic entries do not satisfy autotune,
  corrupt / scribbled / wrong-arity files recover, unreadable paths) on the
  port's cache, and each package reading the other's file.
* ``h100`` from an explicit properties record (the H100 SXM's): the
  analytic plan is the kernels' launch rules at every Table III launch in
  f32, bf16 and fxp16, and with the launch stubbed every wrapper launches
  exactly what it launches without a plan; the card footprints' bounds
  summed per family give PERF.md's bound column within 5 %; autotune with
  ``measure_kernel`` stubbed measures the rule and at most
  ``AUTOTUNE_TOP_K`` others, one per launch, keeps the fastest, and a warm
  build measures nothing; the cache key carries the card.
* The drift table equals the reference's rows on the same aggregates; the
  CLI's exit codes equal ``python -m repro.plan``'s.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as configs
from repro.models import cnn as jcnn
from repro.plan import drift as jdrift
from repro.plan import planner as jplanner
from repro_torch import plan as tplan
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import conv2d as conv_mod
from repro_torch.kernels.vmm import vmm as vmm_mod
from repro_torch.models import cnn
from repro_torch.plan import drift as tdrift
from repro_torch.plan import planner as tplanner
from repro_torch.plan.profiles import H100_SXM_PROPERTIES
import repro.plan as jplan

ROOT = Path(__file__).resolve().parents[1]
H100 = tplan.gpu_profile(H100_SXM_PROPERTIES)
SHARED = ("detected", "tpu-v4", "edge-large", "edge-small", "edge-tiny",
          "mesh:edge-small:1", "mesh:edge-small:4")
PRECISIONS = ("f32", "bf16", "fxp16")
TINY = dict(in_hw=(8, 8), in_ch=3, channels=(4, 4), kernel=3, fc=(16,),
            num_classes=4)
LM_ARCH = "falcon-mamba-7b"


def _cfgs():
    """The reference's property-sweep grid (tests/test_plan.py), made
    deterministic, plus the paper's Table III config."""
    out = [({}, )]
    for hw in (8, 32):
        for ch in ((8,), (4, 8), (16, 16), (8, 16, 32, 32)):
            for fc, classes in (((), 2), ((16,), 10), ((64, 32), 12)):
                out.append((dict(in_hw=(hw, hw), in_ch=3, channels=ch,
                                 kernel=3, fc=fc, num_classes=classes,
                                 pool_every=(len(ch) if len(ch) % 2
                                             else 2)),))
    return [kw for (kw,) in out]


CFGS = _cfgs()


def _tiles(plan):
    """A plan as (device, precision, [(key, tile class, fields)])."""
    return (plan.device, plan.precision,
            [(k, type(t).__name__, dataclasses.astuple(t))
             for k, t in plan.entries])


def _plan_both(fn_t, fn_j, *args, **kw):
    """Both packages' result, or both InfeasiblePlanError messages."""
    try:
        want = fn_j(*args, **kw)
    except jplanner.InfeasiblePlanError as e:
        with pytest.raises(tplan.InfeasiblePlanError) as got:
            fn_t(*args, **kw)
        assert str(got.value) == str(e)
        return None, None
    return fn_t(*args, **kw), want


# -- profiles ---------------------------------------------------------------


@pytest.mark.parametrize("name", SHARED)
def test_profiles_match_repro(name):
    got, want = tplan.get_profile(name), jplan.get_profile(name)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if isinstance(want, jplan.MeshProfile):
        assert (dataclasses.asdict(got.core)
                == dataclasses.asdict(want.core))
    assert set(jplan.profile_names()) < set(tplan.profile_names())
    assert tplan.get_profile(got) is got


@pytest.mark.parametrize("bad", ["mesh:edge-small", "mesh:edge-small:0",
                                 "mesh:edge-small:x", "mesh:nope:2",
                                 "edge-nonexistent"])
def test_malformed_names_raise_as_in_repro(bad):
    with pytest.raises(ValueError) as want:
        jplan.get_profile(bad)
    with pytest.raises(ValueError) as got:
        tplan.get_profile(bad)
    assert str(got.value) .split(";")[0] == str(want.value).split(";")[0]


def test_nested_mesh_and_card_meshes_raise():
    """Nested meshes raise; a mesh of cards (A12b) is a GpuMeshProfile:
    each card planned at its slice, and ``mesh:h100:1`` plans what
    ``h100`` plans, entry for entry."""
    with pytest.raises(ValueError, match="nest"):
        tplan.mesh_profile("mesh:edge-small:2", 2)
    with pytest.raises(ValueError, match="nest"):
        tplan.mesh_profile(tplan.mesh_profile(H100, 2), 2)
    m2 = tplan.mesh_profile(H100, 2)
    assert isinstance(m2, tplan.GpuMeshProfile)
    assert isinstance(m2, tplan.GpuProfile) and m2.n_shards == 2
    assert m2.name == "mesh:h100:2" and m2.core == H100
    cfg = cnn.CNNConfig()
    for p in PRECISIONS:
        one = tplan.plan_cnn(cfg, tplan.mesh_profile(H100, 1), p, batch=32,
                             seeds=3)
        assert one.entries == tplan.plan_cnn(cfg, H100, p, batch=32,
                                             seeds=3).entries
        assert tplan.plan_cnn(cfg, m2, p, batch=32, seeds=3).entries == \
            tplan.plan_cnn(cfg, H100, p, batch=16, seeds=3).entries


def test_shard_batch_seeds_matches_repro():
    for batch in (0, 1, 2, 3, 7, 32):
        for seeds in (1, 2, 3, 5):
            for n in (1, 2, 3, 4, 8, 64):
                assert (tplan.shard_batch_seeds(batch, seeds, n)
                        == jplan.shard_batch_seeds(batch, seeds, n))
    for bad in (0, -1):
        with pytest.raises(ValueError):
            tplan.shard_batch_seeds(1, 1, bad)


def test_h100_profile_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplan.get_profile("h100")
    assert tplan.get_profile("detected").name == "detected"
    assert tplan.get_profile(None).vmem_bytes == 16 << 20


def test_h100_profile_from_the_properties_record():
    assert (H100.sms, H100.vmem_bytes, H100.smem_per_sm) == (132, 232448,
                                                            233472)
    assert (H100.hbm_bytes_per_s, H100.f32_flops, H100.bf16_flops,
            H100.imad_ops, H100.exp_ops) == (3.35e12, 67e12, 989e12,
                                             1.673e13, 4.182e12)
    assert H100.cache_device == "h100/NVIDIA H100 80GB HBM3/132sm"
    other = H100_SXM_PROPERTIES.__class__(
        **dict(vars(H100_SXM_PROPERTIES), name="NVIDIA Z1"))
    with pytest.raises(ValueError, match="no data sheet"):
        tplan.gpu_profile(other)


# -- plans and footprints ----------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("device", SHARED)
def test_plan_cnn_matches_repro(device, precision):
    infeasible = 0
    for kw in CFGS:
        cfg, jcfg = cnn.CNNConfig(**kw), jcnn.CNNConfig(**kw)
        for batch, seeds in ((1, 1), (2, 3), (32, 3)):
            got, want = _plan_both(
                lambda c, **k: tplan.plan_cnn(c if c is cfg else cfg, **k),
                lambda c, **k: jplan.plan_cnn(jcfg, **k), cfg,
                device=device, precision=precision, batch=batch,
                seeds=seeds)
            if want is None:
                infeasible += 1
                continue
            assert _tiles(got) == _tiles(want), (kw, batch, seeds)
            assert got.shapes == ()          # TPU tiles are audits
    if device == "edge-tiny":
        assert infeasible                    # the grid reaches the limit


def _fp(fp):
    return (fp.vmem_bytes, fp.hbm_bytes, fp.flops, fp.mxu_util)


@pytest.mark.parametrize("device", SHARED)
def test_cnn_plan_footprints_match_repro(device):
    for kw in (TINY, {}):
        cfg, jcfg = cnn.CNNConfig(**kw), jcnn.CNNConfig(**kw)
        for precision in PRECISIONS:
            for seeds, batch in ((1, 1), (3, 8)):
                args = dict(precision=precision, batch=batch, seeds=seeds)
                try:
                    jp = jplan.plan_cnn(jcfg, device, **args)
                    tp = tplan.plan_cnn(cfg, device, **args)
                except jplanner.InfeasiblePlanError:
                    jp = tp = None
                for p_t, p_j in ((tp, jp), (None, None)):
                    got = tplan.cnn_plan_footprints(cfg, p_t, profile=device,
                                                    **args)
                    want = jplan.cnn_plan_footprints(jcfg, p_j,
                                                     profile=device, **args)
                    assert list(got) == list(want)
                    assert ({k: _fp(v) for k, v in got.items()}
                            == {k: _fp(v) for k, v in want.items()})


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("device", SHARED)
def test_plan_lm_matches_repro(device, size):
    get_t = configs.get_smoke if size == "smoke" else configs.get
    get_j = jconfigs.get_smoke if size == "smoke" else jconfigs.get
    cfg, jcfg = get_t(LM_ARCH), get_j(LM_ARCH)
    for precision in ("f32", "bf16"):
        for batch, seq in ((1, tplan.LM_PLAN_SEQ), (4, 72)):
            args = dict(precision=precision, batch=batch, seq=seq)
            got, want = _plan_both(
                lambda c, **k: tplan.plan_lm(cfg, **k),
                lambda c, **k: jplan.plan_lm(jcfg, **k), cfg, device=device,
                **args)
            if want is not None:
                assert _tiles(got) == _tiles(want)
                assert ({k: _fp(v) for k, v in tplan.lm_plan_footprints(
                    cfg, got, profile=device, **args).items()}
                        == {k: _fp(v) for k, v in jplan.lm_plan_footprints(
                            jcfg, want, profile=device, **args).items()})
            assert ({k: _fp(v) for k, v in tplan.lm_plan_footprints(
                cfg, None, profile=device, **args).items()}
                    == {k: _fp(v) for k, v in jplan.lm_plan_footprints(
                        jcfg, None, profile=device, **args).items()})
    with pytest.raises(ValueError, match="f32|bf16"):
        tplan.plan_lm(cfg, device, "fxp16")


def test_single_kernel_planners_match_repro():
    for device in SHARED:
        for precision in PRECISIONS:
            for shape in ((1, 32, 32, 3, 3, 32), (4, 16, 16, 3, 64, 64)):
                assert (dataclasses.astuple(tplan.plan_conv2d(
                    *shape, profile=device, precision=precision))
                        == dataclasses.astuple(jplan.plan_conv2d(
                            *shape, profile=device, precision=precision)))
            for shape in ((1, 4096, 128), (32, 128, 10), (300, 6000, 600)):
                assert (dataclasses.astuple(tplan.plan_vmm(
                    *shape, profile=device, precision=precision))
                        == dataclasses.astuple(jplan.plan_vmm(
                            *shape, profile=device, precision=precision)))


# -- the tuning cache ---------------------------------------------------------


TCFG, JTCFG = cnn.CNNConfig(**TINY), jcnn.CNNConfig(**TINY)
PAPER = cnn.CNNConfig()


def test_cache_roundtrip_and_full_hit(tmp_path):
    cache = tplan.TuningCache(str(tmp_path / "tiles.json"))
    plan1 = tplan.plan_cnn(PAPER, device="edge-small", cache=cache)
    assert cache.hits == 0 and cache.misses == len(plan1)
    assert len(json.loads(Path(cache.path).read_text())) == len(plan1)
    warm = tplan.TuningCache(cache.path)
    plan2 = tplan.plan_cnn(PAPER, device="edge-small", cache=warm)
    assert warm.misses == 0 and warm.hits == len(plan1)
    assert plan2 == plan1


def test_cache_hit_replans_without_remeasuring(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tplanner, "measure_kernel",
                        lambda family, kw, tile, precision:
                        calls.append(family) or 1.0)
    cache = tplan.TuningCache(str(tmp_path / "tiles.json"))
    plan1 = tplan.plan_cnn(TCFG, device="edge-small", autotune=True,
                           cache=cache)
    assert calls
    calls.clear()
    warm = tplan.TuningCache(cache.path)
    plan2 = tplan.plan_cnn(TCFG, device="edge-small", autotune=True,
                           cache=warm)
    assert not calls and plan2 == plan1 and warm.misses == 0


def test_analytic_cache_entry_does_not_suppress_autotune(tmp_path,
                                                         monkeypatch):
    calls = []
    monkeypatch.setattr(tplanner, "measure_kernel",
                        lambda *a: calls.append(a) or 1.0)
    cache = tplan.TuningCache(str(tmp_path / "tiles.json"))
    tplan.plan_cnn(TCFG, device="edge-small", cache=cache)
    assert not calls
    tplan.plan_cnn(TCFG, device="edge-small", autotune=True, cache=cache)
    assert calls
    calls.clear()
    tplan.plan_cnn(TCFG, device="edge-small", autotune=True, cache=cache)
    assert not calls


@pytest.mark.parametrize("garbage", ['{"k": {"tile": [64', "[1, 2, 3]",
                                     '"a string"', "{not json"])
def test_cache_corruption_recovers_with_atomic_rewrite(tmp_path, garbage):
    p = tmp_path / "tiles.json"
    p.write_text(garbage)
    cache = tplan.TuningCache(str(p))
    plan = tplan.plan_cnn(TCFG, device="edge-small", cache=cache)
    assert cache.hits == 0 and cache.misses == len(plan)
    assert len(json.loads(p.read_text())) == len(plan)
    warm = tplan.TuningCache(str(p))
    assert tplan.plan_cnn(TCFG, device="edge-small", cache=warm) == plan
    assert warm.misses == 0


def test_cache_scribbled_entries_dropped_others_kept(tmp_path):
    cache = tplan.TuningCache(str(tmp_path / "tiles.json"))
    plan = tplan.plan_cnn(TCFG, device="edge-small", cache=cache)
    stored = json.loads(Path(cache.path).read_text())
    victim = sorted(stored)[0]
    stored[victim] = {"tile": "not-a-list"}
    stored["foreign|blob"] = 7
    stored["bool|tile"] = {"tile": [True, 8]}
    stored["card|tile"] = {"tile": [1, 2], "plan": "ConvPlan"}
    Path(cache.path).write_text(json.dumps(stored))
    warm = tplan.TuningCache(cache.path)
    assert len(warm) == len(plan) - 1
    assert tplan.plan_cnn(TCFG, device="edge-small", cache=warm) == plan
    assert warm.hits == len(plan) - 1 and warm.misses == 1
    cleaned = json.loads(Path(cache.path).read_text())
    assert not {"foreign|blob", "bool|tile", "card|tile"} & set(cleaned)
    assert tplan.TuningCache.valid_entry(cleaned[victim])


def test_cache_wrong_arity_tile_is_replanned_and_repaired(tmp_path):
    cache = tplan.TuningCache(str(tmp_path / "tiles.json"))
    plan = tplan.plan_cnn(TCFG, device="edge-small", cache=cache)
    stored = json.loads(Path(cache.path).read_text())
    victim = next(k for k in stored if k.startswith("vmm_fwd"))
    stored[victim]["tile"] = [128]
    Path(cache.path).write_text(json.dumps(stored))
    warm = tplan.TuningCache(cache.path)
    assert tplan.plan_cnn(TCFG, device="edge-small", cache=warm) == plan
    assert len(json.loads(Path(cache.path).read_text())[victim]["tile"]) == 3
    for family, blob, kind in (("vmm_fwd", [128], None),
                               ("no_such_family", [1, 2, 3], None),
                               ("vmm_fwd", [1, 2], "ConvPlan"),
                               ("conv2d_fwd", [1, 2, 3], "ConvPlan"),
                               ("vmm_fwd", [1, 2], "splits")):
        with pytest.raises(ValueError):
            tplanner._decode_tile(family, blob, kind)


def test_cache_unreadable_path_never_crashes(tmp_path):
    cache = tplan.TuningCache(str(tmp_path))
    assert len(cache) == 0
    plan = tplan.plan_cnn(TCFG, device="edge-small", cache=cache)
    assert len(plan) and cache.misses == len(plan)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_each_package_reads_the_others_cache(tmp_path, writer):
    path = str(tmp_path / "tiles.json")
    for device in ("edge-small", "tpu-v4", "mesh:edge-small:4"):
        for precision in PRECISIONS:
            args = dict(device=device, precision=precision, batch=4,
                        seeds=3)
            if writer == "repro":
                jplan.plan_cnn(JTCFG, cache=jplan.TuningCache(path), **args)
                reader = tplan.TuningCache(path)
                got = tplan.plan_cnn(TCFG, cache=reader, **args)
                want = tplan.plan_cnn(TCFG, **args)
            else:
                tplan.plan_cnn(TCFG, cache=tplan.TuningCache(path), **args)
                reader = jplan.TuningCache(path)
                got = jplan.plan_cnn(JTCFG, cache=reader, **args)
                want = jplan.plan_cnn(JTCFG, **args)
            assert reader.misses == 0 and reader.hits == len(want)
            assert _tiles(got) == _tiles(want)


def test_default_cache_paths_differ(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE", raising=False)
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    from repro.plan.cache import default_cache_path as jdefault
    assert tplan.default_cache_path() != jdefault()
    assert tplan.default_cache_path().endswith(
        os.path.join(".cache", "repro_torch", "tileplans.json"))
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "c.json"))
    assert tplan.default_cache_path() == str(tmp_path / "c.json")
    assert tplan.TuningCache().path == str(tmp_path / "c.json")


def test_cache_records_into_the_metrics_catalog(tmp_path):
    from repro_torch.obs import metrics
    before = metrics.PLAN_CACHE_STORES.value()
    hits = metrics.PLAN_CACHE_LOOKUPS.value(result="hit")
    cache = tplan.TuningCache(str(tmp_path / "tiles.json"))
    plan = tplan.plan_cnn(TCFG, device="edge-small", cache=cache)
    tplan.plan_cnn(TCFG, device="edge-small", cache=cache)
    assert metrics.PLAN_CACHE_STORES.value() == before + len(plan)
    assert metrics.PLAN_CACHE_LOOKUPS.value(result="hit") == hits + len(plan)


# -- the card's profile -------------------------------------------------------


def _rules(cfg, precision, batch, seeds):
    """Each Table III launch's plan by today's launch rule."""
    esize = 4 if precision == "f32" else 2
    bf16 = precision == "bf16"
    out = {}
    for key, family, kw in tplan.cnn_kernel_shapes(cfg, batch, seeds):
        if family == "conv2d_fwd":
            args = (kw["n"], kw["h"], kw["w"], kw["cin"], kw["cout"],
                    kw["k"])
            out[key] = (conv_mod.conv_bf16_plan(*args) if bf16
                        else conv_mod.conv_plan(*args, esize=esize))
        elif family == "conv2d_bwd":
            h, w = ((2 * kw["hg"], 2 * kw["wg"]) if kw["pooled"]
                    else (kw["hg"], kw["wg"]))
            args = (kw["s"], kw["n"], h, w, kw["c"], kw["cout"], kw["k"])
            out[key] = (conv_mod.conv_bwd_bf16_plan(
                *args, pooled=kw["pooled"]) if bf16
                else conv_mod.conv_bwd_plan(*args, pooled=kw["pooled"],
                                            esize=esize))
        elif family == "vmm_fwd":
            out[key] = (vmm_mod.vmm_mma_plan if bf16 else vmm_mod.vmm_splits)(
                kw["m"], kw["k"], kw["n"])
        elif family == "vmm_bwd":
            out[key] = (vmm_mod.vmm_bwd_mma_plan if bf16
                        else vmm_mod.vmm_bwd_plan)(kw["s"], kw["m"],
                                                   kw["k"], kw["n"])
    return out


@pytest.mark.parametrize("precision", PRECISIONS)
def test_h100_analytic_plan_is_the_launch_rules(precision):
    for kw, batch, seeds in (({}, 32, 3), ({}, 1, 1), ({}, 8192, 1),
                             (TINY, 2, 2)):
        cfg = cnn.CNNConfig(**kw)
        plan = tplan.plan_cnn(cfg, H100, precision, batch=batch,
                              seeds=seeds)
        assert plan.device == "h100" and len(plan.shapes) == len(plan)
        assert dict(plan.entries) == _rules(cfg, precision, batch, seeds)
        for key, family, kw_ in tplan.cnn_kernel_shapes(cfg, batch, seeds):
            if family != "pool":
                dims = [int(v) for v in kw_.values()]
                assert plan.at(key, dims) == plan.get(key)
                assert plan.at(key, [dims[0] + 1] + dims[1:]) is None


def test_sms_keyword_reaches_every_rule():
    small = dataclasses.replace(H100, sms=66)
    plan = tplan.plan_cnn(PAPER, small, "f32", batch=32, seeds=3)
    assert plan.get("fc0.fwd") == vmm_mod.vmm_splits(32, 4096, 128, sms=66)
    assert plan.get("fc0.fwd") != vmm_mod.vmm_splits(32, 4096, 128)
    assert plan.get("conv1.fwd") == conv_mod.conv_plan(32, 32, 32, 32, 32,
                                                       3, sms=66)
    bf = tplan.plan_cnn(PAPER, small, "bf16", batch=32, seeds=3)
    assert bf.get("fc0.fwd") == vmm_mod.vmm_mma_plan(32, 4096, 128, sms=66)


def _stub_card(monkeypatch):
    """Route every wrapper to its kernel on CPU tensors and record the
    launches (entry and arguments) instead of running them."""
    out = []

    def launch(counter, entry, device, *args, **kw):
        # data pointers differ run to run; sizes and plan ints do not
        out.append((counter, entry,
                    tuple("ptr" if isinstance(a, int) and a >= 1 << 32 else a
                          for a in args)))

    from repro_torch.kernels.pool import pool as pool_mod
    from repro_torch.kernels.relu_mask import relu_mask as relu_mod
    for mod in (vmm_mod, conv_mod, pool_mod, relu_mod):
        monkeypatch.setattr(mod, "on_card", lambda name, *ts: True)
        for name in ("check_kernel_operands", "check_image_operand"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, lambda name, *ts: None)
    monkeypatch.setattr(_build, "launch", launch)
    return out


def _run_pair(params, cfg, precision, plan, x, seeds):
    from repro_torch.engine import CNNModel
    fwd, bwd = CNNModel(params, cfg, device="cpu").pair("guided", precision,
                                                        plan=plan)
    logits, res = fwd(x)
    bwd(res, seeds)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_planned_launches_equal_unplanned(monkeypatch, precision):
    """With the launch stubbed, the Table III pair at batch 32, top-3
    launches exactly the same entries and arguments with no plan and with
    the analytic h100 plan; an autotuned plan changes exactly the launches
    whose entries moved, and not at another batch."""
    params = cnn.init(torch.Generator().manual_seed(0), PAPER)
    x, seeds = torch.zeros(32, 32, 32, 3), torch.zeros(3, 32, 10)
    launches = _stub_card(monkeypatch)
    _run_pair(params, PAPER, precision, None, x, seeds)
    unplanned, launches[:] = list(launches), []
    plan = tplan.plan_cnn(PAPER, H100, precision, batch=32, seeds=3)
    _run_pair(params, PAPER, precision, plan, x, seeds)
    # forward: 4 conv, 3 ReLU, 2 ReLU + pool, 2 FC; backward: 2 FC, 4 conv
    assert launches == unplanned and len(unplanned) == 11 + 6
    launches[:] = []
    moved = dict(plan.entries)
    moved["fc0.fwd"] = (vmm_mod.VmmMmaPlan(32, 8) if precision == "bf16"
                        else 16)
    moved["conv1.bwd"] = (conv_mod.conv_bwd_mma_candidates(
        3, 32, 32, 32, 32, 3, pooled=True)[0] if precision == "bf16"
        else conv_mod.conv_bwd_candidates(3, 32, 32, 32, 3, pooled=True,
                                          esize=2 if precision != "f32"
                                          else 4)[0])
    tuned = dataclasses.replace(plan, entries=tuple(moved.items()))
    _run_pair(params, PAPER, precision, tuned, x, seeds)
    diff = [i for i, (a, b) in enumerate(zip(launches, unplanned)) if a != b]
    fxp = "_fxp" if precision == "fxp16" else ""
    assert [launches[i][0] for i in diff] == [f"vmm{fxp}_fwd",
                                              f"conv2d_bwd_fused{fxp}"]
    launches[:] = []
    _run_pair(params, PAPER, precision, tuned, torch.zeros(16, 32, 32, 3),
              torch.zeros(3, 16, 10))
    again, launches[:] = list(launches), []
    _run_pair(params, PAPER, precision, None, torch.zeros(16, 32, 32, 3),
              torch.zeros(3, 16, 10))
    assert again == launches


#: PERF.md §6's bound column (ms an explain, B = 32, S = 3, Table III).
PERF_BOUNDS = {("f32", "conv2d_fwd"): 0.0239, ("f32", "conv2d_bwd"): 0.0236,
               ("f32", "vmm_fwd"): 0.0008, ("f32", "vmm_bwd"): 0.0011,
               ("fxp16", "conv2d_fwd"): 0.0468,
               ("fxp16", "conv2d_bwd"): 0.0413,
               ("fxp16", "vmm_fwd"): 0.0010, ("fxp16", "vmm_bwd"): 0.0015,
               ("bf16", "conv2d_fwd"): 0.0024 + 0.0007,
               ("bf16", "conv2d_bwd"): 0.0072, ("bf16", "vmm_fwd"): 0.0004,
               ("bf16", "vmm_bwd"): 0.0006}


@pytest.mark.parametrize("precision", PRECISIONS)
def test_card_footprints_give_the_kernel_tables_bounds(precision):
    fps = tplan.cnn_plan_footprints(PAPER, None, precision=precision,
                                    batch=32, seeds=3, profile=H100)
    shapes = tplan.cnn_kernel_shapes(PAPER, 32, 3)
    for family in ("conv2d_fwd", "conv2d_bwd", "vmm_fwd", "vmm_bwd"):
        got = 1e3 * sum(fps[k].bound_s(H100) for k, f, _ in shapes
                        if f == family)
        want = PERF_BOUNDS[(precision, family)]
        # within 5 %, or the table's rounding to 4 decimals
        assert abs(got - want) <= max(0.05 * want, 0.5e-4), (family, got,
                                                             want)
    for fp in fps.values():
        assert fp.fits(H100) and 0 < fp.mxu_util <= 1
        assert fp.est_time_s(H100) >= fp.bound_s(H100)


def _fake_times(monkeypatch, fastest=None):
    """Stub measure_kernel: 10 us for every plan but ``fastest(family,
    tile)``'s, 5 us."""
    calls = []

    def measure(family, kw, tile, precision):
        calls.append((family, tuple(kw.values()), tile))
        return 5.0 if fastest is not None and fastest(family, tile) else 10.0

    monkeypatch.setattr(tplanner, "measure_kernel", measure)
    return calls


@pytest.mark.parametrize("precision", PRECISIONS)
def test_h100_autotune_measures_rule_plus_top_k(tmp_path, monkeypatch,
                                                precision):
    rules = _rules(PAPER, precision, 32, 3)
    calls = _fake_times(monkeypatch)
    cache = tplan.TuningCache(str(tmp_path / "tiles.json"))
    plan = tplan.plan_cnn(PAPER, H100, precision, batch=32, seeds=3,
                          autotune=True, cache=cache)
    assert dict(plan.entries) == rules          # ties keep the rule
    by_launch = {}
    for family, dims, tile in calls:
        by_launch.setdefault((family, dims), []).append(tile)
    assert len(by_launch) == len(plan)
    for (family, dims), tiles in by_launch.items():
        assert tiles[0] in rules.values()       # the rule, first
        assert 1 <= len(tiles) <= 1 + tplan.AUTOTUNE_TOP_K
        assert len(set(map(repr, tiles))) == len(tiles)
    # a warm build measures nothing and reads the same plan
    calls.clear()
    warm = tplan.TuningCache(cache.path)
    assert tplan.plan_cnn(PAPER, H100, precision, batch=32, seeds=3,
                          autotune=True, cache=warm) == plan
    assert not calls and warm.misses == 0 and warm.hits == len(plan)
    entry = next(iter(json.loads(Path(cache.path).read_text()).values()))
    assert entry["rule_us"] == 10.0 and entry["plan"]


def test_h100_autotune_keeps_the_fastest(tmp_path, monkeypatch):
    def fastest(family, tile):
        return family == "vmm_fwd" and tile == 32
    calls = _fake_times(monkeypatch, fastest)
    plan = tplan.plan_cnn(PAPER, H100, "f32", batch=32, seeds=3,
                          autotune=True)
    assert 32 in [t for f, _, t in calls if f == "vmm_fwd"]
    assert plan.get("fc0.fwd") == 32 and plan.get("fc1.fwd") == 1
    cache = tplan.TuningCache(str(tmp_path / "tiles.json"))
    tplan.plan_cnn(PAPER, H100, "f32", batch=32, seeds=3, autotune=True,
                   cache=cache)
    calls.clear()
    assert tplan.plan_cnn(PAPER, H100, "f32", batch=32, seeds=3,
                          autotune=True,
                          cache=tplan.TuningCache(cache.path)) == plan
    assert not calls
    # the key carries the card: another card's SM count misses
    pcie = dataclasses.replace(H100, sms=114)
    other = tplan.TuningCache(cache.path)
    tplan.plan_cnn(PAPER, pcie, "f32", batch=32, seeds=3, cache=other)
    assert other.hits == 0


def test_h100_scan_candidates_one_per_launch(monkeypatch):
    calls = _fake_times(monkeypatch)
    cfg = configs.get(LM_ARCH)
    plan = tplan.plan_lm(cfg, H100, "bf16", batch=4, seq=72, autotune=True)
    assert plan.get("ssm0.scan") == tplan.ScanTile(cfg.d_inner, cfg.ssm_chunk)
    from repro_torch.kernels.ssm_scan.ssm_scan import bwd_window, fwd_channels
    launches = [(fwd_channels(t.d_tile, cfg.d_inner), min(t.chunk, 16, 72),
                 bwd_window(72, t.chunk)) for _, _, t in calls]
    assert len(calls) == 1 + tplan.AUTOTUNE_TOP_K
    assert len(set(launches)) == len(launches)
    analytic = tplan.plan_lm(cfg, H100, "bf16", batch=4, seq=72)
    assert analytic.get("ssm0.scan") == plan.get("ssm0.scan")


def test_measure_kernel_refuses_without_a_card_and_tpu_tiles(monkeypatch):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplan.measure_kernel("vmm_fwd", dict(m=1, k=8, n=8), 1, "f32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="TPU"):
        tplan.measure_kernel("conv2d_fwd", {}, tplan.ConvTile(8), "f32")


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_conv_candidates_pass_the_wrappers_validators(k):
    """Every plan the autotuner and the sweep may launch is one the
    wrappers accept, within the card's 227 KB."""
    for h, cin, cout in ((32, 3, 32), (32, 32, 32), (16, 64, 64),
                         (8, 13, 5)):
        for esize, dtype in ((4, torch.float32), (2, torch.int16)):
            plans = conv_mod.conv_candidates(h, cin, cout, k, esize=esize)
            assert plans
            for p in plans:
                conv_mod._check_fwd_plan("conv2d", p, k, esize, cin, dtype)
        for s in (1, 3):
            for pooled in (False, True):
                plans = conv_mod.conv_bwd_candidates(
                    s, h, cin, cout, k, pooled=pooled, esize=4)
                assert plans
                for p in plans:
                    conv_mod._check_bwd_plan(p, k, pooled=pooled, esize=4,
                                             c=cin, s=s, dtype=torch.float32)


def test_h100_general_and_bf16_k9():
    cfg = cnn.CNNConfig(in_hw=(8, 8), channels=(8, 8), kernel=9, fc=(),
                        num_classes=4)
    plan = tplan.plan_cnn(cfg, H100, "f32", batch=2)
    assert plan.get("conv0.fwd") == conv_mod.CONV_GENERAL
    assert plan.get("conv0.bwd") == conv_mod.CONV_BWD_GENERAL
    with pytest.raises(tplan.InfeasiblePlanError, match="bf16"):
        tplan.plan_cnn(cfg, H100, "bf16", batch=2)


# -- the drift table and the CLI ---------------------------------------------


class _FakeProfiler:
    def __init__(self, shapes, precision):
        self._agg = {(family, tuple(int(v) for v in kw.values()), precision):
                     {"count": 2, "mean_us": 10.0 + i, "min_us": 9.0,
                      "max_us": 12.0}
                     for i, (_, family, kw) in enumerate(shapes) if i % 3}

    def aggregates(self):
        return self._agg


@pytest.mark.parametrize("device", ["edge-small", "tpu-v4", "detected"])
def test_drift_rows_match_repro(device, tmp_path):
    for precision in PRECISIONS:
        prof = _FakeProfiler(tplan.cnn_kernel_shapes(PAPER, 4, 1), precision)
        plan_t = tplan.plan_cnn(PAPER, device, precision, batch=4, seeds=1)
        plan_j = jplan.plan_cnn(jcnn.CNNConfig(), device, precision,
                                batch=4, seeds=1)
        for pt, pj in ((plan_t, plan_j), (None, None)):
            got = tdrift.drift_rows(PAPER, pt, device=device,
                                    precision=precision, batch=4, seeds=1,
                                    profiler=prof)
            want = jdrift.drift_rows(jcnn.CNNConfig(), pj, device=device,
                                     precision=precision, batch=4, seeds=1,
                                     profiler=prof)
            assert got == want
    path = tdrift.write_drift(got, str(tmp_path / "d.json"))
    assert json.loads(Path(path).read_text())["rows"] == got
    assert tdrift.format_drift(got) == jdrift.format_drift(want)
    assert tdrift.drift_path(str(tmp_path / "c.json")) == str(
        tmp_path / "c.drift.json")


def test_drift_rows_on_the_card_profile():
    prof = _FakeProfiler(tplan.cnn_kernel_shapes(PAPER, 32, 3), "bf16")
    plan = tplan.plan_cnn(PAPER, H100, "bf16", batch=32, seeds=3)
    rows = tdrift.drift_rows(PAPER, plan, device=H100, precision="bf16",
                             batch=32, seeds=3, profiler=prof)
    assert [r["key"] for r in rows] == [
        k for k, _, _ in tplan.cnn_kernel_shapes(PAPER, 32, 3)]
    for r in rows:
        assert r["device"] == "h100" and r["est_us"] > 0
        assert (r["drift"] is None) == (r["measured_us"] is None)


def _cli(module, *args, cache):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_PLAN_CACHE=cache, REPRO_TORCH_PLAN_CACHE=cache,
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("device", ["edge-small", "edge-tiny"])
def test_cli_exit_codes_match_repro(tmp_path, device):
    rcs = {}
    for module in ("repro.plan", "repro_torch.plan"):
        cache = str(tmp_path / f"{module}.json")
        first = _cli(module, "--device", device, "--precision", "fxp16",
                     cache=cache)
        second = _cli(module, "--device", device, "--precision", "fxp16",
                      "--expect-full-hit", cache=cache)
        fresh = _cli(module, "--device", device, "--expect-full-hit",
                     cache=str(tmp_path / f"fresh-{module}.json"))
        rcs[module] = (first.returncode, second.returncode, fresh.returncode)
        if device == "edge-small":
            assert "[plan] device=edge-small" in first.stdout
            assert "hits=12 misses=0" in second.stdout, second.stdout
    assert rcs["repro_torch.plan"] == rcs["repro.plan"]
    assert rcs["repro_torch.plan"] == ((0, 0, 2) if device == "edge-small"
                                       else (0, 0, 1))


def test_cli_on_the_card_profile_needs_the_card(tmp_path):
    r = _cli("repro_torch.plan", "--device", "h100", "--autotune",
             cache=str(tmp_path / "c.json"))
    assert r.returncode != 0 and "no CUDA device" in r.stderr
