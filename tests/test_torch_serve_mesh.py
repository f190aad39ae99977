"""The explanation server on a mesh of ranks (``repro_torch.serve.
follower``) on the CPU.

Gloo worlds of 2 and 3 ranks (``tests/_torch_dist.py``'s
``serve_scenario``) serve one request stream (``serve_phases``) in f32,
bf16 and fxp16 on a ``mesh:edge-small:<n>`` CNN adapter: rank 0 runs the
servers through ``follower.lead``, the other ranks ``follower.follow``,
and the last follower fails three times by design (``FaultyAdapter``: it
cannot build its first explainer, before that launch, nor its first
fxp16 sibling, and a predict whose batch holds ``FAULT_MARK`` fails after
the launch's collectives).  The stream mixes
predicts, cache hits of the three BP methods with and without top-3 and
explicit targets, cold explains of the same rows, integrated gradients,
co-batched smoothgrad seeds, input x gradient, integrated gradients again
through a second server with other steps on the same stream, occlusion,
LIME and RISE, refusals at submit, a launch that fails on every rank
(class 99 of 10) and, from f32 and bf16, an fxp16 reroute under admission
pressure.

* (a) Every response equals the port's single-process server's on the same
  stream (a ``mesh:edge-small:<n>`` adapter in one process: the same seats
  and batches): bitwise where each rank runs at least 2 rows of a launch,
  or the launch has one row, and always in fxp16; within ``SERVE_TOL`` where a
  launch gives each rank one row (a one-row f32 FC sums in another order
  on the CPU than a many-row one).
* (b) is ``tests/test_torch_serve_mesh_ref.py``: the same worlds
  against the JAX package's server.
* (c) In each world a cache hit is bitwise its cold explain of the same
  batch, and a co-batched smoothgrad row its singleton request.
* (d) Refusals at submit never reach the stream; the class-99 launch
  errors as on one process; the follower's three faults answer as
  ``RankFault`` errors on the leader, and the next batch is served; every
  follower joined every launch, logged exactly the faults it met, and
  exited 0; a cold BP explain ships no residuals, a hit batch its rows'.
  A fault that leaves the ranks out of step (one rank raising inside its
  model function, before the engine's gather: a follower in a world of
  3, the leader in a world of 2) stops the world: every rank ends with
  ``follower.LOST_EXIT_CODE`` well inside the harness's timeout.
* (e) ``launch/serve.py`` under ``torchrun``: the CNN on 2 gloo ranks and
  the LM on 2 (rank 0 alone) exit 0 and print the single-process driver's
  counts.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
import repro_torch.serve as tserve
from repro_torch import engine as tengine
from repro_torch import tree as trees
from repro_torch.engine import CNNModel, EngineSpec, build
from repro_torch.models import cnn

from _torch_dist import (CNN_KW, PRECISIONS, SERVE_INJECTED, SERVE_LOST,
                         SERVE_MAX_BATCH, SERVE_REPLAY_N, SERVE_TOL,
                         SERVE_WORLDS,
                         serve_close, serve_lost_worlds, serve_pairs,
                         serve_phases, serve_pool, serve_run,
                         serve_same_outcome, serve_servers, serve_worlds)

ROOT = Path(__file__).resolve().parents[1]
JCFG = jcnn.CNNConfig(**CNN_KW)
CFG = cnn.CNNConfig(**CNN_KW)
#: the driver runs of (e): (torchrun ranks, arguments)
DRIVER_ARGS = {
    "cnn": ["--workload", "cnn", "--torch-device", "cpu",
            "--device-profile", "mesh:edge-small:2", "--requests", "6",
            "--batch", "2"],
    "lm": ["--workload", "lm", "--torch-device", "cpu", "--requests", "3"]}
DRIVER_TIMEOUT_S = 240


def _driver(args, ranks):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args]
    if ranks:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks), *cmd[1:]]
    env = dict(PYTHONPATH=str(ROOT / "src"), PATH="/usr/bin:/bin",
               OMP_NUM_THREADS="1", HOME=os.environ.get("HOME", "/tmp"),
               TMPDIR=os.environ.get("TMPDIR", "/tmp"))
    return subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worlds and the driver runs, started first; meanwhile the
    single-process port servers on the same stream; then the worlds that
    lose their stream."""
    params_np = jax.tree.map(np.asarray, jcnn.init(jax.random.PRNGKey(0),
                                                   JCFG))
    worlds = serve_worlds(tmp_path_factory.mktemp("serve_mesh"), params_np)
    drivers = {(name, ranks): _driver(args, ranks)
               for name, args in DRIVER_ARGS.items() for ranks in (2, 0)}
    params = cnn.params_from_jax(params_np)
    x = serve_pool()
    tengine.clear_cache()
    single = {}
    for n in SERVE_WORLDS:
        for p in PRECISIONS:
            adapter = tserve.CNNAdapter.from_engine(build(EngineSpec(
                CNNModel(params, CFG, device="cpu"), precision=p,
                device=f"mesh:edge-small:{n}")))
            single[(n, p)] = serve_run(
                tserve, serve_servers(tserve, adapter, SERVE_MAX_BATCH),
                serve_phases(tserve, x, p))
    outs = {}
    for key, proc in drivers.items():
        out, err = proc.communicate(timeout=DRIVER_TIMEOUT_S)
        outs[key] = (proc.returncode, out, err)
    # started once the torchrun runs are done: fewer processes at once
    lost = serve_lost_worlds(tmp_path_factory.mktemp("serve_lost"),
                             params_np)
    yield dict(world=worlds.join(), single=single, drivers=outs,
               params=params, lost=lost.exitcodes())
    tengine.clear_cache()


def _leader(runs, world, precision):
    return runs["world"][str(world)][0][precision]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("world", SERVE_WORLDS)
def test_responses_equal_the_single_process_server(runs, world, precision):
    """(a)"""
    got = _leader(runs, world, precision)
    want = runs["single"][(world, precision)]
    n_bitwise = n_close = 0
    for phase, a, b in serve_pairs(got, want, skip=SERVE_INJECTED):
        what = (world, precision, phase, a["uid"])
        if not serve_same_outcome(a, b, what):
            continue
        rows = b["batch_size"]
        if precision == "fxp16" or rows == 1 or -(-rows // world) >= 2:
            assert torch.equal(a["logits"], b["logits"]), what
            if b["relevance"] is not None:
                assert torch.equal(a["relevance"], b["relevance"]), what
            n_bitwise += 1
        else:
            ltol, rtol = SERVE_TOL[precision]
            serve_close(a["logits"], b["logits"], ltol, what)
            if b["relevance"] is not None:
                serve_close(a["relevance"], b["relevance"], rtol, what)
            n_close += 1
    assert n_bitwise >= 50 and (precision == "fxp16" or n_close > 0)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("world", SERVE_WORLDS)
def test_hits_bitwise_their_cold_explains(runs, world, precision):
    """(c)"""
    got = _leader(runs, world, precision)
    hits = {r["uid"]: r for r in got["hits"]}
    colds = got["colds"]
    assert len(colds) == 7
    for cold in colds:
        hit = hits["p" + cold["uid"][1:]]
        assert hit["cache_hit"] and not cold["cache_hit"]
        assert hit["batch_size"] == cold["batch_size"] == 4
        assert hit["targets"] == cold["targets"]
        assert torch.equal(hit["logits"], cold["logits"])
        assert torch.equal(hit["relevance"], cold["relevance"]), cold["uid"]
    (single,) = got["singleton"]
    cobatched = {r["uid"]: r for r in got["composites"]}["sg0"]
    assert (single["batch_size"], cobatched["batch_size"]) == (1, 4)
    assert torch.equal(single["relevance"], cobatched["relevance"])


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("world", SERVE_WORLDS)
def test_faults_answer_as_errors_and_the_world_goes_on(runs, world,
                                                       precision):
    """(d)"""
    ranks = runs["world"][str(world)]
    got = ranks[0][precision]
    poison = {r["uid"]: r for r in got["poison"]}
    assert poison["bad_shape"] == dict(uid="bad_shape",
                                       raised="InvalidRequestError")
    assert poison["bad_nan"] == dict(uid="bad_nan",
                                     raised="InvalidRequestError")
    assert not poison["bad_target"]["ok"]
    assert poison["bad_target"]["error_type"] == "RuntimeError"
    assert poison["e0"]["ok"]
    # the follower's fault preparing the first composite launch (its
    # explainer): that batch errors, the next composite batch is served
    composites = {r["uid"]: r for r in got["composites"]}
    for uid, r in composites.items():
        assert r["ok"] == (not uid.startswith("ig")), uid
        if uid.startswith("ig"):
            assert r["error_type"] == "RankFault"
    # the follower's fault after the predict's collectives
    assert [(r["uid"], r["ok"], r["error_type"]) for r in got["fault"]] == [
        (f"f{i}", False, "RankFault") for i in range(3)]
    assert all(r["ok"] for r in got["after_fault"])
    stream = got["stream"]
    assert stream["fault"]["calls/predict"] == 1
    if precision != "fxp16":
        # the follower's fault building the fxp16 sibling (a build
        # launch): the first rerouted batch errors, the next is served
        first = {r["uid"]: r for r in got["reroute0"]}
        for i in range(16):
            r = first[f"d0_{i}"]
            assert r["ok"] == (i < 8), r["uid"]
            if i >= 8:
                assert r["error_type"] == "RankFault"
        again = {r["uid"]: r for r in got["reroute1"]}
        assert all(r["ok"] for r in again.values())
        assert [again[f"d1_{i}"]["meta"].get("degraded")
                for i in range(16)] == [None] * 8 + ["reroute_precision"] * 8
        assert stream["reroute0"]["calls/with_precision"] == 1
        assert stream["reroute1"]["calls/with_precision"] == 1
    # every follower joined every launch, and logged what it met
    calls = dict(got["stats"]["calls"])
    for rank in range(1, world):
        fol = ranks[rank][precision]
        assert fol["calls"] == dict(calls, stop=1), rank
        met = [op for op, _ in fol["faults"]]
        want = ["attribute"]            # class 99, on every rank
        if rank == world - 1:
            want = (["attribute"] + want + ["predict"]
                    + (["with_precision"] if precision != "fxp16" else []))
        assert met == want, (rank, met)


@pytest.mark.parametrize("who", sorted(SERVE_LOST))
def test_a_fault_out_of_step_stops_the_world(runs, who):
    """(d) A rank that raises inside its model function leaves the others
    in the engine's gather: no agreement can complete, so every rank ends
    its process with ``LOST_EXIT_CODE`` (none returns, none hangs to the
    harness's timeout and is killed)."""
    from repro_torch.serve import follower
    ranks, _ = SERVE_LOST[who]
    assert runs["lost"][who] == [follower.LOST_EXIT_CODE] * ranks


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("world", SERVE_WORLDS)
def test_only_hit_batches_ship_residuals(runs, world, precision):
    """A cold BP explain replays the predict every rank joined; a hit
    batch's residual tree travels as bytes, its padded rows' worth; a
    launch is 3 or 4 collectives of the stream's own."""
    stream = _leader(runs, world, precision)["stream"]
    one = tserve.CNNAdapter.from_engine(build(EngineSpec(
        CNNModel(runs["params"], CFG, device="cpu"), precision=precision)))
    _, res = one.predict(serve_pool()[:1])
    per_example = sum(t.numel() * t.element_size()
                      for t in trees.leaves(res)
                      if isinstance(t, torch.Tensor))
    # hit batches of 4 (saliency), 3 (deconvnet) and 3 (guided top-3)
    # rows, each padded to 4, and 2 (saliency, class 7)
    assert stream["hits"]["residual_bytes"] == 14 * per_example
    assert stream["followups"]["residual_bytes"] == 5 * per_example
    for phase in ("predict", "colds", "composites", "perturb"):
        assert stream[phase]["residual_bytes"] == 0, phase
    assert stream["colds"]["calls/predict"] == 2
    assert stream["colds"]["calls/explain_cached"] == 2
    for phase, counts in stream.items():
        launches = sum(v for k, v in counts.items()
                       if k.startswith("calls/"))
        payloads = launches - counts.get("calls/engine_for", 0) \
            - counts.get("calls/with_precision", 0)
        # the launch no follower could prepare stopped at its first
        # agreement
        refused = phase == "composites"
        assert counts["collectives"] == 3 * launches + payloads - refused, \
            phase


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("world", SERVE_WORLDS)
def test_replay_harness_runs_on_the_leader(runs, world, precision):
    """``serve.replay``'s ``TimedAdapter`` over the leader's stream
    adapter (its composites on the timed closures, whose engines the
    stream builds on every rank): every request of the trace completes
    with no error, and hits are served; (d) holds the followers to each of
    its launches."""
    rep = _leader(runs, world, precision)["replay"]
    assert rep["offered"] == rep["completed"] == SERVE_REPLAY_N
    assert rep["errors"] == 0 and rep["hit_rate"] > 0


def _counts_line(text, tag):
    line = next(ln for ln in text.splitlines()
                if ln.startswith(f"[serve/{tag}] ") and " responses in " in ln)
    return re.sub(r" in [0-9.]+s \([0-9.]+ req/s\)", "", line)


@pytest.mark.parametrize("workload", ["cnn", "lm"])
def test_torchrun_driver_serves_on_two_ranks(runs, workload):
    """(e)"""
    rc, out, err = runs["drivers"][(workload, 2)]
    rc1, out1, err1 = runs["drivers"][(workload, 0)]
    assert rc == 0, err[-3000:]
    assert rc1 == 0, err1[-3000:]
    assert _counts_line(out, workload) == _counts_line(out1, workload)
    assert "0 errors" in _counts_line(out, workload)
    if workload == "cnn":
        assert "rank 0 leads, 1 follow" in out
        assert re.search(r"call stream over 2 ranks: \d+ launches", out)
    else:
        assert "rank 0 serves alone" in out
