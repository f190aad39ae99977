"""The data-parallel CNN engine (``EngineSpec(device="mesh:<p>:<n>")``) on
the CPU.

* In one process (no process group) the mesh has one rank:
  ``mesh:edge-small:1`` is the single-device engine bit for bit, logits,
  relevance, residuals and replays (twins of ``tests/test_engine.py::
  {test_one_shard_mesh_engine_is_bitwise_single_device,
  test_mesh_engine_forward_replay_roundtrip}``), and ``mesh:edge-small:4``
  reports 4 shards and matches (twin of
  ``test_four_shard_mesh_engine_serves_and_matches``, bitwise here).
* On 2 and 3 gloo ranks (``tests/_torch_dist.py``), at a batch of 5 that
  neither divides, each rank's sharded engine gives the single-process
  engine's bits in f32, bf16 and fxp16, for every rule set: explain
  (top-2), forward then replay, predict, integrated gradients (a
  composite, through autograd on f32 / bf16), the vjp backend's explain
  and the occlusion fold; residuals cross both ways (the sharded engine
  replays the single-process engine's residuals and the other way round).
  Every rank runs ``ceil(5 / n)`` rows a launch (a spy on the model).
"""
import pytest
import torch

from repro_torch import engine as tengine
from repro_torch.engine import CNNModel, EngineSpec, TopK, build
from repro_torch.launch.mesh import make_serving_mesh

from _torch_dist import (METHODS, PRECISIONS, cnn_setup, engine_outputs,
                         run_worlds)

KEYS = ("logits", "rel", "predict", "ig", "forward", "replay")
WORLDS = (2, 3)


@pytest.fixture(scope="module")
def setup():
    tengine.clear_cache()
    yield cnn_setup()
    tengine.clear_cache()


@pytest.fixture(scope="module")
def single(setup):
    cfg, params, x = setup
    out = {}
    for p in PRECISIONS:
        for m in METHODS:
            out[(p, m)] = engine_outputs(params, cfg, x, p, m)
            if p != "fxp16" and m == "guided":
                out[(p, m)]["vjp"] = engine_outputs(params, cfg, x, p, m,
                                                    backward="vjp")
            eng = build(EngineSpec(CNNModel(params, cfg, device="cpu"),
                                   method=m, precision=p))
            out[(p, m)]["occlusion"] = eng.perturb(
                x, method="occlusion", window=4, stride=4)[1]
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("dp_engine"),
                      {str(n): ("engine_scenario", n, {}) for n in WORLDS})


# -- one process: the mesh has one rank ---------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
def test_one_shard_mesh_engine_is_bitwise_single_device(setup, single,
                                                        precision):
    cfg, params, x = setup
    got = engine_outputs(params, cfg, x, precision, "guided",
                         device="mesh:edge-small:1")
    want = single[(precision, "guided")]
    assert got["n_shards"] == 1 and got["mesh"] == "Mesh(data=1)"
    assert want["n_shards"] == 1 and want["mesh"] == "None"
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


def test_mesh_engine_forward_replay_roundtrip(setup):
    cfg, params, x = setup
    e0 = build(EngineSpec(CNNModel(params, cfg, device="cpu"),
                          device="edge-small"))
    e1 = build(EngineSpec(CNNModel(params, cfg, device="cpu"),
                          device="mesh:edge-small:1"))
    l0, r0 = e0.forward(x)
    l1, r1 = e1.forward(x)
    assert torch.equal(l0, l1)
    seeds = torch.nn.functional.one_hot(l0.argmax(-1), cfg.num_classes)[None]
    assert torch.equal(e0.replay(r0, seeds), e1.replay(r1, seeds))
    assert torch.equal(e0.replay(r1, seeds), e1.replay(r0, seeds))


def test_four_shard_mesh_engine_serves_and_matches(setup, single):
    cfg, params, x = setup
    got = engine_outputs(params, cfg, x, "f32", "saliency",
                         device="mesh:edge-small:4")
    assert got["n_shards"] == 4
    assert got["mesh"] == repr(make_serving_mesh(4)) == "Mesh(data=1)"
    for k in KEYS:
        assert torch.equal(got[k], single[("f32", "saliency")][k]), k


def test_lm_engine_on_a_mesh_builds_unsharded():
    """As in the JAX package: an LM engine on a mesh device builds
    without sharding."""
    from repro_torch import configs
    from repro_torch.engine import LMModel
    from repro_torch.models import transformer as tf
    cfg = configs.get_smoke("llama3.2-1b")
    p = tf.init(cfg, generator=torch.Generator().manual_seed(0),
                device="cpu")
    eng = build(EngineSpec(LMModel(p, cfg, device="cpu"),
                           device="mesh:edge-small:2"))
    assert eng.n_shards == 1 and eng.mesh is None


# -- gloo worlds ---------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_sharded_engine_is_bitwise_single_process(worlds, single, world,
                                                  precision, method):
    want = single[(precision, method)]
    for rank, out in enumerate(worlds[str(world)]):
        got = out[(precision, method)]
        assert got["n_shards"] == world
        assert got["mesh"] == f"Mesh(data={world}, group)"
        for k in KEYS + ("occlusion",):
            assert torch.equal(got[k], want[k]), (rank, k)
        if "vjp" in want:
            for k in ("logits", "rel", "predict", "ig"):
                assert torch.equal(got["vjp"][k], want["vjp"][k]), (rank, k)


@pytest.mark.parametrize("world", WORLDS)
def test_residuals_cross_both_ways(worlds, single, setup, world):
    """The sharded engine's residuals are the whole batch's: the
    single-process engine replays them to its own relevance, and the
    sharded engine replays the single-process engine's."""
    cfg, params, _ = setup
    for precision in PRECISIONS:
        want = single[(precision, "guided")]
        eng = build(EngineSpec(CNNModel(params, cfg, device="cpu"),
                               method="guided", precision=precision,
                               targets=TopK(2)))
        for out in worlds[str(world)]:
            got = out[(precision, "guided")]
            assert torch.equal(got["replay_single"], want["replay"])
            assert torch.equal(eng.replay(got["residuals"], got["seeds"]),
                               want["replay"])


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_runs_its_rows(worlds, world):
    """Spies on the model's pair in each rank: every launch of the sharded
    engine (explain: forward, backward; forward) ran ``ceil(5 / world)``
    rows, on contiguous operands (the CUDA kernels take no strides; a
    seeds slice along the batch axis is strided)."""
    per = -(-5 // world)
    for out in worlds[str(world)]:
        assert out["rows_seen"] == [per, per, per]
        assert out["contiguous"] == [True, True, True]

