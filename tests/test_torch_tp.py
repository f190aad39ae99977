"""The "model" axis computing on the CPU: the tensor and expert parallel
attribute, prefill and decode steps (``make_*_step(..., mesh=)``).

On gloo worlds of 2 and 4 ranks (``tests/_torch_dist.py``), each over
``make_host_mesh(1, world)``, one SMOKE config of each family of the zoo
(``TP_ARCHS``: dense with a tied head, GQA with 2 KV heads, MoE, mamba,
hybrid, encoder-decoder, vlm, and hymba with 5 query heads over 1 KV head,
whose heads split across the ranks, on the chunked sdpa) runs on each
rank's parameter slices (``shard_params`` of NumPy parameters from a seed,
carried in by ``params_from_jax``), f32:

* the attribute step's last logits within ``TOL["logits"]`` of max and its
  ixg and contrastive scores within ``TOL["scores"]`` of max of the
  single-process port's; the 4-way ixg step, for one config of each
  family, against the JAX package's unsharded step likewise;
* the prefill and decode steps' greedy tokens equal, the final cache
  (gathered over the model group) within ``TOL["logits"]`` of each leaf's
  max;
* every rank returns the same bits; ``gather_params(shard_params(p))`` is
  ``p`` bit for bit; the routed experts (no shared expert) are bitwise the
  single-process MoE's; a mesh whose model axis is 1 (a replicated
  ``(1, 1)`` mesh in the same world) runs the plain step, bit for bit.

The ranks sum partial products in another order than one device's
products, hence the tolerances.  A batch below the data-parallel size
(sequence-parallel decode) raises naming ROADMAP A12d.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import tree as trees
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as tf

from _torch_dist import (TP_ARCHS, TP_NEW, lm_outputs, routed_experts,
                         start_worlds, tp_batch, tp_config, tp_params_np)
from _torch_zoo import reference

TOL = dict(logits=1e-5, scores=1e-4)
WORLDS = (2, 4)
MODES = ("ixg", "contrastive")
#: one config of each family, held against the JAX package
FAMILIES = TP_ARCHS[:-1]


def jax_config(name):
    arch, _, variant = name.partition(":")
    cfg = jconfigs.get_smoke(arch)
    if variant == "split":
        cfg = cfg.with_(n_heads=5, n_kv=1, attn_chunk_threshold=4,
                        attn_chunk=4)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params_np = {name: tp_params_np(tp_config(name)) for name in TP_ARCHS}
    worlds = start_worlds(tmp_path_factory.mktemp("tp"), {
        f"m{w}": ("tp_scenario", w, dict(params_np=params_np, model=w))
        for w in WORLDS})
    single = {name: lm_outputs(tp_config(name),
                               tf.params_from_jax(params_np[name]),
                               tp_batch(tp_config(name)))
              for name in TP_ARCHS}
    return params_np, single, worlds


@pytest.fixture(scope="module")
def ranks(setup):
    return setup[2].join()


def rel(got, want):
    got, want = got.double(), want.double()
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got - want).abs().max() / max(want.abs().max(), 1e-30))


@pytest.mark.parametrize("name", TP_ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_attribute_step_matches_single_process(setup, ranks, world, name):
    got, want = ranks[f"m{world}"][0][name], setup[1][name]
    for mode in MODES:
        assert rel(got[mode][0], want[mode][0]) <= TOL["logits"], mode
        assert rel(got[mode][1], want[mode][1]) <= TOL["scores"], mode


@pytest.mark.parametrize("name", TP_ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_prefill_and_decode_match_single_process(setup, ranks, world, name):
    got, want = ranks[f"m{world}"][0][name], setup[1][name]
    assert got["tokens"].dtype == torch.int32
    assert tuple(got["tokens"].shape) == (2, TP_NEW)
    assert torch.equal(got["tokens"], want["tokens"])
    for (path, a), b in zip(trees.walk(got["cache"]),
                            trees.leaves(want["cache"])):
        assert a.dtype == b.dtype, path
        assert rel(a, b) <= TOL["logits"], path


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_return_the_same_bits(ranks, world):
    first = ranks[f"m{world}"][0]
    assert first["mesh"] == f"Mesh(data=1, model={world}, group)"
    for r, other in enumerate(ranks[f"m{world}"]):
        assert other["model"] == (r, world)
        for name in TP_ARCHS:
            for a, b in zip(trees.leaves(first[name]),
                            trees.leaves(other[name])):
                if isinstance(a, torch.Tensor):
                    assert torch.equal(a, b), (r, name)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_of_shard_is_bitwise(ranks, world):
    for r in ranks[f"m{world}"]:
        assert all(r[name]["roundtrip"] for name in TP_ARCHS)
        assert r["product_group"] == (world, r["model"][0])


@pytest.mark.parametrize("world", WORLDS)
def test_routed_experts_are_bitwise(setup, ranks, world):
    name = "moonshot-v1-16b-a3b"
    want = routed_experts(tf.params_from_jax(setup[0][name]),
                          tp_config(name))
    out, aux = ranks[f"m{world}"][0][name]["routed"]
    assert torch.equal(out, want[0]) and torch.equal(aux, want[1])


@pytest.mark.parametrize("world", WORLDS)
def test_model_axis_of_one_is_the_plain_step(setup, ranks, world):
    for name, got in ranks[f"m{world}"][0]["ones"].items():
        for a, b in zip(trees.leaves(got), trees.leaves(setup[1][name])):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("name", FAMILIES)
def test_attribute_step_matches_jax(setup, ranks, name):
    """The 4-way ixg step against the JAX package's unsharded step (the
    MoE: ``repro``'s transformer on ``first_c_moe_ffn``, ROADMAP C)."""
    jcfg = jax_config(name)
    jp = jax.tree.map(jax.numpy.asarray, setup[0][name])
    batch = {k: jax.numpy.asarray(v) for k, v in
             tp_batch(tp_config(name)).items()}
    got = ranks["m4"][0][name]
    with reference():
        logits, scores = jax.jit(jsteps.make_attribute_step(jcfg))(jp, batch)
    assert rel(got["ixg"][0], torch.from_numpy(
        np.array(logits))) <= TOL["logits"]
    assert rel(got["ixg"][1], torch.from_numpy(
        np.array(scores))) <= TOL["scores"]


def test_decode_tokens_match_jax(setup, ranks):
    """llama3.2-1b's 4-way prefill and decode tokens are the JAX
    package's."""
    name = "llama3.2-1b"
    jcfg = jax_config(name)
    jp = jax.tree.map(jax.numpy.asarray, setup[0][name])
    toks = tp_batch(tp_config(name))["tokens"]
    cache = jtf.init_cache(jcfg, toks.shape[0], toks.shape[1] + TP_NEW)
    nxt, cache = jsteps.make_prefill_step(jcfg)(
        jp, {"tokens": jax.numpy.asarray(toks)}, cache)
    want = [np.asarray(nxt)]
    decode = jsteps.make_decode_step(jcfg)
    for i in range(TP_NEW - 1):
        nxt, cache = decode(jp, cache, nxt, toks.shape[1] + i)
        want.append(np.asarray(nxt))
    np.testing.assert_array_equal(ranks["m4"][0][name]["tokens"].numpy(),
                                  np.concatenate(want, axis=1))


class _TwoDataRanks(Mesh):
    """A ``(2, 1)`` mesh whose batch group claims two ranks, with no
    process group behind it: the cache refuses before any collective."""

    def __init__(self):
        self.shape, self.axis_names = (2, 1), ("data", "model")
        self.device_mesh = object()

    def axes_group(self, names):
        return (object(), 0, 2) if "data" in names else (None, 0, 1)


def test_sequence_parallel_cache_is_a12d():
    """A batch below the data-parallel size shards the cache's T axis
    (``cache_shardings``' small-batch branch): refused, naming A12d."""
    cfg = tp_config("llama3.2-1b")
    with pytest.raises(NotImplementedError, match="A12d"):
        tf.init_cache(cfg, 1, 16, device="cpu", mesh=_TwoDataRanks())
    cache = tf.init_cache(cfg, 3, 16, device="cpu", mesh=_TwoDataRanks())
    assert tuple(cache[0]["k"].shape) == (2, 2, 16, cfg.n_kv * cfg.hd)


class _ModelRanks(Mesh):
    """A ``(1, ways)`` mesh whose model group claims ``ways`` ranks, with
    no process group behind it: the steps are built, never run."""

    def __init__(self, ways):
        self.shape, self.axis_names = (1, ways), ("data", "model")
        self.device_mesh = object()

    def axes_group(self, names):
        ways = self.shape[1]
        return (object(), 0, ways) if names == ("model",) else (None, 0, 1)


@pytest.mark.parametrize("ways", (1, 2, 4))
def test_scan_is_planned_at_a_rank_s_channels(ways):
    """The B13 launches of a model rank cover ``d_inner / ways`` channels:
    the unplanned ``d_tile = d_inner`` launches what a rank's own width
    does (the kernel clamps it); a planned tile that does not divide a
    rank's channels (a tile of 640 of hymba-1.5b's 3200 at 2 and 4 ways)
    is refused where the step is made; one of 160 runs at any way."""
    from repro_torch import configs
    from repro_torch.kernels.ssm_scan.ssm_scan import fwd_channels
    from repro_torch.launch import steps
    cfg = configs.get("hymba-1.5b")
    local = cfg.d_inner // ways
    tiles = steps.ssm_scan_tiles(cfg)
    assert set(tiles.values()) == {(cfg.d_inner, cfg.ssm_chunk)}
    assert fwd_channels(cfg.d_inner, local) == fwd_channels(local, local)
    mesh = _ModelRanks(ways)

    def plan(d_tile):
        return {f"ssm{si}.scan": SimpleNamespace(d_tile=d_tile, chunk=64)
                for si in tiles}

    steps.make_attribute_step(cfg, plan=plan(160), mesh=mesh)
    if ways == 1:
        steps.make_attribute_step(cfg, plan=plan(640), mesh=mesh)
    else:
        with pytest.raises(ValueError, match="d_tile=640"):
            steps.make_attribute_step(cfg, plan=plan(640), mesh=mesh)
