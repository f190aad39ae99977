"""The data-parallel train step (``make_train_step(..., mesh=)``) on the
CPU.

On 2 gloo ranks (``tests/_torch_dist.py``) over ``make_host_mesh(2, 1)``,
3 steps of llama3.2-1b SMOKE (dense) and falcon-mamba-7b SMOKE (mamba) on
global batches of 5 rows (3 + 2) equal the single-process steps on the
same batches from the same state: loss and gnorm within ``TOL`` relative,
params and both moments within ``TOL`` of each leaf's max |single|, after
the last step; every rank holds the same state bit for bit.  The ranks sum
their gradients in another order than the single process's one backward
over all rows, hence a tolerance: ``TOL = 1e-5``.

An MoE routes each rank's tokens on its own, so its capacity and aux loss
differ from the single-process step's by design (ROADMAP C): the
data-parallel gradient of moonshot-v1-16b-a3b SMOKE is held to the
row-weighted sum of the single-process gradients of each rank's slice,
within ``TOL`` of each leaf's max.

The sharding trees (DTensor placements) of ``launch/steps.py`` equal the
JAX package's ``NamedSharding`` trees' specs.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import repro.configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch import tree as trees
from repro_torch.data import host_shard_bounds
from repro_torch.dist.sharding import placements
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh, make_host_mesh

from _torch_dist import (MOE_ARCH, TRAIN_ARCHS, TRAIN_BATCH, run_worlds,
                         step_grads, token_batches, train_run)

TOL = 1e-5
WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("dp_train"),
                      {"t": ("train_scenario", WORLD, {})})["t"]


def _leafwise(got, want):
    """The worst ``max|got - want| / max|want|`` over the leaves."""
    worst = 0.0
    for a, b in zip(trees.leaves(got), trees.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        ref = b.abs().max().item()
        worst = max(worst, (a - b).abs().max().item() / max(ref, 1e-30))
    return worst


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_data_parallel_steps_match_single_process(ranks, arch):
    state, metrics = train_run(configs.get_smoke(arch))
    for rank in range(WORLD):
        got, got_m = ranks[rank][arch]
        assert ranks[rank]["mesh"] == "Mesh(data=2, model=1, group)"
        for m, g in zip(metrics, got_m):
            for k in ("loss", "ce", "gnorm"):
                assert abs(g[k] - m[k]) <= TOL * abs(m[k]), (k, g[k], m[k])
            assert g["lr"] == m["lr"]
        assert int(got.opt.step) == int(state.opt.step) == 3
        for name, a, b in (("params", got.params, state.params),
                           ("mu", got.opt.mu, state.opt.mu),
                           ("nu", got.opt.nu, state.opt.nu)):
            assert _leafwise(a, b) <= TOL, name


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_ranks_hold_the_same_state(ranks, arch):
    a, b = ranks[0][arch][0], ranks[1][arch][0]
    for x, y in zip(steps_leaves(a), steps_leaves(b)):
        assert torch.equal(x, y)


def steps_leaves(state):
    return trees.leaves(state.params) + trees.leaves(state.opt.mu) + \
        trees.leaves(state.opt.nu) + [state.opt.step]


def test_moe_gradient_is_the_row_weighted_slice_sum(ranks):
    cfg = configs.get_smoke(MOE_ARCH)
    batch = token_batches(cfg)[0]
    want = None
    for r in range(WORLD):
        lo, hi = host_shard_bounds(TRAIN_BATCH, r, WORLD)
        g = step_grads(cfg, {k: v[lo:hi] for k, v in batch.items()})
        part = trees.tree_map(lambda t: t * ((hi - lo) / TRAIN_BATCH), g)
        want = part if want is None else trees.unflatten(
            want, [x + y for x, y in zip(trees.leaves(want),
                                         trees.leaves(part))])
    for r in range(WORLD):
        assert _leafwise(ranks[r]["moe_grads"], want) <= TOL
    # and the single process over all rows routes differently
    whole = step_grads(cfg, batch)
    assert _leafwise(whole, want) > TOL


def test_one_rank_mesh_is_the_plain_step():
    """Without a process group the mesh has one rank: the step is the
    single-device step, bit for bit."""
    cfg = configs.get_smoke("llama3.2-1b")
    a, ma = train_run(cfg)
    b, mb = train_run(cfg, make_host_mesh(1, 1))
    assert ma == mb
    for x, y in zip(steps_leaves(a), steps_leaves(b)):
        assert torch.equal(x, y)


def test_two_way_model_mesh_runs_the_train_step():
    """A ``(1, 2)`` mesh builds the train step and runs it; without a
    process group behind it the model axis has one rank that computes
    (``model_group``), so the step is the plain step, bit for bit (the
    two-way step on gloo ranks: ``tests/test_torch_tp_train.py``)."""
    class TwoWay(Mesh):
        def __init__(self):
            self.shape, self.axis_names = (1, 2), ("data", "model")
            self.device_mesh = None
    cfg = configs.get_smoke("llama3.2-1b")
    a, ma = train_run(cfg)
    b, mb = train_run(cfg, TwoWay())
    assert ma == mb
    for x, y in zip(steps_leaves(a), steps_leaves(b)):
        assert torch.equal(x, y)


def _path(jpath):
    """A JAX key path as the port's tree path (``repro_torch.tree``)."""
    out = []
    for k in jpath:
        if hasattr(k, "key"):
            out.append(f"k:{k.key}")
        elif hasattr(k, "idx"):
            out.append(f"i:{k.idx}")
        else:
            out.append(f"n:{k.name}")
    return tuple(out)


def _reference(jtree, mesh):
    """``{path: the port's placements of the JAX package's spec}``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda s: isinstance(s, NamedSharding))
    return {_path(p): tuple(map(repr, placements(tuple(s.spec), mesh)))
            for p, s in flat}


def _port(tree):
    out = {}
    for path, pl in trees.walk(tree):
        out.setdefault(path[:-1], []).append(repr(pl))
    return {k: tuple(v) for k, v in out.items()}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b",
                                  "moonshot-v1-16b-a3b"])
def test_sharding_trees_equal_reference(arch):
    """``state_shardings``, ``batch_shardings`` and ``cache_shardings``
    (large and small batch) give the placements of the JAX package's
    specs, leaf for leaf, on a (1, 1) host mesh."""
    jmesh = jmake_host_mesh(1, 1)
    mesh = make_host_mesh(1, 1)
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jstate = jax.eval_shape(jsteps.make_train_state_init(jcfg),
                            jax.random.PRNGKey(0))
    state = steps.make_train_state_init(cfg)(
        torch.Generator().manual_seed(0), "cpu")
    assert _port(steps.state_shardings(state, mesh)) == _reference(
        jsteps.state_shardings(jstate, jmesh), mesh)
    batch = token_batches(cfg, steps=1)[0]
    jb = {k: jax.ShapeDtypeStruct(v.shape, np.int32)
          for k, v in batch.items()}
    assert {(f"k:{k}",): tuple(map(repr, v)) for k, v in
            steps.batch_shardings(batch, mesh).items()} == _reference(
        jsteps.batch_shardings(jb, jmesh), mesh)
    from repro_torch.models import transformer as tf
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, 2, 16))
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    for bsz in (2, 0):
        assert _port(steps.cache_shardings(cfg, cache, mesh, bsz)) == \
            _reference(jsteps.cache_shardings(jcfg, jcache, jmesh, bsz),
                       mesh)
