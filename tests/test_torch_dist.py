"""repro_torch.dist and repro_torch.launch.mesh against repro.dist and
repro.launch.mesh (CPU).

* ``spec_tree`` equals ``repro.dist.params.spec_tree`` leaf for leaf for
  every arch of ``configs.ARCHS`` at full size: the JAX side from
  ``jax.eval_shape``, the port's from ``tf.init`` under a fake-tensor mode
  (shapes and dtypes, no storage; ``tf.init`` draws on a generator, which
  has no ``meta`` device), and from ``ShapeDtype`` leaves.
* Twins of ``tests/test_sharding.py``: the 16-way divisibility of every
  arch, the MoE, attention and mamba specs, ``physical_spec`` dropping
  absent axes, ``constrain`` the identity without a mesh, the serving
  mesh replicating absent axes (and ``physical_spec`` equal to the JAX
  package's for every logical spec on each mesh shape).
* The mesh builders: capped at the world size, one rank and no group
  without a process group; the production meshes name the ranks they
  need.
* On 2 gloo ranks (``tests/_torch_dist.py``), ``distribute_tensor`` with
  ``param_sharding_tree``'s placements splits a SMOKE llama3.2-1b tree
  over a ``(1, 2)`` host mesh (the model-axis leaves halved), and
  ``full_tensor()`` gives every leaf back bit for bit.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as jconfigs
from repro.dist import params as jparams
from repro.dist import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch import tree as trees
from repro_torch.dist import params as dist_params
from repro_torch.dist import sharding as dist_sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tf

from _torch_dist import placement_groups, start_worlds

MODEL_WAYS = 16


def _fake_params(cfg):
    with FakeTensorMode():
        return tf.init(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")


def _path(jpath):
    return tuple(f"k:{k.key}" if hasattr(k, "key") else f"i:{k.idx}"
                 for k in jpath)


def _port_specs(params):
    """``{path: (shape, spec)}`` from ``spec_tree(params)``, each spec
    read at its leaf's path."""
    specs = dist_params.spec_tree(params)
    out = {}
    for path, leaf in trees.walk(params):
        node = specs
        for entry in path:
            kind, key = entry[0], entry[2:]
            node = node[key] if kind == "k" else node[int(key)]
        out[path] = (tuple(leaf.shape), node)
    return out


@pytest.fixture(scope="module")
def dtensor_world(tmp_path_factory):
    """The 2-rank DTensor world, started first so that it runs while this
    process builds the full-size shapes."""
    return start_worlds(tmp_path_factory.mktemp("dtensor"),
                        {"d": ("dtensor_scenario", 2, {})})


@pytest.fixture(scope="module")
def full_specs(dtensor_world):
    out = {}
    for arch in configs.ARCHS:
        params = _fake_params(configs.get(arch))
        out[arch] = (params, _port_specs(params))
    return out


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_spec_tree_equals_reference(full_specs, arch):
    params, got = full_specs[arch]
    sds = jax.eval_shape(lambda k: jtf.init(k, jconfigs.get(arch)),
                         jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(sds)
    specs = jax.tree.leaves(jparams.spec_tree(sds),
                            is_leaf=lambda s: isinstance(s, P))
    want = {_path(p): (tuple(leaf.shape), tuple(s))
            for (p, leaf), s in zip(flat, specs)}
    assert got == want
    # the rules read shapes only: ShapeDtype leaves give the same specs
    shapes = trees.tree_map(
        lambda t: dist_params.ShapeDtype(tuple(t.shape), t.dtype), params)
    assert _port_specs(shapes) == got


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_model_axis_dims_divide_16(full_specs, arch):
    """Every dim the rules put on the 16-way "model" axis divides."""
    _, specs = full_specs[arch]
    for path, (shape, spec) in specs.items():
        for dim, ax in enumerate(spec):
            if ax == "model":
                assert shape[dim] % MODEL_WAYS == 0, (arch, path, dim)


def _segment0(full_specs, arch, *keys):
    _, specs = full_specs[arch]
    return specs[("k:segments", "i:0") + tuple(f"k:{k}" for k in keys)][1]


def test_moe_experts_on_model_axis(full_specs):
    arch = "llama4-scout-17b-a16e"
    assert _segment0(full_specs, arch, "ffn", "w1") == \
        (None, "model", None, None)                      # [L, E, d, f]
    assert _segment0(full_specs, arch, "ffn", "shared", "w1") == \
        (None, None, "model")


def test_attention_specs(full_specs):
    arch = "qwen2-1.5b"
    assert _segment0(full_specs, arch, "attn", "wq") == (None, None, "model")
    assert _segment0(full_specs, arch, "attn", "wo") == (None, "model", None)
    assert _segment0(full_specs, arch, "attn", "bq") == (None, "model")
    assert _segment0(full_specs, arch, "norm1", "w") == (None, None)


def test_mamba_specs(full_specs):
    arch = "falcon-mamba-7b"
    assert _segment0(full_specs, arch, "mixer", "in_proj") == \
        (None, None, "model")
    assert _segment0(full_specs, arch, "mixer", "out_proj") == \
        (None, "model", None)
    assert _segment0(full_specs, arch, "mixer", "A_log") == \
        (None, "model", None)


class _Axes:
    """A mesh's axis names alone (what ``physical_spec`` reads)."""

    def __init__(self, *names):
        self.axis_names = names


LOGICAL = [("batch", None, "model"), ("seeds", "batch"), ("model",),
           ("expert", None), (None, "data", "model"), ("batch",), ()]


@pytest.mark.parametrize("axes", [("data", "model"),
                                  ("pod", "data", "model"), ("data",)])
def test_physical_spec_equals_reference(axes):
    jm = jax.make_mesh((1,) * len(axes), axes)
    for logical in LOGICAL:
        assert dist_sharding.physical_spec(logical, _Axes(*axes)) == \
            tuple(jsharding.physical_spec(logical, jm)), logical


def test_physical_spec_filters_missing_axes():
    mesh = tmesh.make_host_mesh(1, 1)
    assert dist_sharding.physical_spec(("batch", None, "model"), mesh) == \
        ("data", None, "model")


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    axes = _Axes("pod", "data", "model")
    spec = dist_sharding.physical_spec(("batch", None, "model"), axes)
    assert spec == (("pod", "data"), None, "model")
    assert dist_sharding.placements(spec, axes) == (Shard(0), Shard(0),
                                                    Shard(2))
    assert dist_sharding.placements((), axes) == (Replicate(),) * 3


def test_constrain_is_noop_without_mesh():
    x = torch.ones(4, 4)
    assert dist_sharding.constrain(x, "batch", "model") is x
    with dist_sharding.use_mesh(tmesh.make_serving_mesh(1)) as m:
        assert dist_sharding.current_mesh() is m
        assert dist_sharding.constrain(x, "batch", None) is x
    assert dist_sharding.current_mesh() is None


def test_serving_mesh_replicates_absent_axes():
    mesh = tmesh.make_serving_mesh(4)        # capped at the world: 1 rank
    assert mesh.axis_names == ("data",) and mesh.shape == (1,)
    assert not mesh.has_group and mesh.device_mesh is None
    assert dist_sharding.physical_spec(("batch", None), mesh) == \
        ("data", None)
    assert dist_sharding.physical_spec(("seeds", "batch"), mesh) == \
        (None, "data")
    assert dist_sharding.physical_spec(("model",), mesh) == (None,)
    with pytest.raises(ValueError):
        tmesh.make_serving_mesh(0)
    with pytest.raises(ValueError):
        jmesh.make_serving_mesh(0)


def test_mesh_builders_without_a_group():
    """Capped at the one rank there is, as the JAX package's at its one
    device; the production meshes need 256 / 512 ranks."""
    assert tmesh.world_size() == 1 and not tmesh.initialized()
    for data, model in ((1, 1), (4, 1), (2, 8)):
        m, jm = tmesh.make_host_mesh(data, model), \
            jmesh.make_host_mesh(data, model)
        assert m.shape == tuple(jm.devices.shape) == (1, 1)
        assert m.axis_names == tuple(jm.axis_names)
        assert dist_sharding.local_rows(m, 7) == (0, 7)
        assert dist_sharding.batch_group(m) == (None, 0, 1)
    assert tmesh.make_host_mesh(1, 1) is tmesh.make_host_mesh(1, 1)
    for multi, ranks in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {ranks} ranks; the "
                                             f"world has 1"):
            tmesh.make_production_mesh(multi_pod=multi)
    with pytest.raises(ValueError, match="process group"):
        tmesh.Mesh((2,), ("data",))
    x = torch.arange(6.0)
    assert dist_sharding.gather_rows(tmesh.make_serving_mesh(1), x, 6) is x


@pytest.fixture(scope="module")
def dtensor(dtensor_world):
    return dtensor_world.join()["d"]


def test_param_sharding_tree_splits_and_rebuilds(dtensor):
    cfg = configs.get_smoke("llama3.2-1b")
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    specs = _port_specs(params)
    for rank in range(2):
        out = dtensor[rank]
        assert out["mesh"] == "Mesh(data=1, model=2, group)"
        assert set(out["leaves"]) == set(specs)
        for path, (local, rebuilt, pls) in out["leaves"].items():
            shape, spec = specs[path]
            want = list(shape)
            if "model" in spec:
                want[spec.index("model")] //= 2
            assert local == tuple(want), path
            assert rebuilt, path
            assert pls[0] == "Replicate()"
            assert pls[1] == ("Replicate()" if "model" not in spec else
                              f"Shard(dim={spec.index('model')})")


def test_placement_groups_match_spec_tree():
    """``param_sharding_tree`` is ``placements(physical_spec(spec))`` of
    each leaf of ``spec_tree``."""
    cfg = configs.get_smoke("moonshot-v1-16b-a3b")
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    mesh = tmesh.make_host_mesh(1, 1)
    pls = placement_groups(dist_params.param_sharding_tree(params, mesh))
    for path, (_, spec) in _port_specs(params).items():
        assert pls[path] == dist_sharding.placements(
            dist_sharding.physical_spec(spec, mesh), mesh)
