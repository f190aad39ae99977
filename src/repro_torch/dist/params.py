"""Name-based parameter sharding rules for the whole model zoo, as
``repro.dist.params`` has them.

One table instead of per-arch spec trees: a leaf's NAME (last dict key on
its tree path) plus its rank decide the spec.  Column-parallel
projections shard their output dim on "model", row-parallel ones their
input dim; MoE expert stacks ([L, E, d, f]) shard the expert axis
("model" carries EP); everything unnamed replicates.  Leading layer axes
of the stacked segments are padded with ``None``.

A spec is a tuple with one entry per dim (a logical axis or None), equal
to ``tuple()`` of the JAX package's ``PartitionSpec``.  The rules read
only a leaf's ``ndim``, so they run over tensors (``meta`` tensors too)
and over any leaf with a ``shape`` (:class:`ShapeDtype`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from repro_torch import tree as trees
from repro_torch.dist.sharding import physical_spec, placements

# output dim ("model" last): qkv projections, up/gate FFN, SSM in/dt/conv
_COL = ("wq", "wk", "wv", "w1", "w3", "in_proj", "dt_proj", "conv_w")
# input dim ("model" second-to-last): down/out projections, SSM dynamics
_ROW = ("wo", "w2", "out_proj", "x_proj", "A_log")
# per-output-channel vectors riding the column-parallel shards
_VEC = ("bq", "bk", "bv", "conv_b", "dt_bias", "D")
# expert stacks [L, E, d, f]: expert-parallel on E
_MOE = ("w1", "w2", "w3")

_leaf_name = trees.leaf_name


@dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype without its data (the twin of
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: Any = None

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _leaf_spec(path, leaf) -> Tuple:
    name = _leaf_name(path)
    nd = len(leaf.shape)
    if name in _MOE and nd >= 4:
        return (None,) * (nd - 3) + ("model", None, None)
    if name in _COL and nd >= 2:
        return (None,) * (nd - 1) + ("model",)
    if name in _ROW and nd >= 2:
        return (None,) * (nd - 2) + ("model", None)
    if name in _VEC and nd >= 1:
        return (None,) * (nd - 1) + ("model",)
    if name in ("table", "head") and nd == 2:
        # embed table d-sharded; head V-sharded
        return (None, "model")
    return (None,) * nd


def spec_tree(params):
    """A tree shaped like ``params`` whose leaves are the logical specs."""
    return trees.map_with_path(_leaf_spec, params)


def param_sharding_tree(params, mesh):
    """DTensor placements per leaf: the twin of the JAX package's
    ``NamedSharding`` tree (``physical_spec`` of each spec on ``mesh``,
    then :func:`~repro_torch.dist.sharding.placements`)."""
    return trees.map_with_path(
        lambda path, leaf: placements(
            physical_spec(_leaf_spec(path, leaf), mesh), mesh), params)
