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

:func:`shard_params` cuts each rank's slice of a full tree by these specs
(the explicit-SPMD twin of placing it by :func:`param_sharding_tree`), and
:func:`gather_params` puts the full tree back together, bit for bit.  The
tree keeps the JAX package's layout, so checkpoints and
``params_from_jax`` never see the slicing.  One leaf is FUSED: a mamba
``in_proj`` ``[..., d, 2 * d_inner]`` holds ``xin | z``
(``models/mamba.py``), so a rank's slice is its channels of each half side
by side, ``[..., d, 2 * d_inner / ways]``; no other leaf of the zoo fuses
two column-parallel outputs (``x_proj``'s ``dt | B | C`` output is not
sharded: the leaf is row-parallel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as trees
from repro_torch.dist.sharding import (gather_dim, model_group, physical_spec,
                                       placements)

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


#: Leaves whose sharded dim joins two halves, each split on its own.
_FUSED = ("in_proj",)


def _model_dim(path, leaf, mesh):
    """The dim of ``leaf`` the mesh's "model" axis splits, or None."""
    spec = physical_spec(_leaf_spec(path, leaf), mesh)
    return spec.index("model") if "model" in spec else None


def sharded_leaf(path, leaf, mesh) -> bool:
    """Whether the mesh's "model" axis splits the leaf at ``path``."""
    return _model_dim(path, leaf, mesh) is not None


def _halves(path, leaf) -> int:
    return 2 if _leaf_name(path) in _FUSED else 1


def shard_params(full, mesh):
    """This rank's slice of every leaf of ``full`` (params, or a moment
    tree shaped like them) along the dim its spec puts on "model": the
    contiguous block ``coordinate`` of ``ways`` (of each half, for a fused
    leaf).  Other leaves are kept as they are; without a model axis that
    computes the tree comes back unchanged."""
    _, coord, ways = model_group(mesh)
    if ways == 1:
        return full

    def cut(path, leaf):
        dim = _model_dim(path, leaf, mesh)
        if dim is None:
            return leaf
        halves = _halves(path, leaf)
        n = leaf.shape[dim] // halves
        if n * halves != leaf.shape[dim] or n % ways:
            raise ValueError(f"{'/'.join(path)}: dim {dim} of "
                             f"{tuple(leaf.shape)} does not split "
                             f"{ways} ways ({halves} halves)")
        per = n // ways
        return torch.cat([leaf.narrow(dim, h * n + coord * per, per)
                          for h in range(halves)], dim=dim).contiguous()

    return trees.map_with_path(cut, full)


def gather_params(local, mesh, dst=None):
    """The full tree from every rank's :func:`shard_params` slice, on every
    rank (one all-gather a sharded leaf, over the model group; moved as
    the leaf's own dtype, so bit for bit).

    ``dst`` (a global rank; a checkpoint's writer): the full tree on that
    rank alone, each leaf moved to the host as it is gathered, so the
    cards hold at most one full leaf at a time; None on the other ranks,
    and without a collective on those whose model group does not hold
    ``dst``.  At one way ``local`` comes back as it is, on every rank."""
    group, _, ways = model_group(mesh)
    if ways == 1:
        return local
    if dst is not None and dst not in dist.get_process_group_ranks(group):
        return None
    mine = dst is None or dist.get_rank() == dst

    def join(path, leaf):
        dim = _model_dim(path, leaf, mesh)
        if dim is None:
            return leaf if dst is None else \
                leaf.detach().cpu() if mine else None
        halves = _halves(path, leaf)
        with torch.no_grad():
            parts = gather_dim(leaf.detach(), dim, group,
                               (leaf.shape[dim],) * ways, dst)
        if not mine:
            return None
        if halves > 1:
            per = leaf.shape[dim] // halves
            blocks = parts.split(per, dim=dim)   # rank-major, half-minor
            parts = torch.cat([blocks[r * halves + h] for h in range(halves)
                               for r in range(ways)], dim=dim)
        return parts if dst is None else parts.cpu()

    whole = trees.map_with_path(join, local)
    return whole if mine else None
