"""Meshes of ranks: the builders of ``repro.launch.mesh`` on
``torch.distributed``.

A :class:`Mesh` names its axes and their sizes.  When the default process
group is initialized (``torchrun``, or ``init_process_group`` by the
caller), the mesh also holds the :class:`~torch.distributed.device_mesh.
DeviceMesh` over its ranks, each axis's process group and this rank's
coordinate on it, and the collectives of :mod:`repro_torch.dist` run over
those groups, even at world size 1 (on the card NCCL carries them then
too).  Without a process group a mesh has one rank, no ``DeviceMesh`` and
no group, and the collectives are skipped, so single-process code and the
CPU tests need no rendezvous.  Building a mesh never initializes a process
group.

The ``DeviceMesh`` lives on the card where the default group's backend
is NCCL and on the CPU otherwise: a gloo world (the CPU tests, or ranks
sharing one card, which NCCL refuses) builds gloo groups, and gloo
carries the collectives of :mod:`repro_torch.dist` for card tensors too.

Every builder caps its mesh at the world size, as the JAX package's cap at
``len(jax.devices())``.  A mesh smaller than the world is replicated: the
world splits into blocks of ``mesh.size`` consecutive ranks, and each
block is one copy of the mesh computing the same thing.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist


def initialized() -> bool:
    """Whether a default process group exists in this process."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The default group's size; 1 without a process group."""
    return dist.get_world_size() if initialized() else 1


def _device_type() -> str:
    """The ``DeviceMesh`` device of the default group's backend: "cuda"
    where NCCL carries the card's tensors, else "cpu" (gloo, for CPU and
    card tensors alike)."""
    return "cuda" if "nccl" in dist.get_backend() else "cpu"


class Mesh:
    """Named axes over the ranks of the default process group (see the
    module docstring).  ``shape[i]`` ranks along ``axis_names[i]``,
    row-major over the ranks of this rank's block."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"mesh shape {self.shape} has an empty axis")
        self.device_mesh = None
        self._groups: Dict[str, object] = {}
        self._products: Dict[tuple, object] = {}
        self._coords = {name: 0 for name in self.axis_names}
        if not initialized():
            if self.size != 1:
                raise ValueError(
                    f"a mesh of {self.size} ranks needs a process group; "
                    f"without one the world is 1 rank")
            return
        world = dist.get_world_size()
        if world % self.size:
            raise ValueError(f"a mesh of {self.size} ranks does not divide "
                             f"the world of {world}")
        from torch.distributed.device_mesh import init_device_mesh
        if self.size == world:
            self.device_mesh = init_device_mesh(
                _device_type(), self.shape, mesh_dim_names=self.axis_names)
        else:
            blocks = init_device_mesh(
                _device_type(), (world // self.size,) + self.shape,
                mesh_dim_names=("replica",) + self.axis_names)
            names = self.axis_names
            self.device_mesh = blocks[names[0] if len(names) == 1
                                      else names]
        for name in self.axis_names:
            self._groups[name] = self.device_mesh.get_group(name)
            self._coords[name] = self.device_mesh.get_local_rank(name)

    @property
    def size(self) -> int:
        """Ranks in the mesh."""
        return math.prod(self.shape)

    @property
    def has_group(self) -> bool:
        """Whether the collectives run (a process group exists)."""
        return self.device_mesh is not None

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coordinate(self, name: str) -> int:
        """This rank's index along axis ``name``."""
        return self._coords[name]

    def group(self, name: str):
        """The process group along axis ``name``; None without one."""
        return self._groups.get(name)

    def axes_group(self, names: Sequence[str]) -> Tuple[Optional[object],
                                                        int, int]:
        """``(group, coordinate, ways)`` over the product of the axes
        ``names`` (row-major), or ``(None, 0, 1)`` without a process group
        or when the mesh has none of them.  Several axes of size > 1 need
        one group over their product: the world's when they span it, else
        one made at the first call (:meth:`_product_group`), which every
        rank makes at the same point of its program."""
        names = [n for n in names if n in self.axis_names]
        if not names or not self.has_group:
            return None, 0, 1
        coord, ways = 0, 1
        for n in names:
            coord = coord * self.axis_size(n) + self.coordinate(n)
            ways *= self.axis_size(n)
        big = [n for n in names if self.axis_size(n) > 1]
        if len(big) <= 1:       # one rank: the group of one still runs
            return self.group(big[0] if big else names[-1]), coord, ways
        if ways == self.size and self.size == world_size():
            return dist.group.WORLD, coord, ways
        return self._product_group(tuple(big)), coord, ways

    def _product_group(self, names: Tuple[str, ...]):
        """The group of the ranks that differ only along ``names``, made
        collectively over the world (one group per block of the other
        axes' coordinates, in every copy of the mesh), cached."""
        if names not in self._products:
            idx = [self.axis_names.index(n) for n in names]
            rest = [i for i in range(len(self.shape)) if i not in idx]
            subgroups = []
            for block in range(world_size() // self.size):
                for other in itertools.product(
                        *(range(self.shape[i]) for i in rest)):
                    ranks = []
                    for mine in itertools.product(
                            *(range(self.shape[i]) for i in idx)):
                        coord = [0] * len(self.shape)
                        for i, c in zip(rest + idx, other + mine):
                            coord[i] = c
                        flat = 0
                        for c, s in zip(coord, self.shape):
                            flat = flat * s + c
                        ranks.append(block * self.size + flat)
                    subgroups.append(ranks)
            self._products[names] = dist.new_subgroups_by_enumeration(
                subgroups)[0]
        return self._products[names]

    def __repr__(self):
        axes = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names,
                                                     self.shape))
        return f"Mesh({axes}{', group' if self.has_group else ''})"


_MESHES: Dict[tuple, Mesh] = {}


def _mesh(shape, axis_names) -> Mesh:
    """One :class:`Mesh` per shape and process group: a ``DeviceMesh``
    makes process groups, collectively, so equal meshes share them."""
    pg = dist.group.WORLD if initialized() else None
    key = (tuple(shape), tuple(axis_names), pg)
    if key not in _MESHES:
        for k in [k for k in _MESHES if k[2] is not pg]:
            del _MESHES[k]          # meshes of a destroyed group
        _MESHES[key] = Mesh(shape, axis_names)
    return _MESHES[key]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh: 16 x 16 = 256 ranks a pod, 2 pods = 512.

    Axes: "data" (+"pod" across pods) carry data parallelism; "model"
    carries tensor / expert parallelism.  Needs a world of exactly that
    many ranks, as ``jax.make_mesh`` needs the devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} "
            f"needs {math.prod(shape)} ranks; the world has {world}")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ``(data, model)`` mesh over the ranks there are (tests,
    ``torchrun`` drivers), capped at the world size."""
    n = world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    return _mesh((data, model), ("data", "model"))


def make_serving_mesh(n_shards: int = 1) -> Mesh:
    """1-D serving mesh: ``n_shards`` ways of data parallelism.

    The sharded :class:`~repro_torch.engine.engine.Engine` splits the batch
    axis (logical "batch" -> physical "data") across this mesh; with fewer
    ranks than requested shards the mesh is capped at what exists, so a
    ``mesh:<profile>:4`` engine still builds and runs in one process (the
    plan is sharded, the rows are not)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return _mesh((min(int(n_shards), world_size()),), ("data",))
