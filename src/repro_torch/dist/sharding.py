"""Mesh context, logical-axis placements, the data-parallel row
collectives and the model-axis conjugates.

The JAX package annotates arrays with LOGICAL axes ("batch", "model",
"expert") and lets GSPMD place them.  The port keeps the same logical
vocabulary and the same translation to the PHYSICAL mesh
(:func:`physical_spec`), and turns a spec into DTensor placements
(:func:`placements`), the twin of a ``NamedSharding``.  Its models run on
rank-local tensors: nothing inside a model calls :func:`constrain`, and
data parallelism is explicit SPMD, every rank calling the same function on
the same arguments:

  * :func:`local_rows` — the rows ``host_shard_bounds(n, r, ways)`` that
    rank ``r`` of the mesh's batch axes computes;
  * :func:`gather_rows` — each rank's rows back into the full tensor, in
    rank order, on every rank (padded to equal sizes for
    ``all_gather_into_tensor``, then trimmed);
  * :func:`all_reduce_sum` — a sum over the batch axes.

Tensor and expert parallelism over the mesh's "model" axis is explicit
SPMD too: each rank holds its slice of the sharded parameters
(:func:`repro_torch.dist.params.shard_params`) and the layers, at the
places where the JAX package calls ``constrain``, call four autograd
Functions over the model group of the active mesh (:func:`model_group`
of :func:`current_mesh`), each pairing a collective with its conjugate
and each the identity at one way:

  * :func:`copy_to_model` — identity forward, sum of the cotangents over
    the model group backward (a replicated tensor entering rank-local
    work);
  * :func:`reduce_from_model` — sum over the model group forward,
    identity backward (the partial sums of a row-parallel product; bf16
    partials are summed in f32 and rounded once);
  * :func:`gather_from_model` — every rank's slice along a dim forward,
    this rank's slice of the (replicated) cotangent backward;
  * :func:`slice_to_model` — this rank's slice forward, the gathered
    cotangent backward.

:data:`MODEL_TRAFFIC` counts the bytes these collectives move.

Logical -> physical:

  batch   -> the product of the DP axes present in the mesh ("pod", "data")
  model   -> "model"   (TP / SP)
  expert  -> "model"   (EP rides the same axis)

Logical axes without a translation entry fall through to themselves
("seeds" shards over a physical "seeds" axis when the mesh has one and
replicates otherwise); axes absent from the mesh become ``None``, so a
smaller mesh replicates instead of failing.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as trees
from repro_torch.data.synthetic import host_shard_bounds

_LOGICAL_TO_PHYSICAL = {
    "batch": ("pod", "data"),
    "model": ("model",),
    "expert": ("model",),
}

#: the physical axes a batch splits over, outermost first
BATCH_AXES = _LOGICAL_TO_PHYSICAL["batch"]

_state = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for :func:`current_mesh` / :func:`constrain`."""
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def current_mesh():
    """The innermost active mesh, or None outside any ``use_mesh``."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


def physical_spec(logical, mesh) -> Tuple:
    """A tuple of logical axes (or None) -> the physical spec, entry for
    entry as ``tuple(repro.dist.sharding.physical_spec(...))``: a mesh
    axis name, a tuple of them, or None."""
    names = set(mesh.axis_names)
    entries = []
    for ax in logical:
        if ax is None:
            entries.append(None)
            continue
        phys = [a for a in _LOGICAL_TO_PHYSICAL.get(ax, (ax,)) if a in names]
        if not phys:
            entries.append(None)
        elif len(phys) == 1:
            entries.append(phys[0])
        else:
            entries.append(tuple(phys))
    return tuple(entries)


def placements(spec, mesh) -> Tuple:
    """DTensor placements of a physical ``spec`` on ``mesh``: for each
    mesh dimension ``Shard(d)`` where the spec's dim ``d`` names it (alone
    or in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.axis_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def constrain(x, *logical):
    """The identity on a plain tensor, with or without a mesh (the port's
    models run on rank-local tensors); a DTensor under an active mesh is
    redistributed to the logical spec's placements."""
    mesh = current_mesh()
    if mesh is None or mesh.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh.device_mesh,
                          placements(physical_spec(logical, mesh), mesh))


# ---------------------------------------------------------------------------
# data-parallel rows
# ---------------------------------------------------------------------------


def batch_group(mesh, axes: Sequence[str] = BATCH_AXES):
    """``(group, coordinate, ways)`` of the mesh's batch axes (see
    :meth:`repro_torch.launch.mesh.Mesh.axes_group`); ``(None, 0, 1)``
    without a process group."""
    if mesh is None or not mesh.has_group:
        return None, 0, 1
    return mesh.axes_group(axes)


def local_rows(mesh, n: int, axes: Sequence[str] = BATCH_AXES
               ) -> Tuple[int, int]:
    """``[lo, hi)``: the rows of ``n`` this rank computes."""
    _, coord, ways = batch_group(mesh, axes)
    return host_shard_bounds(n, coord, ways)


def _all_gather(out, inp, group):
    with warnings.catch_warnings():     # renamed all_gather_single in 2.13
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, inp, group=group)


def gather_rows(mesh, local: torch.Tensor, n: int, dim: int = 0,
                axes: Sequence[str] = BATCH_AXES) -> torch.Tensor:
    """The full tensor of ``n`` rows along ``dim`` from each rank's
    :func:`local_rows` slice (its first rows of ``local``; rows past them
    are padding), in rank order, on every rank.  Moved as bytes, so every
    dtype (masks, int16 words, bf16) travels bit for bit.  Without a group
    ``local`` is the whole."""
    group, _, ways = batch_group(mesh, axes)
    if group is None:
        return local
    x = local.movedim(dim, 0)
    per = -(-n // ways)
    rows = x.shape[0]
    if rows > per:
        raise ValueError(f"{rows} local rows of {n} over {ways} ranks")
    if rows < per:
        x = torch.cat([x, x.new_zeros((per - rows,) + tuple(x.shape[1:]))])
    rest = tuple(x.shape[1:])
    raw = x.contiguous().reshape(per, -1).view(torch.uint8)
    out = raw.new_empty((ways * per, raw.shape[1]))
    _all_gather(out, raw, group)
    out = out.view(x.dtype).reshape((ways, per) + rest)
    parts = [out[r, :b - a] for r, (a, b) in enumerate(
        host_shard_bounds(n, r, ways) for r in range(ways))]
    return torch.cat(parts).movedim(0, dim)


def all_reduce_sum(mesh, t: torch.Tensor,
                   axes: Sequence[str] = BATCH_AXES) -> torch.Tensor:
    """``t`` summed over the mesh's batch axes, in place (the identity
    without a group)."""
    group, _, _ = batch_group(mesh, axes)
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _rank_rows(x, mesh, dim):
    """This rank's rows of ``x`` along ``dim``, contiguous (the kernels
    take no strides), padded with copies of ``x``'s first row up to
    ``ceil(n / ways)``: every rank runs the one per-shard shape the mesh's
    plan was made for (a rank of a short slice runs padding rows, which
    :func:`gather_rows` drops)."""
    _, coord, ways = batch_group(mesh)
    n = x.shape[dim]
    lo, hi = host_shard_bounds(n, coord, ways)
    per = -(-n // ways)
    rows = x.narrow(dim, lo, hi - lo)
    if hi - lo == per:
        return rows.contiguous()
    pad = x.narrow(dim, 0, 1).expand(
        tuple(per - (hi - lo) if d == dim else -1 for d in range(x.ndim)))
    return torch.cat([rows, pad], dim=dim)


class _SliceRows(torch.autograd.Function):
    """This rank's rows of a tensor every rank holds; the backward gathers
    every rank's cotangent rows, so each rank's input gradient is the
    full one."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return _rank_rows(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_rows(ctx.mesh, g.contiguous(), ctx.n, ctx.dim), \
            None, None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows into the full tensor; the backward keeps this
    rank's rows of the cotangent (every rank holds the same one)."""

    @staticmethod
    def forward(ctx, local, mesh, n, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return gather_rows(mesh, local, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _rank_rows(g, ctx.mesh, ctx.dim), None, None, None


def slice_rows(mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's :func:`local_rows` of ``x`` along ``dim``, padded to
    the per-shard size (see ``_rank_rows``), differentiable: the gradient
    of the full ``x`` comes back whole on every rank."""
    if batch_group(mesh)[0] is None:
        return x
    return _SliceRows.apply(x, mesh, dim)


def join_rows(mesh, local: torch.Tensor, n: int,
              dim: int = 0) -> torch.Tensor:
    """:func:`gather_rows`, differentiable."""
    if batch_group(mesh)[0] is None:
        return local
    return _GatherRows.apply(local, mesh, n, dim)


# ---------------------------------------------------------------------------
# the model axis: tensor / expert parallel conjugates
# ---------------------------------------------------------------------------

#: Payload bytes of the model-axis collectives since the last
#: :func:`reset_model_traffic`: an all-reduce counts its tensor's bytes, an
#: all-gather its gathered output's; ``calls`` counts collectives.
MODEL_TRAFFIC = {"all_reduce": 0, "all_gather": 0, "calls": 0}


def reset_model_traffic():
    """Set every :data:`MODEL_TRAFFIC` count to 0."""
    for k in MODEL_TRAFFIC:
        MODEL_TRAFFIC[k] = 0


def model_group(mesh) -> Tuple[object, int, int]:
    """``(group, coordinate, ways)`` of the "model" axis of ``mesh``;
    ``(None, 0, 1)`` without a mesh, a process group or a "model" axis.
    The conjugates below read the active mesh's."""
    if mesh is None or not mesh.has_group or "model" not in mesh.axis_names:
        return None, 0, 1
    return mesh.axes_group(("model",))


def model_ways(mesh) -> int:
    """Ways of the "model" axis of ``mesh``."""
    return model_group(mesh)[2]


def _reduce(x, group):
    """The sum of every rank's ``x``; 2-byte floats are summed in f32 and
    rounded once."""
    wide = x.dtype in (torch.bfloat16, torch.float16)
    y = x.contiguous().to(torch.float32) if wide else x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    MODEL_TRAFFIC["all_reduce"] += y.numel() * y.element_size()
    MODEL_TRAFFIC["calls"] += 1
    return y.to(x.dtype) if wide else y


def _bounds(sizes, coord):
    lo = sum(sizes[:coord])
    return lo, lo + sizes[coord]


def gather_dim(x, dim, group, sizes, dst=None):
    """Every rank of ``group``'s slice of ``x`` along ``dim`` (rank r's of
    ``sizes[r]`` entries), in rank order, outside autograd: padded to the
    largest slice for the list all-gather, which gloo carries for card
    tensors too.  ``dst`` (a global rank in ``group``): gathered onto that
    rank alone (``dist.gather``), None on the others."""
    dim = dim % x.ndim
    per = max(sizes)
    mine = x.shape[dim]
    if mine < per:
        pad = list(x.shape)
        pad[dim] = per - mine
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    x = x.contiguous()
    if dst is None:
        parts = [torch.empty_like(x) for _ in sizes]
        dist.all_gather(parts, x, group=group)
    else:
        parts = ([torch.empty_like(x) for _ in sizes]
                 if dist.get_rank() == dst else None)
        dist.gather(x, parts, dst=dst, group=group)
    MODEL_TRAFFIC["all_gather"] += len(sizes) * x.numel() * x.element_size()
    MODEL_TRAFFIC["calls"] += 1
    if parts is None:
        return None
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                     dim=dim)


def max_over_model(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elementwise max over the model group, outside autograd: the
    row absmax of a tensor whose last axis the model ranks split (an int8
    residual's scale, ``core.rules.quantize_int8``).  ``t`` itself at one
    way."""
    group, _, ways = model_group(current_mesh())
    if ways == 1:
        return t
    y = t.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    MODEL_TRAFFIC["all_reduce"] += y.numel() * y.element_size()
    MODEL_TRAFFIC["calls"] += 1
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, coord, sizes, dim):
        ctx.dim, ctx.bounds = dim, _bounds(sizes, coord)
        return gather_dim(x, dim, group, sizes)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.bounds
        return g.narrow(ctx.dim, lo, hi - lo).contiguous(), None, None, \
            None, None


class _SliceToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, coord, sizes, dim):
        ctx.group, ctx.sizes, ctx.dim = group, sizes, dim
        lo, hi = _bounds(sizes, coord)
        return x.narrow(dim, lo, hi - lo).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.group, ctx.sizes), None, None, \
            None, None


def even_sizes(n: int, ways: int) -> Tuple[int, ...]:
    """Each rank's share of ``n`` entries, the first ``n % ways`` ranks one
    more (``host_shard_bounds``' split)."""
    return tuple(b - a for a, b in (host_shard_bounds(n, r, ways)
                                    for r in range(ways)))


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every model rank) into rank-local work: the
    identity; its gradient summed over the model group."""
    group, _, ways = model_group(current_mesh())
    return x if ways == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of every model rank's ``x`` (partial sums of a row-parallel
    product); the gradient passes through."""
    group, _, ways = model_group(current_mesh())
    return x if ways == 1 else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int = -1,
                      sizes: Sequence[int] = None) -> torch.Tensor:
    """Every model rank's slice along ``dim`` concatenated in rank order
    (``sizes``: each rank's length; None: all equal to this rank's); the
    gradient is this rank's slice of the cotangent, which every rank
    holds whole."""
    group, coord, ways = model_group(current_mesh())
    if ways == 1:
        return x
    sizes = tuple(sizes) if sizes is not None else (x.shape[dim],) * ways
    return _GatherFromModel.apply(x, group, coord, sizes, dim)


def slice_to_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This model rank's block of an even split of ``x`` along ``dim``
    (every rank holds ``x`` whole); the gradient gathers every rank's
    block cotangent."""
    group, coord, ways = model_group(current_mesh())
    if ways == 1:
        return x
    n = x.shape[dim]
    if n % ways:
        raise ValueError(f"{n} entries over {ways} model ranks")
    return _SliceToModel.apply(x, group, coord, (n // ways,) * ways, dim)


def map_tensors(fn, tree):
    """``fn`` on every tensor of ``tree`` (:mod:`repro_torch.tree`) with a
    leading axis; other leaves (None, the ints of a shape) pass
    through."""
    return trees.tree_map(
        lambda t: fn(t) if isinstance(t, torch.Tensor) and t.ndim else t,
        tree)


def gather_tree_rows(mesh, tree, n: int):
    """:func:`gather_rows` along dim 0 of every tensor of ``tree`` (each
    with the same number of local rows), in ONE collective: each leaf's
    rows as bytes, side by side in one buffer, gathered, then cut apart
    and viewed back in each leaf's dtype and shape."""
    if batch_group(mesh)[0] is None:
        return tree
    local = [t for t in trees.leaves(tree)
             if isinstance(t, torch.Tensor) and t.ndim]
    if not local:
        return tree
    rows = local[0].shape[0]
    raw = [t.contiguous().reshape(rows, -1).view(torch.uint8) for t in local]
    full = gather_rows(mesh, torch.cat(raw, dim=1), n)
    parts = iter(torch.split(full, [r.shape[1] for r in raw], dim=1))
    # each leaf's bytes copied out whole: a one-row part is "contiguous"
    # at the full row's stride and offset, which no dtype view takes
    return map_tensors(lambda t: next(parts).clone(
        memory_format=torch.contiguous_format).view(t.dtype).reshape(
            (n,) + tuple(t.shape[1:])), tree)


def slice_tree_rows(mesh, tree):
    """This rank's rows (dim 0, padded as :func:`slice_rows`) of every
    tensor of ``tree``."""
    if batch_group(mesh)[0] is None:
        return tree
    return map_tensors(lambda t: _rank_rows(t, mesh, 0), tree)
