"""The steps of ``repro.launch.steps``: train (on one device or data
parallel over a mesh), prefill, decode and the LM token-attribution step,
plus their sharding trees (DTensor placements).

Numerics, as the JAX package's: f32 master parameters and Adam moments
(:class:`TrainState`); each step casts the master once to the compute
dtype (:func:`cast_for_compute`: every matrix, SSM dynamics kept f32) and
differentiates the loss with respect to that one tree; microbatch
gradients are widened to f32 and summed in order, then divided.  On a
mesh each rank runs that on its rows of the global batch, weights its
gradients, loss and CE by its share of the rows and all-reduces them in
f32 over the batch axes before the clip, so every rank applies the same
update.

Every step takes ``mesh=`` (a ``(data, model)`` :class:`~repro_torch.
launch.mesh.Mesh`) and runs under ``use_mesh(mesh)``: the batch axes split
the rows, the "model" axis splits the parameters, each rank holding its
slice (:func:`shard_state`, ``dist.params.shard_params``) and the layers
summing or gathering over the model group.  Gradients of sharded leaves
stay on their rank; the step sums their squares over the model group
once for the clip's global norm.  With no mesh, or one rank on each axis,
every step is the single-device step.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch import tree as trees
from repro_torch.dist import params as dist_params
from repro_torch.dist import sharding as dist_sharding
from repro_torch.dist.sharding import physical_spec, placements
from repro_torch.engine import methods as engine_methods
from repro_torch.models import transformer as tf
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule)

_KEEP_F32 = ("A_log", "dt_bias", "D")   # SSM dynamics: stay f32 in compute


class TrainState(NamedTuple):
    params: Dict     # f32 master
    opt: AdamWState


# ---------------------------------------------------------------------------
# trees / casts / loss
# ---------------------------------------------------------------------------


def cast_for_compute(params, cfg):
    """The compute tree: every f32 leaf with ``ndim >= 2`` whose name is
    not in ``_KEEP_F32`` cast to the config's dtype.  The rule reads the
    stacked segment tree, so a per-layer norm scale ``[L, d]`` and the
    router ``[L, d, E]`` are cast while ``final_norm`` ``[d]`` stays f32,
    as in the JAX package."""
    def cast(path, p):
        if (p.dim() >= 2 and p.dtype == torch.float32
                and trees.leaf_name(path) not in _KEEP_F32):
            return p.to(cfg.torch_dtype)
        return p
    return trees.map_with_path(cast, params)


def ce_loss(logits, labels, cfg):
    """Mean token cross-entropy of f32 logits; a vlm's loss runs over the
    text positions only (the first ``n_patches`` are dropped)."""
    lg = logits.to(torch.float32)
    if cfg.frontend == "patches":
        lg = lg[:, cfg.n_patches:, :]
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.to(torch.int64)[..., None])[..., 0]
    return (lse - ll).mean()


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def make_train_state_init(cfg):
    """``init_fn(generator=None, device=None) -> TrainState``: f32 master
    parameters (``tf.init`` of ``cfg`` in f32) and zero moments on
    ``device`` (None: the card), drawn from ``generator`` (default: seed 0
    on that device)."""
    cfg32 = cfg.with_(dtype="float32")

    def init_fn(generator: torch.Generator = None, device=None) -> TrainState:
        params = tf.init(cfg32, generator=generator, device=device)
        return TrainState(params=params, opt=adamw_init(params))

    return init_fn


def shard_state(state: TrainState, mesh) -> TrainState:
    """This rank's slice of a full :class:`TrainState` (params and both
    moments by ``dist.params.shard_params``; the step as it is)."""
    opt = state.opt
    return TrainState(
        params=dist_params.shard_params(state.params, mesh),
        opt=type(opt)(step=opt.step,
                      mu=dist_params.shard_params(opt.mu, mesh),
                      nu=dist_params.shard_params(opt.nu, mesh)))


def gather_state(state: TrainState, mesh, dst=None):
    """The full :class:`TrainState` from every model rank's slice, on every
    rank, bit for bit (collective: every rank calls it).  ``dst`` (a
    global rank): on that rank alone, on the host, None on the others
    (``dist.params.gather_params``)."""
    opt = state.opt
    params = dist_params.gather_params(state.params, mesh, dst)
    mu = dist_params.gather_params(opt.mu, mesh, dst)
    nu = dist_params.gather_params(opt.nu, mesh, dst)
    if params is None:
        return None
    return TrainState(params=params,
                      opt=type(opt)(step=opt.step, mu=mu, nu=nu))


def _model_norm(grads, mesh):
    """The global norm of a model rank's gradient slices: the squares of
    the sharded leaves summed over the model group, those of the
    replicated leaves (the same on every rank) counted once; None at one
    way, where the clip takes the plain norm."""
    if dist_sharding.model_ways(mesh) == 1:
        return None
    dev = trees.leaves(grads)[0].device
    sq = {s: torch.zeros((), dtype=torch.float32, device=dev)
          for s in (True, False)}
    for path, g in trees.walk(grads):
        s = dist_params.sharded_leaf(path, g, mesh)
        sq[s] = sq[s] + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(dist_sharding.reduce_from_model(sq[True]) + sq[False])


def _rows(mesh, batch):
    """``(batch's rows of this rank, n, (lo, hi))``; the batch as it is
    without a batch axis of several ranks."""
    n = next(iter(batch.values())).shape[0]
    _, _, ways = dist_sharding.batch_group(mesh)
    if ways == 1:
        return batch, n, (0, n)
    if n < ways:
        raise ValueError(f"a batch of {n} rows over {ways} ranks")
    lo, hi = dist_sharding.local_rows(mesh, n)
    return {k: v[lo:hi] for k, v in batch.items()}, n, (lo, hi)


def _joined(mesh, n, *outs):
    """Each output's rows from every rank of the batch axes."""
    if dist_sharding.batch_group(mesh)[2] == 1:
        return outs
    return tuple(dist_sharding.gather_rows(mesh, t.contiguous(), n)
                 for t in outs)


def make_train_step(cfg, *, microbatches: int = 1, peak_lr: float = 2e-4,
                    warmup_steps: int = 100, total_steps: int = 10_000,
                    clip: float = 1.0, triangle_skip: bool = True,
                    mesh=None):
    """``(state, batch) -> (state, metrics)``; ``batch``: tensors on the
    state's device, ``tokens`` and ``labels`` ``[B, S]`` (plus a vlm's
    ``patches``, an encoder-decoder's ``frames``).  Metrics: ``loss`` (CE
    plus the MoE's aux loss), ``ce``, ``gnorm`` (before clipping) and
    ``lr`` (the schedule at the step before the update), scalar
    tensors.

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) makes the step
    data parallel over the mesh's batch axes: every rank passes the same
    global batch and computes its rows ``host_shard_bounds(B, r, n)``; its
    gradients (summed over its microbatches, as above), loss and CE are
    weighted by its share of the ``B`` rows and summed over the ranks in
    f32, so the gradient norm is global and every rank applies the same
    AdamW update.  An MoE routes each rank's tokens on their own (capacity
    and aux loss per rank).  A "model" axis of several ranks makes it
    tensor / expert parallel: ``state`` is the rank's slice
    (:func:`shard_state`), and so are the new state and its gradients."""

    def loss_fn(params_c, mb):
        fwd_batch = {k: v for k, v in mb.items() if k != "labels"}
        logits, aux = tf.forward(params_c, cfg, fwd_batch,
                                 triangle_skip=triangle_skip)
        ce = ce_loss(logits, mb["labels"], cfg)
        return ce + aux, ce

    def grads_of(params_c, leaves, mb):
        loss, ce = loss_fn(params_c, mb)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True,
                                 materialize_grads=True)
        return loss.detach(), ce.detach(), gs

    def train_step(state: TrainState, batch: Dict):
        with dist_sharding.use_mesh(mesh):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: Dict):
        group, _, ways = dist_sharding.batch_group(mesh)
        if group is not None:
            batch, n, (lo, hi) = _rows(mesh, batch)
        params_c = trees.tree_map(lambda t: t.detach().requires_grad_(),
                                  cast_for_compute(state.params, cfg))
        leaves = trees.leaves(params_c)
        if microbatches == 1:
            loss, ce, gs = grads_of(params_c, leaves, batch)
            flat = [g.to(torch.float32) for g in gs]
            del gs
        else:
            mbs = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                + tuple(v.shape[1:]))
                   for k, v in batch.items()}
            flat = [torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device) for t in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            ce = torch.zeros_like(loss)
            for i in range(microbatches):
                li, ci, gs = grads_of(params_c, leaves,
                                      {k: v[i] for k, v in mbs.items()})
                flat = [a + g.to(torch.float32) for a, g in zip(flat, gs)]
                loss, ce = loss + li, ce + ci
                del gs
            flat = [g / microbatches for g in flat]
            loss, ce = loss / microbatches, ce / microbatches
        del params_c, leaves
        if group is not None:
            share = (hi - lo) / n
            for t in flat + [loss, ce]:
                dist_sharding.all_reduce_sum(
                    mesh, t.mul_(share) if ways > 1 else t)
        grads = trees.unflatten(state.params, flat)
        del flat
        grads, gnorm = clip_by_global_norm(grads, clip,
                                           gnorm=_model_norm(grads, mesh))
        lr = cosine_schedule(state.opt.step, peak_lr=peak_lr,
                             warmup_steps=warmup_steps,
                             total_steps=total_steps)
        new_params, new_opt = adamw_update(grads, state.opt, state.params,
                                           lr=lr)
        metrics = {"loss": loss, "ce": ce, "gnorm": gnorm, "lr": lr}
        return TrainState(new_params, new_opt), metrics

    return train_step


def state_from_jax(state_np, device="cpu") -> TrainState:
    """The JAX package's ``TrainState`` (leaves as NumPy arrays) -> this
    package's on ``device``: params, mu and nu copied bit for bit
    (``tf.params_from_jax``), the step as an int32 scalar."""
    opt = state_np.opt
    return TrainState(
        params=tf.params_from_jax(state_np.params, device),
        opt=AdamWState(
            step=torch.tensor(int(opt.step), dtype=torch.int32,
                              device=device),
            mu=tf.params_from_jax(opt.mu, device),
            nu=tf.params_from_jax(opt.nu, device)))


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def make_prefill_step(cfg, *, triangle_skip: bool = True, mesh=None):
    """``(params, batch, cache) -> (next tokens [B, 1] int32, cache)``:
    the prompt's prefill and its greedy (argmax) next token.  ``mesh``:
    ``params`` and ``cache`` are the rank's (``shard_params``,
    ``tf.init_cache(..., mesh=)``), ``batch`` the whole one, of which the
    rank prefills its rows; the tokens come back whole on every rank."""
    @torch.no_grad()
    def prefill_step(params, batch, cache):
        with dist_sharding.use_mesh(mesh):
            batch, n, _ = _rows(mesh, batch)
            logits, cache = tf.prefill(params, cfg, batch, cache,
                                       triangle_skip=triangle_skip)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            return _joined(mesh, n, nxt[:, None])[0], cache

    return prefill_step


def make_decode_step(cfg, *, mesh=None):
    """``(params, cache, tokens [B, 1], pos) -> (next tokens [B, 1] int32,
    cache)``: one cached decode step at position ``pos`` and its greedy
    next token (``mesh`` as :func:`make_prefill_step`'s)."""
    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        with dist_sharding.use_mesh(mesh):
            rows, n, _ = _rows(mesh, {"tokens": tokens})
            logits, cache = tf.decode_step(params, cfg, rows["tokens"],
                                           cache, int(pos))
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            return _joined(mesh, n, nxt[:, None])[0], cache

    return decode_step


#: Per-token score reductions ``make_attribute_step`` builds.
TOKEN_MODES = ("ixg", "grad_norm", "contrastive")


def ssm_scan_tiles(cfg, plan=None):
    """Per-SEGMENT ``{si: (d_tile, chunk)}`` launch knobs for the B13 scan.

    LM attribution always routes SSM segments through the scan kernel;
    this maps a :class:`repro_torch.plan.TilePlan`'s ``ssm<si>.scan``
    entries (``repro_torch.plan.lm_kernel_shapes``) onto the launch knobs.
    Segments without a plan entry, and the whole stack when ``plan`` is
    None, get the unplanned launch: the whole channel dim in one grid cell
    (``d_tile = cfg.d_inner``; the kernel clamps it to the channels it is
    given, a model rank's ``d_inner / ways``) at the model's
    ``ssm_chunk``.  The knobs split the grid and the staging, never an
    element's arithmetic.  Returns None for stacks without SSM segments.
    """
    tiles = {}
    for si, (kind, _, _) in enumerate(cfg.layer_plan()):
        if kind not in ("mamba", "hybrid"):
            continue
        t = plan.get(f"ssm{si}.scan") if plan is not None else None
        tiles[si] = ((t.d_tile, t.chunk) if t is not None
                     else (cfg.d_inner, cfg.ssm_chunk))
    return tiles or None


def make_attribute_step(cfg, method: str = "saliency", *,
                        triangle_skip: bool = True, plan=None,
                        mode: str = "ixg", mesh=None):
    """The paper's technique as a serving feature for LMs: one forward and
    one input-gradient backward, ``(params, batch) -> (last-position
    logits [B, V], per-position scores [B, S])`` for the final position's
    prediction (vlm: the first ``n_patches`` scores are the image's;
    ``batch["frames"]`` feed an encoder-decoder's encoder).  ``mode``:
    ``"ixg"`` (input x gradient, signed), ``"grad_norm"`` (L2 norm of the
    embedding gradient) or ``"contrastive"`` (argmax-vs-runner-up
    difference seed).  ``plan`` (a
    ``plan_lm`` :class:`~repro_torch.plan.TilePlan`) sets the scan's
    ``(d_tile, chunk)`` per segment (:func:`ssm_scan_tiles`; on a mesh
    each planned ``d_tile`` must divide a model rank's channels).
    ``mesh``: ``params`` are the rank's (``shard_params``), the rank
    attributes its rows of ``batch``, and the logits and scores come back
    whole on every rank."""
    if mode not in TOKEN_MODES:
        raise ValueError(f"mode={mode!r} not in {TOKEN_MODES}")
    scan_tiles = ssm_scan_tiles(cfg, plan)
    d_local = cfg.d_inner // dist_sharding.model_ways(mesh)
    for si, (d_tile, _) in (scan_tiles or {}).items():
        if d_local % min(d_tile, d_local):
            raise ValueError(
                f"segment {si}: the planned scan tile d_tile={d_tile} does "
                f"not divide a model rank's {d_local} channels")

    def attribute_step(params, batch):
        with dist_sharding.use_mesh(mesh):
            batch, n, _ = _rows(mesh, batch)
            return _joined(mesh, n, *_attribute(params, batch))

    def _attribute(params, batch):
        h = tf.embed_inputs(params, cfg, batch)
        enc_frames = batch.get("frames")

        def f(e):
            return tf.forward_from_embeddings(
                params, cfg, e, method=method, enc_frames=enc_frames,
                triangle_skip=triangle_skip, scan_tiles=scan_tiles)[0]

        if mode == "contrastive":
            logits, rel, scores = engine_methods.attribute_tokens_contrastive(
                f, h)
        else:
            logits, rel, scores = engine_methods.attribute_tokens(f, h)
            if mode == "grad_norm":
                scores = rel.float().norm(dim=-1)
        return logits[:, -1, :], scores

    return attribute_step


# ---------------------------------------------------------------------------
# sharding trees (DTensor placements, the twins of the JAX package's
# NamedSharding trees)
# ---------------------------------------------------------------------------


def batch_shardings(batch, mesh) -> Dict:
    """Placements per batch entry: the leading axis on the batch axes."""
    def spec(v):
        if len(v.shape) == 2 and v.dtype == torch.int32:
            return physical_spec(("batch", None), mesh)
        return physical_spec(("batch",) + (None,) * (len(v.shape) - 1),
                             mesh)
    return {k: placements(spec(v), mesh) for k, v in batch.items()}


def state_shardings(state: TrainState, mesh) -> TrainState:
    """Placements per leaf of a :class:`TrainState`: the parameter rules
    for params and both moments, the step replicated."""
    opt = state.opt
    return TrainState(
        params=dist_params.param_sharding_tree(state.params, mesh),
        opt=type(opt)(
            step=placements((), mesh),
            mu=dist_params.param_sharding_tree(opt.mu, mesh),
            nu=dist_params.param_sharding_tree(opt.nu, mesh)))


def cache_shardings(cfg, cache, mesh, batch_size: int):
    """KV / state cache placements.

    Batch >= DP size: shard the batch over (pod, data).  Small-batch
    long-context decode: sequence-parallel instead — the cache T axis
    shards over "data" and the fused head axis over "model".  The steps
    compute the first (``tf.init_cache(..., mesh=)``); the second is
    ROADMAP A12d and is refused there.
    """
    dp = 1
    for ax in ("pod", "data"):
        if ax in mesh.axis_names:
            dp *= mesh.axis_size(ax)
    batch_big = batch_size >= dp

    def spec(path, leaf):
        name = trees.leaf_name(path)
        if name in ("k", "v", "ck", "cv"):          # [L, B, T, Kv*hd]
            if batch_big:
                return physical_spec((None, "batch", None, "model"), mesh)
            return physical_spec((None, None, "data", "model"), mesh)
        if name == "h":                              # [L, B, d_inner, N]
            bax = "batch" if batch_big else None
            return physical_spec((None, bax, "model", None), mesh)
        if name == "conv":                           # [L, B, k-1, d_inner]
            bax = "batch" if batch_big else None
            return physical_spec((None, bax, None, "model"), mesh)
        return ()

    return trees.map_with_path(
        lambda p, leaf: placements(spec(p, leaf), mesh), cache)
