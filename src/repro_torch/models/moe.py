"""Token-choice top-k MoE with sort-based capacity dispatch, as
``repro.models.moe`` has it on one device (one data shard).

* Routing in f32: router logits, softmax, top-k (``lax.top_k``'s order:
  descending, ties to the lower expert id), gates renormalized over the k;
  the Shazeer-style load-balancing loss.
* Dispatch: the ``T * k`` assignments sorted stably by expert id (as
  ``jnp.argsort``); each expert keeps the first ``C`` of its assignments
  in that order (``C = _capacity(T)``) and the rest are dropped.  A dropped
  assignment writes nowhere: the JAX package points it at the expert's
  slot 0, where XLA's unordered duplicate scatter may overwrite the first
  kept token (ROADMAP C), so the two agree wherever no expert overflows.
* Expert compute on ``[E, C, d]``: bf16 (or f32) batched products
  (``torch.bmm``: f32 accumulation, the output in the operands' dtype),
  where the JAX package's einsums take ``preferred_element_type`` then
  ``astype``; the gates through ``rules.act``, so attribution crosses the
  experts with the method.  Like every bf16 product of the port they run
  under PyTorch's default settings, so cuBLAS may reduce split-K partial
  sums in bf16 (``allow_bf16_reduced_precision_reduction``).
* Combine: each slot's output times its gate in the compute dtype, then
  each token's (at most k) slots summed in slot order, from zero, in that
  dtype: the order of XLA's scatter-add.

On a mesh whose "model" axis has several ranks the experts are split
(expert parallel): the router is replicated and the tokens are the same on
every model rank, so each rank routes and dispatches exactly as one device
does, runs ``bmm`` over its ``E / ways`` experts' slots only, and the
experts' outputs are gathered along the expert axis before the combine,
which is then the single-device combine, bit for bit on the CPU.  Shared
experts run the tensor-parallel :func:`layers.ffn`.

Dispatch and combine are deterministic on the card: no scatter with
duplicate indices and no atomic add onto a row that is kept, forward or
backward.  The gates (by assignment) and the combine (slot rows by token)
gather real rows at distinct indices, so their plain autograd backwards
add at most once into each real row (the zero padding row, which may take
many, is discarded).  Only the dispatch gathers a token more than once; its
backward is :class:`_SlotGather`'s ordered per-token sum.
"""
from __future__ import annotations

import torch

from repro_torch.core import rules
from repro_torch.dist import sharding as shd
from repro_torch.engine import methods as engine_methods
from repro_torch.models import layers


def init_moe(gen: torch.Generator, cfg) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    s = (2.0 / (d + f)) ** 0.5

    def ew(a, b_):
        w = torch.randn((e, a, b_), generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (w * s).to(cfg.torch_dtype)

    p = {"router": layers.dense_init(gen, d, e, torch.float32, scale=0.02),
         "w1": ew(d, f), "w2": ew(f, d)}
    if cfg.ffn_gated:
        p["w3"] = ew(d, f)
    if cfg.n_shared_experts:
        p["shared"] = layers.init_ffn(gen, cfg,
                                      d_ff=cfg.d_ff * cfg.n_shared_experts)
    return p


def _capacity(t_local: int, cfg) -> int:
    c = int(t_local * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _ordered_sum(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[t] = ((0 + rows[idx[t, 0]]) + rows[idx[t, 1]]) + ...`` in
    ``rows``' dtype, ``idx`` [T, k] ascending per row; index ``len(rows)``
    reads a zero row."""
    padded = torch.cat([rows, rows.new_zeros((1,) + rows.shape[1:])])
    out = rows.new_zeros((idx.shape[0],) + rows.shape[1:])
    for j in range(idx.shape[1]):
        out = out + padded.index_select(0, idx[:, j])
    return out


def _gather_rows(x: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """``x[tok]`` with index ``len(x)`` reading a zero row."""
    padded = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    return padded.index_select(0, tok)


class _SlotGather(torch.autograd.Function):
    """``xe[s] = x[tok[s]]`` (``tok[s] = T``: an empty slot, zeros).  A
    token fills up to k slots, so its gradient is a sum: the backward sums
    each token's slot gradients in slot order (``slots`` [T, k] ascending,
    ``E*C`` where dropped), where ``index_select``'s own backward would add
    them atomically."""

    @staticmethod
    def forward(ctx, x, tok, slots):
        ctx.save_for_backward(slots)
        return _gather_rows(x, tok)

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        return _ordered_sum(g, slots), None, None


def route(p, xt: torch.Tensor, cfg):
    """Routing of tokens ``xt [T, d]``: ``(gates [T, k] f32, expert_ids
    [T, k], aux)``."""
    e, k = cfg.n_experts, cfg.top_k
    logits = xt.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    expert_ids = engine_methods.top_k(probs, k)
    gates = torch.gather(probs, -1, expert_ids)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    me = probs.mean(dim=0)
    ce = engine_methods.one_hot(expert_ids[:, 0], e, probs).mean(dim=0)
    aux = cfg.router_aux_coef * e * (me * ce).sum()
    return gates, expert_ids, aux


def dispatch(expert_ids: torch.Tensor, cfg, c: int):
    """The capacity dispatch of ``expert_ids [T, k]``: ``(tok [E*C]``: the
    token of each slot, ``T`` where empty; ``assign [E*C]``: the flat
    assignment ``t*k + j`` of each slot, ``T*k`` where empty; ``slots
    [T, k]``: each token's slots ascending, ``E*C`` where dropped)``.  An expert keeps its first ``c``
    assignments in the stable sort by expert id; every index write has
    distinct targets."""
    t, k = expert_ids.shape
    e, tk, dev = cfg.n_experts, t * k, expert_ids.device
    flat = expert_ids.reshape(tk)
    order = torch.sort(flat, stable=True).indices
    s_ids = flat[order]
    counts = torch.bincount(flat, minlength=e)
    start = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(tk, device=dev) - start[s_ids]
    keep = pos_in_e < c
    slot_sorted = torch.where(keep, s_ids * c + pos_in_e,
                              torch.full_like(s_ids, e * c))
    kept = order[keep]                       # flat assignments kept
    kept_slot = slot_sorted[keep]
    tok = torch.full((e * c,), t, dtype=torch.int64, device=dev)
    tok[kept_slot] = kept // k
    assign = torch.full((e * c,), tk, dtype=torch.int64, device=dev)
    assign[kept_slot] = kept
    slot_flat = torch.empty(tk, dtype=torch.int64, device=dev)
    slot_flat[order] = slot_sorted
    slots = torch.sort(slot_flat.reshape(t, k), dim=-1).values
    return tok, assign, slots


def moe_ffn(p, x, cfg, method="autodiff"):
    """x: [B, S, d] -> (out [B, S, d], aux_loss)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    c = _capacity(t, cfg)

    gates, expert_ids, aux = route(p, xt, cfg)
    tok, assign, slots = dispatch(expert_ids, cfg, c)
    gate_slots = _gather_rows(gates.reshape(t * k), assign)

    # this rank's experts [e0, e0 + el): its window [lo, hi) of the slots
    # (all of them at one way)
    el = p["w1"].shape[0]
    e0 = shd.model_group(shd.current_mesh())[1] * el
    lo, hi = e0 * c, (e0 + el) * c
    mine = (slots >= lo) & (slots < hi)
    xe = _SlotGather.apply(shd.copy_to_model(xt), tok[lo:hi],
                           torch.where(mine, slots - lo, hi - lo))
    xe = xe.reshape(el, c, d)
    h = rules.act(torch.bmm(xe, p["w1"]), cfg.act, method,
                  cfg.residual_policy)
    if cfg.ffn_gated:
        h = h * torch.bmm(xe, p["w3"])
    y = shd.gather_from_model(torch.bmm(h, p["w2"]), 0)
    yw = y.reshape(e * c, d) * gate_slots[:, None].to(y.dtype)
    out = _ordered_sum(yw, slots).reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + layers.ffn(p["shared"], x, cfg, method)
    return out, aux
