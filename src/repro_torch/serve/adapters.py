"""Model adapters: the narrow waist between the server and the engine.

An adapter owns per-rule-set :class:`repro_torch.engine.Engine` instances —
built once via ``repro_torch.engine.build(EngineSpec(...))`` and shared
through the global build cache — and exposes the three programs the
dispatch loop calls:

  * ``predict(xb)`` — residual-returning forward (``Engine.forward``): the
    bit-packed residuals (ReLU sign bits, 2-bit pool argmax) come back with
    the logits so the server can park them in the
    :class:`~repro_torch.serve.residual_cache.ResidualCache`;
  * ``explain_cached(method, residuals, seeds)`` — the BP phase alone
    (``Engine.replay``), seed-batched over stored masks (paper §III.F);
  * ``engine_for(rules)`` / ``model_fn(rules)`` — the engine (and its
    rule-bound callable) for the registry's cold explainers, and
    ``attribute(explainer, xb, ...)``, which makes such an explainer's call
    (a multi-rank adapter, :mod:`repro_torch.serve.follower`, on every
    rank).

:class:`CNNAdapter` wires the paper's Table III CNN; both cold and cached
paths run the SAME kernel pair, so a cache hit is bit-exact with a cold
explain — it just skips the forward pass.  The adapter runs where its
engine's model runs (``CNNModel(..., device=)``: the card unless told
otherwise).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Tuple

import torch

from repro_torch import engine as engine_lib
from repro_torch.models import cnn


def slice_example(tree, i: int):
    """Per-example ``[1, ...]`` slice of a batched residual/array tree
    (nested dict / list / tuple), each tensor COPIED out of its batch so
    the slice owns its bytes (a view would keep the whole batch's storage
    alive in the cache).  ``None`` sites and non-tensor leaves (the static
    ``feat_shape`` ints) pass through unchanged."""
    if isinstance(tree, dict):
        return {k: slice_example(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(slice_example(v, i) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.ndim:
        return tree[i:i + 1].clone()
    return tree


def concat_examples(trees):
    """Rebuild a batch from per-example slices (inverse of
    :func:`slice_example`)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: concat_examples([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(concat_examples([t[j] for t in trees])
                           for j in range(len(first)))
    if isinstance(first, torch.Tensor) and first.ndim:
        return torch.cat(trees)
    return first


def block_until_ready(out):
    """Wait for the device work that produces ``out`` (the first tensor
    found in a nested tuple / list / dict): ``torch.cuda.synchronize`` on
    its device, where ``repro`` calls ``jax.block_until_ready``.  Clocks
    read after it measure service time, not launch time.  A no-op on the
    CPU."""
    stack = [out]
    while stack:
        t = stack.pop(0)
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            return out
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
    return out


class CNNAdapter:
    """Serve the paper CNN: residual-returning predict + fused BP explain.

    ``store_rules`` picks the rule set masks are stored under at predict
    time.  "saliency" stores the full mask/index set, which every pure-BP
    method can consume (guided ANDs the mask with the gradient sign,
    deconvnet reads only the sign — neither needs masks beyond it), so one
    predict serves follow-up explains of ANY registered mask-reuse method.

    Every engine comes from ``repro_torch.engine.build``: one per rule set,
    derived from the base spec with ``dataclasses.replace`` so precision,
    model and plan are decided exactly once.  ``device=`` / ``autotune=``
    are the tile planner's knobs (a :mod:`repro_torch.plan` profile, not a
    torch device): every engine this adapter builds, its per-rule siblings
    too, runs the plan resolved for that profile.  The model runs on the
    card; :meth:`from_engine` adapts an engine built on any device
    (``CNNModel(..., device="cpu")``).
    """

    input_kind = "image"

    def __init__(self, params, cfg: cnn.CNNConfig, *,
                 store_rules: str = "saliency", precision: str = "f32",
                 device: str = None, autotune: bool = False):
        cnn.check_precision(precision)
        self.params = params
        self.cfg = cfg
        self.store_rules = store_rules
        # Numeric knob (paper §IV): "fxp16" serves TRUE int16 fixed-point —
        # predict stores masks computed in the quantized domain and every
        # explain (hit, cold pure-BP, or composite via the engine's manual
        # ``backward``) replays the fused BP in int16.
        self.precision = precision
        # "mesh:<profile>:<n>" builds a data-parallel engine; the adapter
        # then reports n_shards and the server batches toward full mesh
        # occupancy.
        self.engine = engine_lib.build(engine_lib.EngineSpec(
            model=engine_lib.CNNModel(params, cfg), method=store_rules,
            precision=precision, device=device, autotune=autotune))
        self._engines: Dict[str, engine_lib.Engine] = {store_rules: self.engine}

    @classmethod
    def from_engine(cls, eng: engine_lib.Engine) -> "CNNAdapter":
        """Adapt an already-built engine AS CONFIGURED; its method is the
        store rule set, and every other spec field (model and its device,
        precision, backend, targets, batch, plan) is preserved — per-rule
        sibling
        engines derive from this spec via ``replace(spec, method=...)``."""
        spec = eng.spec
        self = cls.__new__(cls)
        self.params = spec.model.params
        self.cfg = spec.model.cfg
        self.store_rules = spec.method
        self.precision = spec.precision
        self.engine = eng
        self._engines = {spec.method: eng}
        return self

    @property
    def example_shape(self) -> Tuple[int, int, int]:
        """Expected per-example shape — lets the server reject malformed
        payloads at submit instead of poisoning a batch."""
        return (*self.cfg.in_hw, self.cfg.in_ch)

    @property
    def n_shards(self) -> int:
        """Mesh extent of the base engine (1 = unsharded): a
        ``device="mesh:<profile>:<n>"`` adapter reports n, so the server
        batches toward ``max_batch * n`` seats and sharded launches run at
        full mesh occupancy."""
        return self.engine.n_shards

    @property
    def device(self) -> torch.device:
        """The torch device every engine of this adapter runs on."""
        return self.engine.device

    # -- engines -------------------------------------------------------------

    def with_precision(self, precision: str) -> "CNNAdapter":
        """A sibling adapter serving the SAME weights on the same model
        handle (so the same device) at another precision — the admission
        layer's ``reroute_precision`` degradation target."""
        eng = engine_lib.build(replace(self.engine.spec, precision=precision))
        return CNNAdapter.from_engine(eng)

    def engine_for(self, rules: str) -> engine_lib.Engine:
        """The (cached) engine whose backward runs under ``rules`` — same
        spec as the base engine with only the method field changed."""
        if rules not in self._engines:
            self._engines[rules] = engine_lib.build(
                replace(self.engine.spec, method=rules))
        return self._engines[rules]

    # -- forward with residuals ----------------------------------------------

    def predict(self, xb) -> Tuple[torch.Tensor, Any]:
        """[B, H, W, C] -> (logits [B, num_classes], residual tree)."""
        return self.engine.forward(xb)

    # -- BP phase over stored residuals --------------------------------------

    def explain_cached(self, method: str, residuals, seeds) -> torch.Tensor:
        """seeds [S, B, classes] -> relevance [S, B, H, W, Cin]; NO forward."""
        return self.engine_for(method).replay(residuals, seeds)

    # -- rule-bound model fn for cold explainers -----------------------------

    def model_fn(self, rules: str):
        """Under fxp16 the returned ``f`` is the residual forward (pair
        output) — cold composite explainers must pair it with
        :meth:`manual_backward`; under f32 and bf16 it is the
        differentiable logits."""
        return self.engine_for(rules).model_fn

    def manual_backward(self, rules: str):
        """Manual BP engine for registry explainers, or None on f32 and
        bf16 (where autograd through :meth:`model_fn` is the engine)."""
        return self.engine_for(rules).composite_backward

    def attribute(self, explainer, xb, **kw):
        """A registry explainer's call on a batch (the server's cold
        composite and perturbation explains)."""
        return explainer.attribute(xb, **kw)
