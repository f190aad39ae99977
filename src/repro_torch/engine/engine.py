"""The configure-once attribution engine: configure -> build -> explain.

:func:`build` turns an :class:`~repro_torch.engine.spec.EngineSpec` into an
:class:`Engine` once — backend resolution (the manual seed-batched pair or
autograd's vjp), the model's parameters moved to its device and the
backward weights prepared there — and memoizes on spec equality: equal
specs return the SAME engine, a change to any field builds afresh::

    eng = build(EngineSpec(model=CNNModel(params, cfg), method="guided",
                           targets=TopK(5)))
    logits = eng.predict(x)                          # forward only
    logits, rel = eng.explain(x)                     # FP + seed-batched BP
    logits, rel, res = eng.predict_then_explain(x)   # ...keeping residuals
    rel2 = eng.replay(res, seeds)                    # BP phase alone
    logits, ig = eng.ig(x, steps=16)                 # composites

Inputs may be NumPy arrays or tensors on any device; they move to the
model's device.  Outputs stay there.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple

import torch

from repro_torch.engine import methods
from repro_torch.engine.backward import (ManualSeedBatchedBackward,
                                         VjpBackward, vjp)
from repro_torch.engine.spec import EngineSpec, Fixed, TopK

#: Precisions whose only backward is the manual seed-batched pair.
MANUAL_ONLY = ("bf16", "fxp16")


class Engine:
    """A built attribution engine — all knobs resolved.

    Construct via :func:`build` (direct construction skips the cache).
    """

    def __init__(self, spec: EngineSpec):
        self.spec = spec
        model = spec.model
        self.device = model.device
        if hasattr(model, "token_step"):
            # LM token attribution: one step per score mode, the default
            # "ixg" now and the others at first use.
            self._token_steps = {"ixg": model.token_step(spec.method)}
            self._model_fn = self._backend = None
            return
        self._token_steps = None
        # logits only, for predict (under fxp16 the mask-free int16 forward)
        self._model_fn = model.logits_fn(spec.method, spec.precision)
        if spec.resolve_backward() == "seed_batched":
            if not model.has_pair:
                raise ValueError(f"model {model!r} exposes no seed-batched "
                                 f"pair; use backward='vjp'")
            fwd, bwd = model.pair(spec.method, spec.precision)
            self._backend = ManualSeedBatchedBackward(fwd, bwd)
        else:
            self._backend = VjpBackward(self._model_fn)

    # -- resolved surfaces ---------------------------------------------------

    @property
    def supports_replay(self) -> bool:
        return self._backend.supports_replay

    @property
    def model_fn(self):
        """Rule-bound ``f`` for direct method calls.

        f32: ``f(x) -> logits``, differentiable.  bf16 and fxp16: the pair
        forward ``f(x) -> (logits, residuals)`` — combine with
        :attr:`composite_backward` (integers have no gradient, and bf16
        under autograd is ROADMAP A6d).
        """
        if self.spec.precision in MANUAL_ONLY:
            return self._backend.forward
        return self._model_fn

    @property
    def composite_backward(self):
        """Manual BP for the methods' ``backward=`` knob under bf16 and
        fxp16, or None on f32, where autograd through :attr:`model_fn` is
        the engine."""
        if self.spec.precision in MANUAL_ONLY:
            return self._backend.backward
        return None

    # -- the two phases ------------------------------------------------------

    def predict(self, x):
        """Forward only: ``x -> logits``."""
        x, live = self._pad(self._input(x))
        with torch.no_grad():
            return self._unpad(self._model_fn(x), live)

    def forward(self, x):
        """Residual-returning forward: ``x -> (logits, residuals)``.

        Unpadded: batching discipline belongs to the caller.
        """
        return self._backend.forward(self._input(x))

    def replay(self, residuals, seeds):
        """BP phase alone: ``seeds [S, B, C] -> relevance [S, B, ...]`` over
        stored residuals (on this engine's device) — the forward-skipping
        explain (§III.F)."""
        seeds = torch.as_tensor(seeds, dtype=torch.float32).to(self.device)
        return self._backend.backward(residuals, seeds)

    # -- explain -------------------------------------------------------------

    def explain(self, x, *, target=None, topk: Optional[int] = None):
        """One FP + one seed-batched BP: ``-> (logits, relevance)``.

        Fan-out defaults to ``spec.targets``; ``target``/``topk`` override
        per call.  Scalar fan-out returns ``rel [B, ...]``; top-K returns a
        ``rel [K, B, ...]`` panel (K seeds, one launch per layer).  On the
        manual pair this is forward + replay, the same two calls a cache of
        residuals makes, so a replayed target equals a cold explain of it;
        on the vjp backend it is ONE forward with grad and then one
        backward pass per seed, so the forward never runs twice.
        """
        if self.supports_replay:
            logits, rel, _ = self.predict_then_explain(x, target=target,
                                                       topk=topk)
            return logits, rel
        target, topk = self._fanout(target, topk)
        x, live = self._pad(self._input(x))
        target = self._pad_target(target, live)
        logits, vjp_fn = vjp(self._backend.f, x)
        seeds, squeeze = self._seeds(logits, target, topk)
        rel = vjp_fn(seeds)
        rel = rel[0] if squeeze else rel
        return (self._unpad(logits, live),
                self._unpad(rel, live, axis=0 if squeeze else 1))

    def predict_then_explain(self, x, *, target=None,
                             topk: Optional[int] = None):
        """The two-phase form: ``-> (logits, relevance, residuals)``.

        The residuals can :meth:`replay` further targets later without
        another forward.  On the vjp backend the "residuals" are the padded
        input, and a replay runs the forward again.
        """
        target, topk = self._fanout(target, topk)
        x, live = self._pad(self._input(x))
        target = self._pad_target(target, live)
        logits, residuals = self._backend.forward(x)
        seeds, squeeze = self._seeds(logits, target, topk)
        rel = self._backend.backward(residuals, seeds)
        rel = rel[0] if squeeze else rel
        return (self._unpad(logits, live),
                self._unpad(rel, live, axis=0 if squeeze else 1),
                residuals)

    # -- composite methods (engine/methods.py) on the same model ------------

    def ig(self, x, *, steps: int = 16, baseline=None, target=None,
           batched: bool = True):
        """Integrated gradients (the steps axis folded into the batch)."""
        return methods.integrated_gradients(
            self.model_fn, self._input(x), steps=steps, baseline=baseline,
            target=target, batched=batched,
            backward=self.composite_backward)

    def smoothgrad(self, x, generator, *, n: int = 8, sigma: float = 0.1,
                   target=None, batched: bool = True):
        """SmoothGrad, its noise drawn from ``generator``, or from one
        generator per example (a sequence), the noise axis folded into the
        batch."""
        return methods.smoothgrad(
            self.model_fn, self._input(x), generator, n=n, sigma=sigma,
            target=target, batched=batched,
            backward=self.composite_backward)

    def input_x_gradient(self, x, *, target=None):
        """Gradient . input refinement."""
        return methods.input_x_gradient(self.model_fn, self._input(x),
                                        target=target,
                                        backward=self.composite_backward)

    def contrastive(self, x, target_a, target_b):
        """Why A rather than B — one difference-seeded BP pass."""
        return methods.contrastive(self.model_fn, self._input(x), target_a,
                                   target_b,
                                   backward=self.composite_backward)

    def attribute_classes(self, x, targets):
        """K explicit classes from one forward (seed-batched when manual)."""
        if self.supports_replay:
            return methods.attribute_classes(self._backend.forward,
                                             self._input(x), targets,
                                             backward=self._backend.backward)
        return methods.attribute_classes(self._model_fn, self._input(x),
                                         targets)

    # -- LM token attribution ------------------------------------------------

    def explain_tokens(self, batch, *, mode: str = "ixg"):
        """LM engines: ``batch -> (last-position logits [B, V], scores
        [B, S])`` — per-prompt-position relevance of the next-token
        prediction.  ``mode`` picks the score reduction (``ixg``,
        ``grad_norm``, ``contrastive``); each mode's step is built once."""
        if self._token_steps is None:
            raise ValueError(
                f"{type(self.spec.model).__name__} engines explain arrays; "
                f"explain_tokens needs an LMModel spec")
        step = self._token_steps.get(mode)
        if step is None:
            step = self.spec.model.token_step(self.spec.method, mode=mode)
            self._token_steps[mode] = step
        return step(batch)

    # -- internals -----------------------------------------------------------

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(
            self.device).contiguous()

    def _fanout(self, target, topk) -> Tuple[Any, Optional[int]]:
        """Apply ``spec.targets`` defaults to per-call overrides."""
        if topk is None and target is None:
            tspec = self.spec.targets
            if isinstance(tspec, TopK):
                topk = tspec.k
            elif isinstance(tspec, Fixed):
                target = tspec.target
        return target, topk

    def _seeds(self, logits, target, topk) -> Tuple[torch.Tensor, bool]:
        """Fan-out (already spec-resolved) to one-hot seeds [S, B, C]; True
        = squeeze the S=1 axis after the backward."""
        if topk is not None:
            idx = methods.top_k(logits, topk).T                  # [K, B]
            return methods.one_hot(idx, logits.shape[-1], logits), False
        return methods.output_seed(logits, target)[None], True

    def _pad(self, x) -> Tuple[torch.Tensor, Optional[int]]:
        """Pad the leading batch dim up to ``spec.batch`` (row-0 repeats)."""
        b = self.spec.batch
        if b is None:
            return x, None
        n = x.shape[0]
        if n > b:
            raise ValueError(f"batch {n} exceeds spec.batch={b}")
        if n == b:
            return x, n
        pad = x[:1].expand((b - n,) + tuple(x.shape[1:]))
        return torch.cat([x, pad]), n

    def _pad_target(self, target, live):
        """Pad a per-example [live] target array alongside the padded batch
        (padding rows explain class 0 and are sliced off with the batch)."""
        if live is None or target is None:
            return target
        t = torch.as_tensor(target)
        if t.ndim == 0 or t.shape[0] != live or live == self.spec.batch:
            return t
        pad = torch.zeros((self.spec.batch - live,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        return torch.cat([t, pad])

    @staticmethod
    def _unpad(out, live, axis: int = 0):
        if live is None:
            return out
        return out.narrow(axis, 0, live)

    def __repr__(self):
        return f"<Engine {self.spec!r}>"


# ---------------------------------------------------------------------------
# the build cache: equal specs share one engine
# ---------------------------------------------------------------------------

_BUILD_CACHE: "OrderedDict[EngineSpec, Engine]" = OrderedDict()

#: LRU bound on memoized engines.  Specs hold strong references to their
#: params trees, so an unbounded cache would pin every params object a
#: long-lived process ever built; evicted engines keep working for whoever
#: still holds them — only the sharing via ``build()`` lapses.
MAX_CACHED_ENGINES = 64


def build(spec: EngineSpec) -> Engine:
    """Resolve an engine for ``spec``, memoized on spec equality (LRU
    bounded at ``MAX_CACHED_ENGINES``)."""
    eng = _BUILD_CACHE.get(spec)
    if eng is None:
        _BUILD_CACHE[spec] = eng = Engine(spec)
        while len(_BUILD_CACHE) > MAX_CACHED_ENGINES:
            _BUILD_CACHE.popitem(last=False)
    else:
        _BUILD_CACHE.move_to_end(spec)
    return eng


def clear_cache() -> None:
    """Drop every memoized engine."""
    _BUILD_CACHE.clear()


def cache_size() -> int:
    return len(_BUILD_CACHE)
