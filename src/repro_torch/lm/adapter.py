"""LMAdapter — token-attribution serving behind the CNN adapter protocol, as
``repro.lm.adapter`` has it.

The serve dispatch loop (:mod:`repro_torch.serve.server`) is
adapter-agnostic: admission, micro-batching, tracing, and fault isolation
all run the same whether a request carries an image or a token sequence.
This adapter makes LM requests flow through it:

  * ``input_kind = "tokens"`` — payloads are int token ids ``[S]``;
  * ``example_shape`` is None — sequences come in many lengths, so the
    server skips its fixed-shape check and the BATCHER's bucket key (which
    includes the payload shape) provides the discipline instead:
    equal-length requests co-batch, different lengths never share a launch.
    :func:`bucket_len` / :func:`pad_tokens` give clients the pow2 length
    grid that keeps the number of distinct shapes small;
  * ``predict`` is the last-position logits of
    :func:`repro_torch.models.transformer.forward`, run eagerly without
    grad, returning ``(logits, None)`` — there are NO replayable residuals
    for the token stack (``mask_reuse=False`` on every token explainer), so
    the residual cache stores nothing useful and :meth:`explain_cached`
    refuses loudly;
  * per-rule engines come from the same build cache as everyone else's
    (``replace(spec, method=...)``), so the registry's token explainers
    ride the engine's B13 scan route.

The adapter runs where its ``LMModel`` runs (the card unless told
otherwise).  Only the mamba stacks are ported (other archs: ROADMAP A11b).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import engine as engine_lib
from repro_torch.serve.adapters import check_planner_knobs

#: Token id LEFT-padding fills with.  The stacks are unmasked, so padding
#: shifts absolute positions — an approximation the pow2 length grid bounds
#: (a request is padded at most to the next bucket, never arbitrarily).
PAD_ID = 0

#: Smallest sequence bucket; shorter requests pad up to it.
MIN_BUCKET = 8


def bucket_len(s: int, min_len: int = MIN_BUCKET) -> int:
    """The pow2 sequence-length bucket for a length-``s`` request."""
    n = max(int(s), 1)
    b = max(int(min_len), 1)
    while b < n:
        b *= 2
    return b


def pad_tokens(tokens, length: Optional[int] = None,
               pad_id: int = PAD_ID) -> torch.Tensor:
    """LEFT-pad a ``[S]`` or ``[B, S]`` token array to ``length``
    (default: its :func:`bucket_len`); an int32 tensor on the tokens'
    device (the host for arrays).

    Left padding keeps the live tokens adjacent to the explained position
    (the final one); the per-position scores of the padded prefix are
    reported but meaningless, exactly like a padded batch row.
    """
    t = (tokens if isinstance(tokens, torch.Tensor)
         else torch.from_numpy(np.asarray(tokens))).to(torch.int32)
    s = t.shape[-1]
    length = bucket_len(s) if length is None else int(length)
    if length < s:
        raise ValueError(f"cannot pad length-{s} tokens down to {length}")
    if length == s:
        return t
    return torch.nn.functional.pad(t, (length - s, 0), value=pad_id)


class LMAdapter:
    """Serve token-level LM attribution through the ExplanationServer.

    ``device=`` / ``autotune=`` are ``repro``'s planner knobs (a plan
    profile for the scan's chunking) and raise naming ROADMAP A10 unless
    left at their defaults.  The model runs on the card; :meth:`from_engine`
    adapts an engine built on any device (``LMModel(..., device="cpu")``).
    """

    input_kind = "tokens"

    def __init__(self, params, cfg, *, store_rules: str = "saliency",
                 precision: str = "f32", device: Optional[str] = None,
                 autotune: bool = False):
        check_planner_knobs(device, autotune)
        self.params = params
        self.cfg = cfg
        self.store_rules = store_rules
        self.precision = precision
        self.engine = engine_lib.build(engine_lib.EngineSpec(
            model=engine_lib.LMModel(params, cfg),
            method=store_rules, precision=precision))
        self._engines = {store_rules: self.engine}

    @classmethod
    def from_engine(cls, eng: engine_lib.Engine) -> "LMAdapter":
        """Adapt an already-built LM engine as configured."""
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
    def example_shape(self):
        """None: sequences bucket by length (batcher key), not one shape."""
        return None

    @property
    def n_shards(self) -> int:
        return 1

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # -- engines -------------------------------------------------------------

    def with_precision(self, precision: str) -> "LMAdapter":
        eng = engine_lib.build(replace(self.engine.spec,
                                       precision=precision))
        return LMAdapter.from_engine(eng)

    def engine_for(self, rules: str) -> engine_lib.Engine:
        if rules not in self._engines:
            self._engines[rules] = engine_lib.build(
                replace(self.engine.spec, method=rules))
        return self._engines[rules]

    # -- the server programs -------------------------------------------------

    def predict(self, xb) -> Tuple[torch.Tensor, None]:
        """tokens [B, S] -> (last-position logits [B, V], residuals=None).

        No residuals: the token stack has no replayable mask pair, so a
        PREDICT parks nothing reusable in the cache (the explainers are all
        ``mask_reuse=False`` and never look).
        """
        from repro_torch.models import transformer as tf
        model = self.engine.spec.model
        tokens = torch.as_tensor(xb).to(model.device, torch.int64)
        with torch.no_grad():
            logits, _ = tf.forward(model.device_params, self.cfg,
                                   {"tokens": tokens},
                                   method=self.store_rules)
        return logits[:, -1, :], None

    def explain_cached(self, method: str, residuals, seeds):
        raise ValueError(
            "LM serving has no residual replay: token attribution re-runs "
            "the forward (decode-loop KV/residual reuse is a roadmap "
            "stretch); token explainers are mask_reuse=False and never "
            "take this path")

    def model_fn(self, rules: str):
        """LM engines expose no array ``model_fn``; the registry's token
        explainers dispatch through ``engine.explain_tokens`` instead."""
        return self.engine_for(rules).model_fn

    def manual_backward(self, rules: str):
        return self.engine_for(rules).composite_backward
