"""The LM token-attribution step, as ``repro.launch.steps`` builds it:
``TOKEN_MODES``, :func:`ssm_scan_tiles` and :func:`make_attribute_step`.
The train / prefill / decode steps and the sharding trees of that module
are ROADMAP A12.
"""
from __future__ import annotations

from repro_torch.engine import methods as engine_methods
from repro_torch.models import transformer as tf

#: Per-token score reductions ``make_attribute_step`` builds.
TOKEN_MODES = ("ixg", "grad_norm", "contrastive")


def ssm_scan_tiles(cfg, plan=None):
    """Per-SEGMENT ``{si: (d_tile, chunk)}`` launch knobs for the B13 scan.

    LM attribution always routes SSM segments through the scan kernel, with
    the JAX package's unplanned launch: the whole channel dim in one grid
    cell (``d_tile = cfg.d_inner``) at the model's ``ssm_chunk``.  Returns
    None for stacks without SSM segments.  Planned knobs (``plan=``) are
    ROADMAP A10.
    """
    if plan is not None:
        raise NotImplementedError("plan=: the tile planner is not ported "
                                  "yet (ROADMAP A10)")
    tiles = {si: (cfg.d_inner, cfg.ssm_chunk)
             for si, (kind, _, _) in enumerate(cfg.layer_plan())
             if kind in ("mamba", "hybrid")}
    return tiles or None


def make_attribute_step(cfg, method: str = "saliency", *, mode: str = "ixg"):
    """The paper's technique as a serving feature for LMs: one forward and
    one input-gradient backward, ``(params, batch) -> (last-position
    logits [B, V], per-position scores [B, S])`` for the final position's
    prediction.  ``mode``: ``"ixg"`` (input x gradient, signed),
    ``"grad_norm"`` (L2 norm of the embedding gradient) or
    ``"contrastive"`` (argmax-vs-runner-up difference seed)."""
    if mode not in TOKEN_MODES:
        raise ValueError(f"mode={mode!r} not in {TOKEN_MODES}")
    scan_tiles = ssm_scan_tiles(cfg)

    def attribute_step(params, batch):
        h = tf.embed_inputs(params, cfg, batch)

        def f(e):
            return tf.forward_from_embeddings(params, cfg, e, method=method,
                                              scan_tiles=scan_tiles)[0]

        if mode == "contrastive":
            logits, rel, scores = engine_methods.attribute_tokens_contrastive(
                f, h)
        else:
            logits, rel, scores = engine_methods.attribute_tokens(f, h)
            if mode == "grad_norm":
                scores = rel.float().norm(dim=-1)
        return logits[:, -1, :], scores

    return attribute_step
