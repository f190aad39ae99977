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

    LM attribution always routes SSM segments through the scan kernel;
    this maps a :class:`repro_torch.plan.TilePlan`'s ``ssm<si>.scan``
    entries (``repro_torch.plan.lm_kernel_shapes``) onto the launch knobs.
    Segments without a plan entry, and the whole stack when ``plan`` is
    None, get the unplanned launch: the whole channel dim in one grid cell
    (``d_tile = cfg.d_inner``) at the model's ``ssm_chunk``.  The knobs
    split the grid and the staging, never an element's arithmetic.  Returns
    None for stacks without SSM segments.
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
                        mode: str = "ixg"):
    """The paper's technique as a serving feature for LMs: one forward and
    one input-gradient backward, ``(params, batch) -> (last-position
    logits [B, V], per-position scores [B, S])`` for the final position's
    prediction (vlm: the first ``n_patches`` scores are the image's;
    ``batch["frames"]`` feed an encoder-decoder's encoder).  ``mode``:
    ``"ixg"`` (input x gradient, signed), ``"grad_norm"`` (L2 norm of the
    embedding gradient) or ``"contrastive"`` (argmax-vs-runner-up
    difference seed).  ``plan`` (a
    ``plan_lm`` :class:`~repro_torch.plan.TilePlan`) sets the scan's
    ``(d_tile, chunk)`` per segment (:func:`ssm_scan_tiles`)."""
    if mode not in TOKEN_MODES:
        raise ValueError(f"mode={mode!r} not in {TOKEN_MODES}")
    scan_tiles = ssm_scan_tiles(cfg, plan)

    def attribute_step(params, batch):
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
