"""repro_torch.perturb — the gradient-free perturbation explainers, as
``repro.perturb`` has them.

The gradient family (saliency, deconvnet, guided and the composites)
needs a backward pass; these methods are its model-agnostic complement:
mask the input N ways, run ONE forward over the ``[N*B, ...]`` fold (as IG
folds its steps axis) and aggregate the per-mask output scores into a
heatmap.  No backward anywhere, so the whole pipeline runs under
``precision="fxp16"``, where the int16 kernels have no gradient, and on any
black-box ``f(x) -> logits``.

  * ``occlusion``: deterministic sliding-window masks (Zeiler-Fergus);
    importance = the logit drop when the window is occluded.
  * ``lime``: LIME-style Bernoulli masks on a coarse cell grid, aggregated
    by a ridge-regularized weighted linear fit per example.
  * ``rise``: RISE Bernoulli grids, upsampled bilinearly with a random
    sub-cell shift, aggregated by score-weighted averaging.

Masks are drawn on the device from ``torch.Generator``s
(:mod:`repro_torch.perturb.keys`) and stored bit-packed (:class:`MaskSet`,
``core.masks.pack_mask``'s layout).  On a CNN engine the fold runs
``Engine.perturb``'s mask-free forward on the port's kernels; the serve
layer registers the methods as ``occlusion | lime | rise`` explainers
(forward-only: ``mask_reuse=False``, the residual cache is never
consulted).
"""
from repro_torch.perturb.keys import (generators, key_batch_size,
                                      pad_keys)
from repro_torch.perturb.masks import (MaskSet, lime_masks, occlusion_masks,
                                       occlusion_positions, rise_masks)
from repro_torch.perturb.scores import (PERTURB_DEFAULTS, lime, n_masks,
                                        occlusion, perturb_scores, rise)

__all__ = [
    "MaskSet", "PERTURB_DEFAULTS", "generators", "key_batch_size", "lime",
    "lime_masks", "n_masks", "occlusion", "occlusion_masks",
    "occlusion_positions", "pad_keys", "perturb_scores", "rise",
    "rise_masks",
]
