"""Free-function surface over :mod:`repro_torch.engine.methods`, as
``repro.core.attribution`` re-exports ``repro.engine.methods``: pure
re-exports, ``backward=`` knob included.  New code builds an engine.
"""
from repro_torch.engine.methods import (METHODS, attribute,  # noqa: F401
                                        attribute_classes,
                                        attribute_tokens,
                                        attribute_tokens_contrastive,
                                        contrastive,
                                        fold_batched_gradients, heatmap,
                                        input_x_gradient,
                                        integrated_gradients, output_seed,
                                        smoothgrad)

__all__ = [
    "METHODS", "attribute", "attribute_classes", "attribute_tokens",
    "attribute_tokens_contrastive", "contrastive",
    "fold_batched_gradients", "heatmap", "input_x_gradient",
    "integrated_gradients", "output_seed", "smoothgrad",
]
