"""Architecture registry, as ``repro.configs`` has it: ``get(name)`` is the
FULL (published) config, ``get_smoke(name)`` the reduced same-family one.

Every name of :data:`ARCHS` has a module here, a copy of the JAX
package's (dense, MoE, mamba, hybrid, encoder-decoder and vlm).  The
paper's own CNN is not an LM arch: its configs (``paper_cnn``: ``FULL``,
``TABLE_III_LITERAL``, ``SMOKE``) come from :func:`cnn`.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "falcon-mamba-7b",
    "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b",
    "llama3.2-1b",
    "phi4-mini-3.8b",
    "qwen2-1.5b",
    "internlm2-20b",
    "hymba-1.5b",
    "seamless-m4t-medium",
    "llava-next-mistral-7b",
)

#: The configs the port has: all of them.
PORTED = ARCHS


def _module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCHS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get(arch: str) -> ModelConfig:
    """The FULL (exact published) config."""
    return _module(arch).FULL


def get_smoke(arch: str) -> ModelConfig:
    """The reduced same-family smoke config (CPU-runnable)."""
    return _module(arch).SMOKE


#: The paper's Table III CNN configs (``configs/paper_cnn.py``).
CNN_CONFIGS = ("FULL", "TABLE_III_LITERAL", "SMOKE")


def cnn(name: str = "FULL"):
    """One of the paper CNN's configs (a ``models.cnn.CNNConfig``)."""
    if name not in CNN_CONFIGS:
        raise ValueError(f"unknown paper_cnn config {name!r}; known: "
                         f"{CNN_CONFIGS}")
    return getattr(importlib.import_module("repro_torch.configs.paper_cnn"),
                   name)
