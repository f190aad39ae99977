"""EngineSpec — the declarative, configure-once attribution configuration.

The paper's accelerator is configured once (algorithm, layer shapes,
numeric format) and then runs inference + backprop many times with no
per-request setup.  ``EngineSpec`` is that configuration as a frozen,
hashable value::

    spec = EngineSpec(model=CNNModel(params, cfg), method="guided",
                      targets=TopK(5))
    eng = repro_torch.engine.build(spec)     # resolves once
    logits, rel = eng.explain(images)        # steady state: no setup

Fields and semantics follow ``repro.engine.spec``.  What this slice of the
port does not run raises :class:`NotImplementedError` naming its ROADMAP
item.  The torch device belongs to the model handle
(``CNNModel(..., device=)``), not to ``EngineSpec.device``, which names a
JAX-side planner profile.

Model handles compare by parameter IDENTITY (the params object), config
and device — tensors have no cheap equality — so rebinding the same params
reuses the build cache and a fresh params tree builds a fresh engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple, Union

import torch

BACKWARDS = ("auto", "vjp", "seed_batched")
RULE_SETS = ("saliency", "deconvnet", "guided")
PERTURB_METHODS = ("occlusion", "lime", "rise")


# ---------------------------------------------------------------------------
# target fan-out policy (the paper's §III.F: which output seeds to replay)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Argmax:
    """Explain the predicted class (the paper's default seed)."""


@dataclass(frozen=True)
class Fixed:
    """Always explain one fixed class id."""

    target: int


@dataclass(frozen=True)
class TopK:
    """Explain the top-K classes per example — K one-hot seeds ride the
    seed-batched axis, every stored mask loaded once (§III.F)."""

    k: int

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"TopK.k must be >= 1, got {self.k}")


TargetSpec = Union[Argmax, Fixed, TopK]


# ---------------------------------------------------------------------------
# model handles
# ---------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """``None`` -> the card.  Without CUDA only an explicit CPU request is
    honoured: the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev


@dataclass(frozen=True, eq=False)
class CNNModel:
    """Handle on the paper's Table III CNN (:mod:`repro_torch.models.cnn`).

    ``params`` is a ``{"conv": [...], "fc": [...]}`` tree of f32 tensors on
    any device; the engine copies it to ``device`` once.  ``device=None``
    means the card and raises where there is none.
    """

    params: Any
    cfg: Any                    # cnn.CNNConfig
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _key(self) -> Tuple:
        return (id(self.params), self.cfg, self.device)

    def __eq__(self, other):
        return type(other) is type(self) and self._key() == other._key()

    def __hash__(self):
        return hash((type(self).__name__,) + self._key())

    def pair(self, method: str, precision: str) -> Tuple[Callable, Callable]:
        """The seed-batched ``(forward, backward)`` closure pair.

        ``forward(x) -> (logits, residuals)``; ``backward(residuals, seeds
        [S, B, classes]) -> relevance [S, B, H, W, Cin]``.  Parameters move
        to the device and are quantized under fxp16, and the backward
        weights (flip-transposed kernels, contiguous ``W^T``) are made from
        them here, once per pair (the JAX package quantizes per call; the
        numbers are the same).
        """
        from repro_torch.models import cnn
        cnn.check_precision(precision)
        params = cnn.params_to(self.params, self.device)
        fwd_params = cnn.prepare_params(params, precision)
        bwd_weights = cnn.backward_weights(fwd_params)
        cfg = self.cfg

        def forward(x):
            return cnn.forward_with_residuals(params, x, cfg, method,
                                              precision, fwd_params)

        def backward(residuals, seeds):
            return cnn.backward_seeds(params, residuals, seeds, cfg, method,
                                      precision, bwd_weights=bwd_weights)

        return forward, backward

    def logits_fn(self, method: str, precision: str) -> Callable:
        """Logits-only ``f(x)`` for ``Engine.predict`` (under fxp16 the
        dequantized logits of the int16 forward)."""
        from repro_torch.models import cnn
        cnn.check_precision(precision)
        params = cnn.params_to(self.params, self.device)
        fwd_params = cnn.prepare_params(params, precision)
        cfg = self.cfg

        def f(x):
            return cnn.apply(params, x, cfg, method=method,
                             precision=precision, fwd_params=fwd_params)

        return f


# ---------------------------------------------------------------------------
# the spec itself
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EngineSpec:
    """Declarative configure-once description of an attribution engine.

    Fields as in ``repro.engine.spec.EngineSpec``: ``model`` (a
    :class:`CNNModel`), ``method`` (``saliency | deconvnet | guided``),
    ``precision`` (``f32`` or ``fxp16``, the paper's true-int16 datapath),
    ``backward`` (``auto`` or ``seed_batched``; fxp16 is integer arithmetic
    and has no ``vjp``),
    ``targets`` (:class:`Argmax`, :class:`Fixed` or :class:`TopK`), and
    ``batch`` (inputs are padded up to it and outputs sliced back).  The
    JAX package's planner knobs ``device``/``plan``/``autotune`` and the
    perturbation fields are accepted only at their defaults.
    """

    model: Any
    method: str = "saliency"
    precision: str = "f32"
    backward: str = "auto"
    targets: TargetSpec = field(default_factory=Argmax)
    batch: Optional[int] = None
    device: Optional[str] = None
    plan: Optional[Any] = None
    autotune: bool = False
    n_samples: Optional[int] = None

    def __post_init__(self):
        if self.method in PERTURB_METHODS:
            raise NotImplementedError(
                f"method={self.method!r}: perturbation methods are not "
                f"ported yet (ROADMAP A8)")
        if self.method not in RULE_SETS:
            raise ValueError(f"method={self.method!r} not in "
                             f"{RULE_SETS + PERTURB_METHODS}")
        if self.n_samples is not None:
            raise ValueError(
                f"n_samples applies to stochastic perturbation methods "
                f"('lime', 'rise'); method={self.method!r}")
        from repro_torch.models.cnn import check_precision
        check_precision(self.precision)
        if self.backward not in BACKWARDS:
            raise ValueError(
                f"backward={self.backward!r} not in {BACKWARDS}")
        if self.precision == "fxp16" and self.backward == "vjp":
            raise ValueError("precision='fxp16' is integer arithmetic — "
                             "no vjp exists; use backward='auto' or "
                             "'seed_batched'")
        if self.backward == "vjp":
            raise NotImplementedError(
                "backward='vjp' (VjpBackward on torch.func) is not ported "
                "yet (ROADMAP A5 remainder); use 'auto' or 'seed_batched'")
        if self.batch is not None and self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        for knob, default in (("device", None), ("plan", None),
                              ("autotune", False)):
            if getattr(self, knob) != default:
                raise NotImplementedError(
                    f"EngineSpec.{knob}= is the JAX package's tile-planner "
                    f"knob, not ported yet (ROADMAP A10); the torch device "
                    f"is CNNModel(..., device=)")
        if not isinstance(self.model, CNNModel):
            raise NotImplementedError(
                f"model {self.model!r}: only CNNModel is ported (FnModel "
                f"is ROADMAP A5 remainder, LMModel ROADMAP A11)")
