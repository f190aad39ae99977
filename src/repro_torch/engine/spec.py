"""EngineSpec — the declarative, configure-once attribution configuration.

The paper's accelerator is configured once (algorithm, layer shapes,
numeric format) and then runs inference + backprop many times with no
per-request setup.  ``EngineSpec`` is that configuration as a frozen,
hashable value::

    spec = EngineSpec(model=CNNModel(params, cfg), method="guided",
                      targets=TopK(5))
    eng = repro_torch.engine.build(spec)     # resolves once
    logits, rel = eng.explain(images)        # steady state: no setup

Fields and semantics follow ``repro.engine.spec``.  What the port does not
run yet raises :class:`NotImplementedError` naming its ROADMAP item.  The
torch device belongs to the model handle (``CNNModel(..., device=)``,
``FnModel(..., device=)``), not to ``EngineSpec.device``, which names a
tile planner profile (:mod:`repro_torch.plan`): ``h100``, whose plans the
card's kernels launch, or one of the JAX package's, whose plans are
audits on the card.

Model handles compare by IDENTITY of their params object (or factory),
plus config and device — tensors have no cheap equality — so rebinding the
same params reuses the build cache and a fresh params tree builds a fresh
engine.
"""
from __future__ import annotations

import functools
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


class _ParamsIdentity:
    """eq/hash mixin: params by object identity, the rest by value."""

    def _key(self) -> Tuple:
        raise NotImplementedError

    def __eq__(self, other):
        return type(other) is type(self) and self._key() == other._key()

    def __hash__(self):
        return hash((type(self).__name__,) + self._key())


@dataclass(frozen=True, eq=False)
class CNNModel(_ParamsIdentity):
    """Handle on the paper's Table III CNN (:mod:`repro_torch.models.cnn`).

    ``params`` is a ``{"conv": [...], "fc": [...]}`` tree of f32 (or, for
    a bfloat16 config, bf16) tensors on any device; the engine copies it to
    ``device`` once.  ``use_pallas=True`` (default) runs the kernels — the
    fused blocks, required for the seed-batched pair and so for fxp16;
    ``use_pallas=False`` keeps the plain reference ops, where only the
    ``vjp`` backend exists (f32 and bf16).  ``device=None`` means the card
    and raises where there is none.
    """

    params: Any
    cfg: Any                    # cnn.CNNConfig
    use_pallas: bool = True
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _key(self):
        return (id(self.params), self.cfg, self.use_pallas, self.device)

    @property
    def has_pair(self) -> bool:
        return self.use_pallas

    def pair(self, method: str, precision: str,
             plan=None) -> Tuple[Callable, Callable]:
        """The seed-batched ``(forward, backward)`` closure pair.

        ``forward(x) -> (logits, residuals)``; ``backward(residuals, seeds
        [S, B, classes]) -> relevance [S, B, H, W, Cin]``.  Parameters move
        to the device and are quantized under fxp16, and the backward
        weights (flip-transposed kernels, contiguous ``W^T``) are made from
        them here, once per pair (the JAX package quantizes per call; the
        numbers are the same).  ``plan``: a
        :class:`repro_torch.plan.TilePlan` whose ``h100`` entries the
        launches of their planned shapes run.
        """
        from repro_torch.models import cnn
        cnn.check_precision(precision)
        params = cnn.params_to(self.params, self.device)
        fwd_params = cnn.prepare_params(params, precision)
        bwd_weights = cnn.backward_weights(fwd_params)
        cfg = self.cfg

        def forward(x):
            return cnn.forward_with_residuals(params, x, cfg, method,
                                              precision, fwd_params, plan)

        def backward(residuals, seeds):
            return cnn.backward_seeds(params, residuals, seeds, cfg, method,
                                      precision, bwd_weights=bwd_weights,
                                      plan=plan)

        return forward, backward

    def fold_fn(self, precision: str, plan=None) -> Callable:
        """``f(x) -> logits`` for a folded perturbation batch: on the kernel
        path the mask-free forward (``cnn.apply_fold``), otherwise the
        plain reference ops of :meth:`logits_fn`."""
        if not self.use_pallas:
            return self.logits_fn("saliency", precision, plan)
        from repro_torch.models import cnn
        cnn.check_precision(precision)
        params = cnn.params_to(self.params, self.device)
        fwd_params = cnn.prepare_params(params, precision)
        cfg = self.cfg

        def f(x):
            return cnn.apply_fold(params, x, cfg, precision, fwd_params,
                                  plan)

        return f

    def logits_fn(self, method: str, precision: str,
                  plan=None) -> Callable:
        """Rule-bound ``f(x) -> logits`` (``cnn.apply``), differentiable
        with respect to ``x`` in f32 and bf16 (bf16 logits, an f32 ``x``'s
        gradient f32): the ``vjp`` backend and the composite methods run
        autograd through it.  Under fxp16 it is the dequantized logits of
        the int16 forward, for ``Engine.predict`` only (integers have no
        gradient)."""
        from repro_torch.models import cnn
        cnn.check_precision(precision)
        params = cnn.params_to(self.params, self.device)
        fwd_params = cnn.prepare_params(params, precision)
        cfg, use_pallas = self.cfg, self.use_pallas

        def f(x):
            return cnn.apply(params, x, cfg, method=method,
                             use_pallas=use_pallas, precision=precision,
                             fwd_params=fwd_params, plan=plan)

        return f


@dataclass(frozen=True, eq=False)
class LMModel(_ParamsIdentity):
    """Handle on the LM zoo for token attribution
    (:func:`repro_torch.launch.steps.make_attribute_step`): FP +
    input-gradient BP over the embedding stack, scores reduced per prompt
    position.  ``params`` is a :mod:`repro_torch.models.transformer` tree
    of any arch of the zoo, on any device; it moves to ``device`` (None:
    the card) once, at the first step built.  ``triangle_skip`` is the
    chunked attention's static skip of masked causal chunks."""

    params: Any
    cfg: Any                    # models.config.ModelConfig
    device: Any = None
    triangle_skip: bool = True

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _key(self):
        return (id(self.params), self.cfg, self.device, self.triangle_skip)

    @property
    def has_pair(self) -> bool:
        return False            # vjp-only: no manual residual pair for LMs

    @functools.cached_property
    def device_params(self):
        """``params`` on ``device`` (the same tensors where already there)."""
        from repro_torch.models import transformer
        return transformer.params_to(self.params, self.device)

    def token_step(self, method: str, *, plan=None,
                   mode: str = "ixg") -> Callable:
        """``(batch) -> (last-position logits [B, V], scores [B, S])``.

        ``method`` must be a gradient rule set; ``mode`` picks the
        per-token reduction (``ixg | grad_norm | contrastive``, see
        :func:`repro_torch.launch.steps.make_attribute_step`) and ``plan``
        the scan's knobs (a ``plan_lm`` TilePlan).  The token ids of
        ``batch["tokens"]`` move to the model's device, and so do the
        ``"patches"`` of a vlm and the ``"frames"`` of an encoder-decoder.
        """
        if method not in RULE_SETS:
            raise ValueError(
                f"token attribution needs a gradient rule set {RULE_SETS}; "
                f"method={method!r} has no token BP")
        from repro_torch.launch import steps as steps_lib
        step = steps_lib.make_attribute_step(
            self.cfg, method, triangle_skip=self.triangle_skip, plan=plan,
            mode=mode)
        params, device = self.device_params, self.device

        def run(batch):
            moved = {"tokens": torch.as_tensor(batch["tokens"]).to(
                device, torch.int64)}
            for name in ("patches", "frames"):
                if name in batch:
                    moved[name] = torch.as_tensor(batch[name]).to(device)
            return step(params, moved)

        return run


@dataclass(frozen=True, eq=False)
class FnModel(_ParamsIdentity):
    """Handle on an arbitrary rule-bound callable factory.

    ``make_f(method) -> f(x) -> logits``, differentiable with respect to
    ``x`` — the escape hatch for models outside the zoo.  vjp-only (no
    manual pair).  Identity-hashed on the factory object.  ``device`` is
    where ``f`` computes (inputs move there); ``None`` means the card.
    """

    make_f: Callable[[str], Callable]
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _key(self):
        return (id(self.make_f), self.device)

    @property
    def has_pair(self) -> bool:
        return False

    def logits_fn(self, method: str, precision: str,
                  plan=None) -> Callable:
        """``make_f(method)``; ``plan`` is accepted and unused (an
        arbitrary model has no planned kernels)."""
        if precision == "fxp16":
            raise ValueError("FnModel has no manual pair; precision='fxp16' "
                             "requires a model exposing seed-batched "
                             "residuals (e.g. CNNModel)")
        return self.make_f(method)


# ---------------------------------------------------------------------------
# the spec itself
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EngineSpec:
    """Declarative configure-once description of an attribution engine.

    Fields as in ``repro.engine.spec.EngineSpec``: ``model`` (a
    :class:`CNNModel`, :class:`FnModel` or :class:`LMModel`), ``method``
    (``saliency | deconvnet | guided``, or the forward-only perturbation
    methods ``occlusion | lime | rise`` of ``Engine.perturb``),
    ``precision`` (``f32``, ``bf16``,
    or ``fxp16``, the paper's true-int16 datapath), ``backward`` (``auto``
    resolves to the seed-batched pair when the model has one, else
    ``vjp``; fxp16 is integer arithmetic and has no ``vjp``; bf16 under
    ``vjp`` runs autograd through the bf16 blocks, bf16 logits and the
    f32 relevance of the f32 input, as the JAX package's; an LM's dtype is
    its config's whatever the precision, and fxp16 needs a pair, which no
    LM has),
    ``targets`` (:class:`Argmax`, :class:`Fixed` or :class:`TopK`), and
    ``batch`` (inputs are padded up to it and outputs sliced back) and
    ``n_samples`` (the fan-out of ``lime`` / ``rise``, None for the method
    default; occlusion's is geometric and refuses it).  The planner's
    knobs:

      * ``device`` — a :mod:`repro_torch.plan` profile name (or profile):
        ``h100`` (on the card; ``detected`` resolves to it there) plans the
        card's own launch objects, which the kernels of the planned shapes
        launch; the JAX package's profiles (``detected`` on the CPU,
        ``tpu-v4``, ``edge-*``) plan TPU tiles, which on the card are
        audits (:class:`~repro_torch.plan.InfeasiblePlanError` before any
        launch) while the kernels launch under their own rules.
        ``mesh:<p>:<n>`` plans each of n shards of ``<p>`` at its slice of
        the batch, and a CNN engine on it is data parallel over
        ``make_serving_mesh(n)`` (the ranks of the process group, capped
        at the world size; one rank without a group); an LM engine builds
        unsharded, as the JAX package's.
      * ``plan`` — an explicit :class:`repro_torch.plan.TilePlan`
        (overrides ``device``-driven planning).
      * ``autotune`` — refine the plan by measured kernel times at build
        time, through the persistent tuning cache.
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
        if self.method not in RULE_SETS + PERTURB_METHODS:
            raise ValueError(f"method={self.method!r} not in "
                             f"{RULE_SETS + PERTURB_METHODS}")
        if self.n_samples is not None:
            if self.method not in ("lime", "rise"):
                raise ValueError(
                    f"n_samples applies to stochastic perturbation methods "
                    f"('lime', 'rise'); method={self.method!r}")
            if self.n_samples < 1:
                raise ValueError(
                    f"n_samples must be >= 1, got {self.n_samples}")
        if self.method in PERTURB_METHODS and isinstance(self.targets, TopK):
            raise ValueError(
                "perturbation methods explain one target per example (no "
                "seed-batched BP to ride a top-K panel); use Argmax/Fixed "
                "targets")
        from repro_torch.models.cnn import check_precision
        check_precision(self.precision)
        if self.backward not in BACKWARDS:
            raise ValueError(
                f"backward={self.backward!r} not in {BACKWARDS}")
        if self.precision == "fxp16" and self.backward == "vjp":
            raise ValueError("precision='fxp16' is integer arithmetic — "
                             "no vjp exists; use backward='auto' or "
                             "'seed_batched'")
        if self.batch is not None and self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.device is not None:
            from repro_torch.plan import get_profile
            get_profile(self.device)             # validate the name eagerly
        if self.plan is not None:
            from repro_torch.plan import TilePlan
            if not isinstance(self.plan, TilePlan):
                raise TypeError(f"plan must be a repro_torch.plan.TilePlan, "
                                f"got {type(self.plan).__name__}")
        if not isinstance(self.model, (CNNModel, FnModel, LMModel)):
            raise NotImplementedError(
                f"model {self.model!r}: the handles are CNNModel, FnModel "
                f"and LMModel (every arch of the LM zoo, ROADMAP A11)")

    def fwd_rules(self) -> str:
        """The rule set the model is built with: the method's, or saliency
        for the forward-only perturbation methods, whose rules never run
        (their logits are every rule set's)."""
        return self.method if self.method in RULE_SETS else "saliency"

    def resolve_backward(self) -> str:
        """The backend ``build`` will actually use (auto-selection rule)."""
        if self.backward != "auto":
            return self.backward
        has_pair = getattr(self.model, "has_pair", False)
        if self.precision == "fxp16":
            if not has_pair:
                raise ValueError(
                    "precision='fxp16' needs a model with a seed-batched "
                    "pair (CNNModel(use_pallas=True))")
            return "seed_batched"
        return "seed_batched" if has_pair else "vjp"

    def resolve_plan(self):
        """The :class:`repro_torch.plan.TilePlan` the built engine runs,
        or None.

        An explicit ``plan`` wins; otherwise a ``device`` plans the model's
        kernel shapes — ``plan_cnn`` for a CNN with the seed-batched pair,
        ``plan_lm`` (the scan's ``(d_tile, chunk)``) for an LM with mamba
        segments; other models have no planned kernels.  The plan covers
        the spec's declared shapes: ``batch`` (or 1) x the targets' fan-out
        (TopK rides the seeds axis).  Composites that fold extra axes into
        the batch re-audit at call time (``Engine._engine_for_fold``).
        ``autotune`` measures through the default tuning cache.
        """
        if self.plan is not None:
            return self.plan
        if self.device is None or not hasattr(self.model, "cfg"):
            return None
        from repro_torch.plan import (LM_PLAN_SEQ, TuningCache, plan_cnn,
                                      plan_lm)
        cache = TuningCache() if self.autotune else None
        if hasattr(self.model, "token_step"):
            cfg = self.model.cfg
            if not any(k in ("mamba", "hybrid")
                       for k, _, _ in cfg.layer_plan()):
                return None
            return plan_lm(cfg, device=self.device, precision=self.precision,
                           batch=self.batch or 1, seq=LM_PLAN_SEQ,
                           autotune=self.autotune, cache=cache)
        if not getattr(self.model, "has_pair", False):
            return None
        seeds = self.targets.k if isinstance(self.targets, TopK) else 1
        return plan_cnn(self.model.cfg, device=self.device,
                        precision=self.precision, batch=self.batch or 1,
                        seeds=seeds, autotune=self.autotune, cache=cache)
