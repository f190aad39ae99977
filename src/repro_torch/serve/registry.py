"""Explainer registry — every attribution method behind ONE interface, as
``repro.serve.registry`` has it: the same names, the same class flags, the
same dispatch.

inseq-style: methods self-register under a string name via
``@register("...")`` and the server and the driver derive their method
lists from :func:`names` instead of hard-coding choices.

An :class:`Explainer` wraps a model callable ``f(x) -> logits`` that
already has the explainer's *rule set* bound (``cls.rules``; composite
methods like IG run on saliency rules).  ``attribute(x, target=...)``
dispatches to the matching :mod:`repro_torch.core.attribution` entry
point, so registry results are the direct calls' results.

Class attributes drive server capabilities:

  * ``mask_reuse`` — the method is a pure BP pass, so an explain request can
    be served from cached forward residuals without re-running the forward
    (paper §III.F; see :mod:`repro_torch.serve.residual_cache`).
  * ``token_capable`` — meaningful under the LM token-attribution seeding.
  * ``needs_key`` — stochastic; ``attribute`` requires a seed (``key``).
  * ``fold_keys`` — the method accepts one seed PER EXAMPLE, so stochastic
    requests co-batch (each row draws from a ``torch.Generator`` seeded
    with its own request's seed) instead of taking the singleton-bucket
    path; each request's draw depends only on its own seed.

The perturbation methods (``occlusion``, ``lime``, ``rise``,
:mod:`repro_torch.perturb`) are forward-only: ``mask_reuse = False``, so
the residual cache never serves them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

import torch

from repro_torch.core import attribution
from repro_torch.perturb.keys import generators

_REGISTRY: Dict[str, Type["Explainer"]] = {}


def register(name: str) -> Callable[[type], type]:
    """Class decorator: expose an :class:`Explainer` under ``name``."""
    def deco(cls: type) -> type:
        if name in _REGISTRY:
            raise ValueError(f"explainer {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get(name: str) -> Type["Explainer"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown explainer {name!r}; registered: {names()}") from None


def names() -> List[str]:
    return sorted(_REGISTRY)


def token_methods() -> List[str]:
    return [n for n in names() if _REGISTRY[n].token_capable]


def mask_reuse_methods() -> List[str]:
    return [n for n in names() if _REGISTRY[n].mask_reuse]


def make(name: str, f: Callable, **opts) -> "Explainer":
    return get(name)(f, **opts)


def explainer_for(adapter, name: str, opts: dict,
                  form: Optional[str] = None) -> "Explainer":
    """The server's explainer for ``name`` on ``adapter``: on the engine of
    its rule set (``form="engine"``, the default where the adapter exposes
    ``engine_for``: precision and backend, the fxp16 pair included,
    resolved by the spec in one place), or on the adapter's rule-bound
    ``model_fn`` and ``manual_backward`` closures (``"closure"``: the
    replay harness's adapters, whose closures time the composites;
    quantized ones expose a manual BP engine, float ones None, and
    autograd is used).  Inputs move to the adapter's device."""
    cls = get(name)
    if form is None:
        form = "engine" if hasattr(adapter, "engine_for") else "closure"
    if form == "engine":
        return cls.from_engine(adapter.engine_for(cls.rules), **opts)
    manual = getattr(adapter, "manual_backward", None)
    return cls(adapter.model_fn(cls.rules),
               backward=manual(cls.rules) if manual else None,
               device=getattr(adapter, "device", None), **opts)


class Explainer:
    """Base: one attribution method over a rule-bound model callable."""

    name: str = "?"
    rules: str = "saliency"
    mask_reuse: bool = False
    token_capable: bool = False
    needs_key: bool = False
    fold_keys: bool = False

    def __init__(self, f: Callable, backward: Optional[Callable] = None,
                 *, engine=None, device=None, **opts):
        self.f = f
        # Manual BP engine (attribution's ``backward=``): set when ``f``
        # returns (logits, residuals) and the BP phase runs over the stored
        # masks — the fxp16 pair arrives here, since integer arithmetic
        # has no gradient (bf16 runs autograd, as f32 does).
        self.backward = backward
        # The repro_torch.engine.Engine this explainer rides, when
        # constructed via :meth:`from_engine` (the server path).
        self.engine = engine
        # Where ``f`` computes: inputs move there (the engine's device, or
        # an adapter's for raw callables; None leaves them where they are).
        self.device = engine.device if engine is not None else device
        self.opts = opts

    @classmethod
    def from_engine(cls, eng, **opts) -> "Explainer":
        """Bind the method to a built :class:`repro_torch.engine.Engine`:
        the engine's rule-bound ``model_fn`` is ``f`` and its
        ``composite_backward`` (the manual pair under fxp16, None on f32
        and bf16) is the ``backward=`` knob — so precision routing is decided
        by the engine spec, never by the caller."""
        return cls(eng.model_fn, backward=eng.composite_backward,
                   engine=eng, **opts)

    def _input(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32)
        return x if self.device is None else x.to(self.device)

    def attribute(self, x, *, target=None, key=None):
        """-> (logits, relevance) — same contract as the core engine."""
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r} opts={self.opts}>"


class _PureBP(Explainer):
    """Shared body of the paper's three methods: one FP + one masked BP."""

    mask_reuse = True
    token_capable = True

    def attribute(self, x, *, target=None, key=None):
        return attribution.attribute(self.f, self._input(x), target=target,
                                     backward=self.backward)


@register("saliency")
class Saliency(_PureBP):
    rules = "saliency"


@register("deconvnet")
class Deconvnet(_PureBP):
    rules = "deconvnet"


@register("guided")
class GuidedBackprop(_PureBP):
    rules = "guided"


@register("input_x_gradient")
class InputXGradient(Explainer):
    rules = "saliency"

    def attribute(self, x, *, target=None, key=None):
        return attribution.input_x_gradient(self.f, self._input(x),
                                            target=target,
                                            backward=self.backward)


@register("integrated_gradients")
class IntegratedGradients(Explainer):
    """opts: ``steps`` (default 16), ``baseline``, ``batched``."""

    rules = "saliency"

    def attribute(self, x, *, target=None, key=None):
        return attribution.integrated_gradients(
            self.f, self._input(x), target=target,
            steps=self.opts.get("steps", 16),
            baseline=self.opts.get("baseline"),
            batched=self.opts.get("batched", True),
            backward=self.backward)


@register("smoothgrad")
class SmoothGrad(Explainer):
    """opts: ``n`` (default 8), ``sigma``, ``batched``.  ``key``: one int
    seed, or one per example (``fold_keys``)."""

    rules = "saliency"
    needs_key = True
    fold_keys = True            # per-example noise from per-example seeds

    def attribute(self, x, *, target=None, key=None):
        if key is None:
            raise ValueError("smoothgrad needs a seed (key=)")
        x = self._input(x)
        return attribution.smoothgrad(
            self.f, x, generators(key, x.device), target=target,
            n=self.opts.get("n", 8),
            sigma=self.opts.get("sigma", 0.1),
            batched=self.opts.get("batched", True),
            backward=self.backward)


class _TokenEngine(Explainer):
    """Token-level LM explainers (:mod:`repro_torch.lm`): sequences in,
    per-token scores out.

    Engine-bound only: ``attribute`` dispatches through
    ``Engine.explain_tokens`` (FP + input-gradient BP, the SSM segments on
    the B13 kernel) — there is no raw-callable form, because the token
    seeding lives inside the step.

    ``mask_reuse = False`` by construction: the token stack exposes no
    replayable residual pair, so a cache hit must never serve these.  The
    explained target is always the model's own next-token prediction
    (argmax — and for the contrastive mode, argmax vs runner-up); explicit
    per-request targets are rejected rather than silently ignored.
    """

    rules = "saliency"
    mask_reuse = False
    token_capable = True
    mode = "ixg"

    def attribute(self, x, *, target=None, key=None):
        if self.engine is None:
            raise ValueError(
                f"{self.name} rides an LM engine; construct via "
                f"from_engine (the repro_torch.lm.LMAdapter server path)")
        if target is not None:
            raise ValueError(
                f"{self.name} explains the model's own next-token "
                f"prediction; explicit targets are not supported")
        return self.engine.explain_tokens({"tokens": x}, mode=self.mode)


@register("token_saliency")
class TokenSaliency(_TokenEngine):
    """L2 norm of the embedding gradient per position (pure saliency)."""

    mode = "grad_norm"


@register("token_ixg")
class TokenIxG(_TokenEngine):
    """Input x gradient per position (signed; the default LM heatmap)."""

    mode = "ixg"


@register("token_contrastive")
class TokenContrastive(_TokenEngine):
    """Why the predicted token rather than the runner-up — one
    difference-seeded BP (``e_argmax - e_runner_up``)."""

    mode = "contrastive"


class _Perturb(Explainer):
    """Gradient-free perturbation methods (:mod:`repro_torch.perturb`).

    Forward-only: ``mask_reuse = False`` by construction — there is no BP
    phase, so the server's hit path never serves these.  Engine-bound
    explainers dispatch through ``Engine.perturb`` (its mask-free fold
    forward on the kernels); raw-callable explainers run the free
    functions.  ``key``: one int seed, or one per example (``fold_keys``).
    """

    mask_reuse = False

    def attribute(self, x, *, target=None, key=None):
        from repro_torch import perturb
        if self.needs_key and key is None:
            raise ValueError(f"{self.name} is stochastic: pass a seed "
                             f"(key=)")
        if self.engine is not None:
            return self.engine.perturb(x, key, method=self.name,
                                       target=target, **self.opts)
        x = self._input(x)
        fn = getattr(perturb, self.name)
        if self.needs_key:
            return fn(self.f, x, generators(key, x.device), target=target,
                      **self.opts)
        return fn(self.f, x, target=target, **self.opts)


@register("occlusion")
class Occlusion(_Perturb):
    """opts: ``window`` (default 4), ``stride``, ``baseline``, ``batched``."""


@register("lime")
class Lime(_Perturb):
    """opts: ``n_samples`` (default 256), ``cells``, ``sigma``, ``ridge``,
    ``baseline``, ``batched``."""

    needs_key = True
    fold_keys = True            # per-example Bernoulli masks, own seeds


@register("rise")
class Rise(_Perturb):
    """opts: ``n_samples`` (default 256), ``grid``, ``p``, ``baseline``,
    ``batched``."""

    needs_key = True
    fold_keys = True            # per-example mask lattices, own seeds
