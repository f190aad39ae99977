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
    logits, heat = eng.perturb(x, 7, method="rise")  # forward-only

A spec's ``device`` / ``plan`` / ``autotune`` resolve a
:class:`repro_torch.plan.TilePlan` once, at build (:attr:`Engine.plan`),
and every kernel of the model runs under it; a composite that folds an
axis into the batch re-audits the plan at the folded size first
(``_engine_for_fold``), before any launch.

Inputs may be NumPy arrays or tensors on any device; they move to the
model's device.  Outputs stay there.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple

import torch

from repro_torch.dist import sharding as dist_sharding
from repro_torch.engine import methods
from repro_torch.engine.backward import (ManualSeedBatchedBackward,
                                         VjpBackward, vjp)
from repro_torch.engine.spec import PERTURB_METHODS, EngineSpec, Fixed, TopK

#: Precisions whose only backward is the manual seed-batched pair
#: (integers have no gradient).
MANUAL_ONLY = ("fxp16",)


class Engine:
    """A built attribution engine — all knobs resolved.

    Construct via :func:`build` (direct construction skips the cache).
    """

    def __init__(self, spec: EngineSpec):
        self.spec = spec
        model = spec.model
        self.device = model.device
        # Tile planning happens here, before any launch: every kernel of
        # the model runs under the resolved plan.
        self._plan = spec.resolve_plan()
        self._mesh, self._n_shards = None, 1
        if hasattr(model, "token_step"):
            # LM token attribution: one step per score mode, the default
            # "ixg" now and the others at first use.  The step runs the
            # LM's own dtype; fxp16 needs a pair, which no LM has
            # (resolve_backward raises the JAX package's ValueError).
            spec.resolve_backward()
            self._token_steps = {"ixg": model.token_step(spec.method,
                                                         plan=self._plan)}
            self._model_fn = self._backend = None
            return
        self._token_steps = None
        self._fold_fn = None    # the perturbation fold's forward, at first use
        # folded-batch audit decisions (composites): folded M -> the engine
        # to dispatch through (self while the plan still fits)
        self._fold_engines = {}
        # A mesh:<profile>:<n> device builds a data-parallel engine: the
        # plan above is already per shard (the planner splits the batch
        # across the mesh before tiling); here every program is wrapped so
        # that each rank of the serving mesh runs its rows of the batch
        # and every rank gets the whole result (dist.sharding).  Without a
        # process group the mesh has one rank and the wrappers are the
        # identity: the same programs, the same bits.
        self._mesh, self._n_shards = _serving_mesh(spec, self._plan)
        # Perturbation specs are forward-only: the model is built under
        # saliency rules (spec.fwd_rules), which never run for them.
        rules = spec.fwd_rules()
        # logits only, for predict (under fxp16 the mask-free int16 forward)
        self._model_fn = self._shard_fn(model.logits_fn(
            rules, spec.precision, plan=self._plan))
        if spec.resolve_backward() == "seed_batched":
            if not model.has_pair:
                raise ValueError(f"model {model!r} exposes no seed-batched "
                                 f"pair; use backward='vjp'")
            fwd, bwd = model.pair(rules, spec.precision, plan=self._plan)
            self._backend = ManualSeedBatchedBackward(
                self._shard_fn(fwd), self._shard_pair_bwd(bwd))
        else:
            self._backend = VjpBackward(self._model_fn)

    # -- the data-parallel build ---------------------------------------------

    def _sharded(self) -> bool:
        return dist_sharding.batch_group(self._mesh)[0] is not None

    def _shard_fn(self, f):
        """``f(x) -> out`` on this rank's rows of ``x``, ``out`` gathered
        along the batch.  A logits function stays differentiable in ``x``
        (the composites' autograd and the vjp backend run through it); a
        pair forward's logits and residual tensors (mask and crumb bytes,
        int16 words) come back in one collective, so a replay on any rank,
        or on a single-device engine, reads the whole batch's residuals."""
        if not self._sharded():
            return f
        mesh = self._mesh

        def run(x):
            n = x.shape[0]
            out = f(dist_sharding.slice_rows(mesh, x))
            if isinstance(out, tuple):      # a pair forward: no gradient
                return dist_sharding.gather_tree_rows(mesh, out, n)
            return dist_sharding.join_rows(mesh, out, n)

        return run

    def _shard_pair_bwd(self, bwd):
        """The pair backward on this rank's rows of the residuals and of
        the seeds ``[S, B, C]``; the relevance gathered along B.  The
        seeds axis is not split (the serving mesh replicates it)."""
        if not self._sharded():
            return bwd
        mesh = self._mesh

        def run(residuals, seeds):
            n = seeds.shape[1]
            rel = bwd(dist_sharding.slice_tree_rows(mesh, residuals),
                      dist_sharding.slice_rows(mesh, seeds, dim=1))
            return dist_sharding.gather_rows(mesh, rel, n, dim=1)

        return run

    # -- resolved surfaces ---------------------------------------------------

    @property
    def mesh(self):
        """The serving mesh (:func:`repro_torch.launch.mesh.
        make_serving_mesh`) of a ``mesh:<profile>:<n>`` CNN engine; None
        otherwise, LM engines included (they build unsharded, as the JAX
        package's)."""
        return self._mesh

    @property
    def n_shards(self) -> int:
        """Mesh extent of the spec's device profile (1 = unsharded).  The
        serve batcher fills toward ``max_batch * n_shards`` seats."""
        return self._n_shards

    @property
    def plan(self):
        """The resolved :class:`repro_torch.plan.TilePlan` (None when the
        spec names no device or plan: every launch runs its rule)."""
        return self._plan

    @property
    def supports_replay(self) -> bool:
        return self._backend.supports_replay

    @property
    def model_fn(self):
        """Rule-bound ``f`` for direct method calls.

        f32 and bf16: ``f(x) -> logits``, differentiable (bf16 logits
        under bf16, an f32 input's gradient f32).  fxp16: the pair forward
        ``f(x) -> (logits, residuals)`` — combine with
        :attr:`composite_backward` (integers have no gradient).
        """
        if self.spec.precision in MANUAL_ONLY:
            return self._backend.forward
        return self._model_fn

    @property
    def composite_backward(self):
        """Manual BP for the methods' ``backward=`` knob under fxp16, or
        None on f32 and bf16, where autograd through :attr:`model_fn` is
        the engine (as in the JAX package)."""
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
        self._require_gradient_spec("explain")
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
        self._require_gradient_spec("predict_then_explain")
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
        """Integrated gradients (the steps axis folded into the batch; the
        folded launch re-audited against the plan first,
        :meth:`_engine_for_fold`)."""
        self._require_gradient_spec("ig")
        x = self._input(x)
        eng = self._engine_for_fold(steps if batched else 1, x)
        return methods.integrated_gradients(
            eng.model_fn, x, steps=steps, baseline=baseline,
            target=target, batched=batched,
            backward=eng.composite_backward)

    def smoothgrad(self, x, generator, *, n: int = 8, sigma: float = 0.1,
                   target=None, batched: bool = True):
        """SmoothGrad, its noise drawn from ``generator``, or from one
        generator per example (a sequence), the noise axis folded into the
        batch (re-audited against the plan first)."""
        self._require_gradient_spec("smoothgrad")
        x = self._input(x)
        eng = self._engine_for_fold(n if batched else 1, x)
        return methods.smoothgrad(
            eng.model_fn, x, generator, n=n, sigma=sigma,
            target=target, batched=batched,
            backward=eng.composite_backward)

    def input_x_gradient(self, x, *, target=None):
        """Gradient . input refinement."""
        self._require_gradient_spec("input_x_gradient")
        return methods.input_x_gradient(self.model_fn, self._input(x),
                                        target=target,
                                        backward=self.composite_backward)

    def contrastive(self, x, target_a, target_b):
        """Why A rather than B — one difference-seeded BP pass."""
        self._require_gradient_spec("contrastive")
        return methods.contrastive(self.model_fn, self._input(x), target_a,
                                   target_b,
                                   backward=self.composite_backward)

    def attribute_classes(self, x, targets):
        """K explicit classes from one forward (seed-batched when manual)."""
        self._require_gradient_spec("attribute_classes")
        if self.supports_replay:
            return methods.attribute_classes(self._backend.forward,
                                             self._input(x), targets,
                                             backward=self._backend.backward)
        return methods.attribute_classes(self._model_fn, self._input(x),
                                         targets)

    def perturb(self, x, key=None, *, method: Optional[str] = None,
                target=None, batched: bool = True,
                n_samples: Optional[int] = None, **opts):
        """Gradient-free perturbation explain: ``-> (logits, heat [B, H,
        W])``.

        Runs :mod:`repro_torch.perturb` over this engine's model: N masked
        variants folded into the leading batch axis and ONE forward pass
        (:meth:`_fold_forward`), no backward, so this is the explain path
        that runs under ``precision="fxp16"``.  ``batched=False`` runs one
        forward per mask through the predict forward instead.

        ``method`` defaults to ``spec.method`` (then one of ``occlusion |
        lime | rise``); ``n_samples`` to ``spec.n_samples``, then the
        method default.  ``key`` is required by the stochastic methods: an
        int seed or a ``torch.Generator`` (one mask set for the batch), or
        a sequence of them, one per example (the serve layer's per-request
        seeds).  Seeds draw on this engine's device; pad rows draw under
        the first key.  The folded launch is re-audited against the plan
        first (:meth:`_engine_for_fold`): replanned or rejected before any
        launch.
        """
        if self._token_steps is not None:
            raise ValueError("perturb() is not available on LM token "
                             "engines; use explain_tokens(batch)")
        from repro_torch import perturb as perturb_lib
        method = method if method is not None else self.spec.method
        if method not in PERTURB_METHODS:
            raise ValueError(f"method={method!r} not in {PERTURB_METHODS}; "
                             f"pass method= or build a perturbation spec")
        merged = dict(perturb_lib.PERTURB_DEFAULTS[method])
        if "n_samples" in merged:
            n_samples = (n_samples if n_samples is not None
                         else self.spec.n_samples)
            if n_samples is not None:
                merged["n_samples"] = int(n_samples)
        merged.update({k: v for k, v in opts.items() if v is not None})
        x, live = self._pad(self._input(x))
        target = self._pad_target(target, live)
        n = perturb_lib.n_masks(method, tuple(x.shape[1:3]), **merged)
        eng = self._engine_for_fold(n if batched else 1, x)
        fwd = eng._fold_forward() if batched else eng._model_fn
        fn = getattr(perturb_lib, method)
        if method == "occlusion":
            logits, heat = fn(fwd, x, target=target, batched=batched,
                              **merged)
        else:
            if key is None:
                raise ValueError(f"{method} is stochastic: pass a seed or a "
                                 f"generator (key=)")
            kb = perturb_lib.key_batch_size(key)
            if kb is not None and kb < x.shape[0]:
                key = perturb_lib.pad_keys(key, x.shape[0])
            logits, heat = fn(fwd, x, perturb_lib.generators(key,
                                                             self.device),
                              target=target, batched=batched, **merged)
        return self._unpad(logits, live), self._unpad(heat, live)

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
            step = self.spec.model.token_step(self.spec.method,
                                              plan=self._plan, mode=mode)
            self._token_steps[mode] = step
        return step(batch)

    # -- internals -----------------------------------------------------------

    def _fold_forward(self):
        """The forward a folded perturbation batch runs: the model's
        mask-free ``fold_fn`` (``cnn.apply_fold`` on the kernel path: the
        deconvnet blocks, which store nothing for a backward), or the
        predict forward for models without one (``FnModel``)."""
        if self._fold_fn is None:
            fold = getattr(self.spec.model, "fold_fn", None)
            self._fold_fn = (self._shard_fn(fold(self.spec.precision,
                                                 plan=self._plan))
                             if fold is not None else self._model_fn)
        return self._fold_fn

    def _engine_for_fold(self, factor: int, x) -> "Engine":
        """The engine a composite's FOLDED launch dispatches through.

        ``ig(steps=S)``, ``smoothgrad(n=S)`` and ``perturb`` (N masks) fold
        an axis into the batch, so the kernels run at ``M = S * B``, a
        shape the plan was not made for.  Memoized per folded M:

          * no plan, or folded M within the planned batch -> ``self``;
          * the plan's footprints still fit the profile at folded M (on the
            card always: an ``h100`` entry applies only at its planned
            shape, and every other launch runs its rule) -> ``self``;
          * the budget is violated -> replan at the folded batch and
            dispatch through a sibling engine built on that plan;
          * no tile fits at folded M -> the planner's
            :class:`~repro_torch.plan.InfeasiblePlanError`, before any
            launch.
        """
        if factor <= 1 or self._plan is None:
            return self
        folded = int(factor) * int(x.shape[0])
        if folded <= (self.spec.batch or 1):
            return self
        if folded not in self._fold_engines:
            self._fold_engines[folded] = self._audit_fold(folded)
        return self._fold_engines[folded]

    def _audit_fold(self, folded: int) -> "Engine":
        from dataclasses import replace

        from repro_torch.plan import (cnn_plan_footprints, get_profile,
                                      plan_cnn)
        spec = self.spec
        profile = get_profile(spec.device if spec.device is not None
                              else self._plan.device)
        # composites backprop ONE seed per folded row (seeds=1)
        fps = cnn_plan_footprints(spec.model.cfg, self._plan,
                                  precision=spec.precision, batch=folded,
                                  seeds=1, profile=profile)
        if all(fp.fits(profile) for fp in fps.values()):
            return self
        plan = plan_cnn(spec.model.cfg, device=profile,
                        precision=spec.precision, batch=folded, seeds=1)
        return build(replace(spec, plan=plan))

    def _require_gradient_spec(self, op: str):
        if self.spec.method in PERTURB_METHODS:
            raise ValueError(
                f"{op}() runs the gradient BP path; spec.method="
                f"{self.spec.method!r} is forward-only — use "
                f"Engine.perturb(x, key=...)")

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


def _serving_mesh(spec: EngineSpec, plan):
    """``(mesh, n_shards)`` of a CNN spec: a ``mesh:<profile>:<n>`` device
    (the spec's, else its plan's) gives ``make_serving_mesh(n)`` and n;
    any other ``(None, 1)``."""
    device = spec.device if spec.device is not None else (
        plan.device if plan is not None else None)
    if device is None:
        return None, 1
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.plan import MeshProfile, get_profile
    profile = get_profile(device)
    if not isinstance(profile, MeshProfile):
        return None, 1
    return make_serving_mesh(profile.n_shards), profile.n_shards


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
