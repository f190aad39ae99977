"""The dispatch loop: admission -> registry -> micro-batcher -> engine -> stats.

``ExplanationServer`` is the subsystem's front door.  Requests go in via
:meth:`submit`; :meth:`poll` pops every micro-batch that is full or past its
latency deadline and runs it:

  * **predict** batches run the adapter's residual-returning forward; each
    request's packed masks are parked in the LRU residual cache under its
    ``uid``.
  * **explain** batches split into cache **hits** — a pure-BP method with a
    cached predict for the same ``uid``: the forward pass is skipped and all
    hits in the bucket backpropagate together through ONE seed-batched fused
    launch over the stored masks — and **colds**: pure-BP methods re-run the
    same residual forward + fused BP programs (warming the cache), composite
    methods dispatch through the registry explainer (exactly the direct
    :mod:`repro_torch.core.attribution` call).  Top-K panel requests ride the same
    seed axis: K one-hot seeds per example, masks loaded once (§III.F).

Heavy-traffic hardening (see :mod:`repro_torch.serve.admission`):

  * an optional :class:`~repro_torch.serve.admission.AdmissionConfig` turns
    :meth:`submit` into an admission decision — bounded queue, per-method
    token buckets, and deadline-aware shedding (a typed
    :class:`~repro_torch.serve.api.ShedError` instead of an unbounded backlog);
  * :meth:`poll` first sweeps out requests whose deadline can no longer be
    met (they complete as structured shed responses, never occupying a
    padded seat), then dispatches batches in EDF order;
  * dispatch is fault-isolated: a poisoned micro-batch (bad shape, adapter
    exception) completes as error responses — the worker loop survives and
    sibling buckets are unaffected; batches that overrun
    ``dispatch_timeout_s`` are flagged and counted (soft timeout: a kernel
    launch cannot be preempted in-thread, so the flag is the observable);
  * under degradation pressure, rerouted (``fxp16``) traffic runs cold on a
    lazily-built sibling adapter — its residuals never enter the primary
    cache (an int16 forward's masks must not replay under float engines).

Everything is synchronous and deterministic (injectable clock); an async
transport would wrap ``submit``/``poll`` without touching the dataflow.

On the device: every batch is stacked on the host and moved to the
engine's device in one copy; every dispatch ends in one
``torch.cuda.synchronize`` (``adapters.block_until_ready``) before the
clock is read, so dispatch durations, the admission estimator and timed
replays see service time, not launch time; each batch's logits come to the
host once (``float32``), where argmax and top-K targets resolve with the
reference's own NumPy calls, and the one-hot seeds go back in one copy.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import clock as clock_lib
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, RequestTrace, Tracer
from repro_torch.serve import registry
from repro_torch.serve.admission import AdmissionConfig, AdmissionController
from repro_torch.serve.api import (EXPLAIN, PREDICT, SHED_EXPIRED,
                             InvalidRequestError, Request, Response,
                             ShedError, shed_response)
from repro_torch.serve.batcher import Batch, MicroBatcher, host_array, pad_size
from repro_torch.serve.residual_cache import CacheEntry, ResidualCache
from repro_torch.serve.stats import ServerStats
from repro_torch.serve.adapters import (block_until_ready, concat_examples,
                                        slice_example)


class ExplanationServer:
    def __init__(self, adapter, *, cache_capacity: int = 256,
                 max_batch: int = 8, max_delay_s: float = 0.002,
                 clock: Callable[[], float] = clock_lib.monotonic,
                 method_opts: Optional[Dict[str, dict]] = None,
                 admission: Optional[AdmissionConfig] = None,
                 dispatch_timeout_s: Optional[float] = None,
                 tracer: Optional[Tracer] = None):
        self.adapter = adapter
        self.clock = clock
        # tracer=None is the zero-cost path: NULL_TRACER's start() returns
        # the shared no-op span and requests never carry a RequestTrace.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if self.tracer.enabled:
            self.tracer.clock = clock      # spans and deadlines share "now"
        self._trace_seq = itertools.count()
        # Mesh-sharded adapters (engine built for a mesh:<profile>:<n>
        # device) expose n_shards; the batcher then fills buckets toward
        # max_batch * n_shards seats so every launch occupies the mesh.
        # The server drives its engine from one rank: on a mesh of several
        # ranks the others would need a follower joining every launch.
        mesh = getattr(getattr(adapter, "engine", None), "mesh", None)
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                f"serving on {mesh!r}: ranks > 0 need a follower that joins "
                f"each launch (ROADMAP A12d)")
        self.batcher = MicroBatcher(max_batch=max_batch,
                                    max_delay_s=max_delay_s, clock=clock,
                                    n_shards=getattr(adapter, "n_shards", 1))
        self.cache = ResidualCache(cache_capacity)
        self.stats = ServerStats()
        self.method_opts = method_opts or {}
        self.dispatch_timeout_s = dispatch_timeout_s
        self.admission = (AdmissionController(admission, now=clock())
                          if admission is not None else None)
        if (admission is not None and admission.degrade is not None
                and admission.degrade.reroute_precision is not None
                and not hasattr(adapter, "with_precision")):
            raise ValueError(
                f"degrade.reroute_precision needs an adapter exposing "
                f"with_precision(); {type(adapter).__name__} does not")
        self._degraded_adapter = None
        self._explainers: Dict[tuple, registry.Explainer] = {}

    # -- public surface -----------------------------------------------------

    def methods(self) -> List[str]:
        """Servable methods — derived from the registry, never hard-coded."""
        return registry.names()

    def submit(self, req: Request) -> None:
        """Admit ``req`` into the queue, or refuse it with a typed error.

        Raises :class:`~repro_torch.serve.api.InvalidRequestError` for poisoned
        payloads (non-finite values, wrong example shape when the adapter
        declares one), ``KeyError`` for unknown methods, and — when
        admission control is configured —
        :class:`~repro_torch.serve.api.ShedError` when the request is refused
        (queue full, rate limited, or its deadline is infeasible given the
        current queue estimate).  Admitted requests always return
        immediately; nothing ever blocks here.
        """
        self._validate(req)
        now = self.clock()
        if self.tracer.enabled:
            # trace id minted at admission; uids repeat (predict + explain
            # share one), so a per-server sequence disambiguates
            tid = f"{req.uid}#{next(self._trace_seq)}"
            req.trace = RequestTrace(self.tracer.start(
                f"request/{req.kind}", cat="request", trace_id=tid,
                t0=now if req.arrive_t is None else req.arrive_t,
                args={"uid": req.uid,
                      "method": req.method if req.kind == EXPLAIN else ""}))
        try:
            if self.admission is not None:
                adm = (req.trace.root.child("admission", cat="admission",
                                            t0=now)
                       if req.trace is not None else NULL_SPAN)
                try:
                    action = self.admission.admit(req,
                                                  self.batcher.pending(),
                                                  now)
                except ShedError as e:
                    adm.end(t=now, result=e.reason)
                    self.stats.record_shed(e.reason)
                    raise
                adm.end(t=now, result=action or "admitted")
                if action is not None:
                    self.stats.record_degrade(action)
            elif req.deadline_s is not None and req.deadline_t is None:
                # deadlines work without admission too; anchor at arrival
                # (is-None, not falsy: replay arrivals at t=0.0 are real)
                req.deadline_t = ((now if req.arrive_t is None
                                   else req.arrive_t) + req.deadline_s)
            if req.kind == EXPLAIN and req.topk is not None:
                cls = registry.get(req.method)
                if not (cls.mask_reuse and self._rules_compatible(
                        self.adapter.store_rules, req.method)):
                    raise ValueError(
                        f"topk panels ride the seed-batched BP and need a "
                        f"mask-reuse method {registry.mask_reuse_methods()} "
                        f"whose masks the adapter stores (store_rules="
                        f"{self.adapter.store_rules!r}); got {req.method!r}")
            self.batcher.submit(req)
        except ShedError as e:
            if req.trace is not None:   # refused requests still terminate
                req.trace.root.end(t=now, status="shed", reason=e.reason)
            raise
        except Exception as e:
            if req.trace is not None:
                req.trace.root.end(t=now, status="error",
                                   error_type=type(e).__name__)
            raise
        if req.trace is not None:
            req.trace.queued = req.trace.root.child("queued", cat="queue",
                                                    t0=now)
        self.stats.record_queue_depth(self.batcher.pending())

    def poll(self, now: Optional[float] = None) -> List[Response]:
        """Run every due micro-batch; returns completed responses
        (including structured shed responses for requests whose deadline
        expired while queued)."""
        now = self.clock() if now is None else now
        est = self._service_estimate()
        out = [self._finish_shed(r)
               for r in self.batcher.expire(now, est)]
        for batch in self.batcher.ready(now, est):
            out.extend(self._dispatch(batch))
        return out

    def drain(self) -> List[Response]:
        """Flush the queue regardless of deadlines (shutdown / tests)."""
        return list(itertools.chain.from_iterable(
            self._dispatch(b) for b in self.batcher.flush()))

    def serve(self, requests: List[Request]) -> Dict[str, Response]:
        """Convenience: submit all, poll to completion, index by uid.

        Shed-at-submit requests surface as structured responses here (the
        batch caller has no per-request try/except)."""
        out: Dict[str, Response] = {}
        for req in requests:
            try:
                self.submit(req)
            except ShedError as e:
                out[req.uid] = shed_response(req, e.reason, e.detail)
                continue
            for resp in self.poll():
                out[resp.uid] = resp
        for resp in self.drain():
            out[resp.uid] = resp
        return out

    # -- validation / admission helpers -------------------------------------

    def _validate(self, req: Request) -> None:
        if req.kind == EXPLAIN:
            cls = registry.get(req.method)    # fail fast on unknown methods
            if cls.needs_key and req.key is None:
                raise InvalidRequestError(
                    f"request {req.uid!r}: method {req.method!r} is "
                    f"stochastic and needs a per-request seed (key=)")
        expected = getattr(self.adapter, "example_shape", None)
        if expected is not None and tuple(np.shape(req.x)) != tuple(expected):
            raise InvalidRequestError(
                f"request {req.uid!r}: example shape {np.shape(req.x)} != "
                f"adapter's {tuple(expected)}")
        if self.admission is not None and self.admission.config.reject_nonfinite:
            x = host_array(req.x)
            if np.issubdtype(x.dtype, np.floating) and not np.isfinite(x).all():
                raise InvalidRequestError(
                    f"request {req.uid!r}: non-finite values in payload")

    def _service_estimate(self) -> float:
        if self.admission is None:
            return 0.0
        est = self.admission.estimator
        snap = est.snapshot()
        return max(snap.values()) if snap else 0.0

    def _finish_shed(self, req: Request) -> Response:
        self.stats.record_shed(SHED_EXPIRED)
        resp = shed_response(req, SHED_EXPIRED, "deadline expired in queue")
        resp.latency_s = self.clock() - req.arrive_t
        if req.trace is not None:       # expired-in-queue still terminates
            t = req.arrive_t + resp.latency_s
            req.trace.queued.end(t=t, result=SHED_EXPIRED)
            req.trace.root.end(t=t, status="shed", reason=SHED_EXPIRED)
        return resp

    # -- adapters / explainer construction -----------------------------------

    def _adapter_for(self, degraded: bool):
        if not degraded:
            return self.adapter
        if self._degraded_adapter is None:
            precision = self.admission.config.degrade.reroute_precision
            self._degraded_adapter = self.adapter.with_precision(precision)
        return self._degraded_adapter

    def explainer(self, method: str,
                  degraded: bool = False) -> registry.Explainer:
        key = (method, degraded)
        if key not in self._explainers:
            adapter = self._adapter_for(degraded)
            cls = registry.get(method)
            eng_for = getattr(adapter, "engine_for", None)
            if eng_for is not None:
                # Engine-backed adapters: the explainer rides the built
                # engine for its rule set — precision/backend (incl. the
                # fxp16 manual pair) resolved by the spec, in one place.
                self._explainers[key] = cls.from_engine(
                    eng_for(cls.rules), **self.method_opts.get(method, {}))
            else:
                # Raw-closure adapters (the replay harness's): quantized
                # ones expose a manual BP engine (integers have no
                # gradient); float adapters return None and autograd is
                # used.  Inputs move to the adapter's device.
                manual = getattr(adapter, "manual_backward", None)
                self._explainers[key] = cls(
                    adapter.model_fn(cls.rules),
                    backward=manual(cls.rules) if manual else None,
                    device=getattr(adapter, "device", None),
                    **self.method_opts.get(method, {}))
        return self._explainers[key]

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, batch: Batch) -> List[Response]:
        """Fault-isolated batch execution: an exception inside a batch
        becomes per-request error responses, never a dead worker loop."""
        t0 = self.clock()
        bspan = NULL_SPAN
        if self.tracer.enabled:
            # the batch is its own track; request spans point at it by id
            bid = f"batch#{next(self._trace_seq)}"
            bspan = self.tracer.start(
                f"batch/{batch.kind}", cat="batch", trace_id=bid, t0=t0,
                args={"n": len(batch.requests), "degraded": batch.degraded,
                      "method": (batch.requests[0].method
                                 if batch.kind == EXPLAIN else "")})
            for req in batch.requests:
                if req.trace is not None:
                    req.trace.queued.end(t=t0)
                    req.trace.engine = req.trace.root.child(
                        "engine", cat="engine", t0=t0, args={"batch": bid})
        try:
            out = self._process(batch)
        except Exception as e:                          # noqa: BLE001
            out = [self._finish_error(req, e) for req in batch.requests]
        duration = self.clock() - t0
        bspan.end(t=t0 + duration)
        if (self.dispatch_timeout_s is not None
                and duration > self.dispatch_timeout_s):
            self.stats.record_timeout()
            for resp in out:
                resp.meta["dispatch_timeout_s"] = duration
        if self.admission is not None and batch.requests:
            req0 = batch.requests[0]
            self.admission.estimator.observe(
                req0.kind, req0.method if req0.kind == EXPLAIN else "",
                duration, len(batch.requests))
        return out

    def _process(self, batch: Batch) -> List[Response]:
        if batch.kind == PREDICT:
            return self._run_predict(batch)
        return self._run_explain(batch)

    def _finish(self, req: Request, resp: Response) -> Response:
        resp.latency_s = self.clock() - req.arrive_t
        if req.degrade_action is not None:
            resp.meta["degraded"] = req.degrade_action
        self.stats.record(req.kind,
                          req.method if req.kind == EXPLAIN else "",
                          resp.latency_s, resp.cache_hit)
        if req.trace is not None:
            t = req.arrive_t + resp.latency_s
            req.trace.engine.end(t=t)
            req.trace.root.end(t=t, status="ok", cache_hit=resp.cache_hit,
                               latency_s=resp.latency_s)
        return resp

    def _finish_error(self, req: Request, exc: Exception) -> Response:
        """Structured failure for one request of a poisoned batch."""
        self.stats.record_error()
        resp = Response(uid=req.uid, kind=req.kind,
                        method=req.method if req.kind == EXPLAIN else None,
                        error=str(exc), error_type=type(exc).__name__)
        resp.latency_s = self.clock() - req.arrive_t
        if req.trace is not None:       # faulted requests still terminate
            t = req.arrive_t + resp.latency_s
            req.trace.engine.end(t=t)
            req.trace.root.end(t=t, status="error",
                               error_type=type(exc).__name__)
        return resp

    def _run_predict(self, batch: Batch) -> List[Response]:
        xb, live = batch.stack(self.batcher.fill_target)
        logits, residuals = self.adapter.predict(xb)
        block_until_ready(logits)
        host = _host_logits(logits)
        self.stats.record_batch(live, xb.shape[0])
        now = self.clock()
        out = []
        for i, req in enumerate(batch.requests):
            self.cache.put(req.uid, CacheEntry(
                logits=logits[i], residuals=slice_example(residuals, i),
                rules=self.adapter.store_rules, host_logits=host[i]))
            if req.trace is not None:
                req.trace.root.child("cache", cat="cache", t0=now).end(
                    t=now, result="store")
            out.append(self._finish(req, Response(
                uid=req.uid, kind=PREDICT, logits=logits[i],
                batch_size=xb.shape[0])))
        return out

    @staticmethod
    def _rules_compatible(stored_rules: str, method: str) -> bool:
        """Can masks stored under ``stored_rules`` replay ``method``'s BP?

        deconvnet-rules forwards store NO ReLU masks (Table II: the rule
        reads only the gradient sign), so those entries can replay nothing
        but deconvnet; saliency/guided-stored masks serve every BP method.
        """
        return method == "deconvnet" or stored_rules != "deconvnet"

    def _run_explain(self, batch: Batch) -> List[Response]:
        method = batch.requests[0].method
        if batch.degraded:
            # Rerouted traffic runs cold on the sibling engine; the primary
            # cache's float residuals cannot replay an int16 backward (and
            # vice versa), so the hit/warm paths are skipped entirely.
            now = self.clock()
            for req in batch.requests:
                if req.trace is not None:
                    req.trace.root.child("cache", cat="cache", t0=now).end(
                        t=now, result="bypass")
            return self._explain_cold(method, batch.requests, degraded=True)
        hits, colds = [], []
        reusable = registry.get(method).mask_reuse
        now = self.clock()
        for req in batch.requests:
            entry = None
            if reusable:
                cand = self.cache.peek(req.uid)
                if cand is not None and self._rules_compatible(cand.rules,
                                                               method):
                    entry = self.cache.get(req.uid)   # accounts the hit
                else:
                    self.cache.count_miss()           # absent or unusable
            if req.trace is not None:
                req.trace.root.child("cache", cat="cache", t0=now).end(
                    t=now, result="hit" if entry is not None else "miss")
            if entry is not None:
                hits.append((req, entry))
            else:
                colds.append(req)
        out = []
        if hits:
            out.extend(self._explain_hits(method, hits))
        if colds:
            out.extend(self._explain_cold(method, colds))
        return out

    def _targets_for(self, req: Request, lg: np.ndarray) -> np.ndarray:
        """Resolve the class panel to explain: topk > explicit > argmax,
        from the float32 HOST logits (the reference's own NumPy calls: its
        ``argsort`` is not stable, so ties resolve as the reference's
        do on the same array — not as ``torch.topk`` would)."""
        if req.topk is not None:
            return np.argsort(-lg)[:req.topk]
        if req.target is not None:
            return np.asarray([req.target])
        return np.asarray([int(np.argmax(lg))])

    def _explain_hits(self, method: str, hits) -> List[Response]:
        """Forward-free path: seed-batched fused BP over cached masks."""
        reqs = [r for r, _ in hits]
        entries = [e for _, e in hits]
        targets = [self._targets_for(r, e.host_logits)
                   for r, e in zip(reqs, entries)]
        # pow2-pad the hit group too (rows repeat entry 0, sliced off below)
        # so the BP kernels see a handful of batch shapes only.
        psize = pad_size(len(reqs), self.batcher.fill_target)
        ent_pad = entries + [entries[0]] * (psize - len(reqs))
        tgt_pad = targets + [targets[0]] * (psize - len(reqs))
        residuals = concat_examples([e.residuals for e in ent_pad])
        num_classes = entries[0].logits.shape[-1]
        # [S, B, C]; S is bucket-homogeneous (topk is part of the bucket key)
        seeds = _one_hot(np.stack(tgt_pad, axis=1), num_classes)
        rel = self.adapter.explain_cached(method, residuals, seeds)
        block_until_ready(rel)
        self.stats.record_batch(len(reqs), psize)
        out = []
        for i, (req, entry) in enumerate(zip(reqs, entries)):
            rel_i = rel[:, i] if req.topk is not None else rel[0, i]
            out.append(self._finish(req, Response(
                uid=req.uid, kind=EXPLAIN, logits=entry.logits,
                relevance=rel_i, targets=tuple(int(t) for t in targets[i]),
                method=method, cache_hit=True, batch_size=psize)))
        return out

    def _explain_cold(self, method: str, reqs: List[Request],
                      degraded: bool = False) -> List[Response]:
        """Explain with no cached residuals — full FP+BP.

        Mask-reuse methods run the SAME two kernel programs as the hit path
        (residual forward, then seed-batched fused BP), so a hit is bitwise
        identical to its cold counterpart by construction — skipping the
        forward never changes the answer — and the forward's masks warm the
        cache for follow-ups.  Composite methods (IG, smoothgrad, ...)
        dispatch through the registry explainer, i.e. exactly the direct
        :mod:`repro_torch.core.attribution` call.  Degraded (rerouted) batches
        run on the sibling adapter and never touch the primary cache.
        """
        adapter = self._adapter_for(degraded)
        if (registry.get(method).mask_reuse
                and self._rules_compatible(adapter.store_rules, method)):
            return self._explain_cold_bp(method, reqs, degraded=degraded)
        xb, live = Batch(("explain",), reqs).stack(self.batcher.fill_target)
        explainer = self.explainer(method, degraded)
        if reqs[0].target is None:             # bucket-homogeneous target kind
            target = None
        else:
            # padding rows explain class 0 and are sliced off below
            target = torch.as_tensor([r.target for r in reqs]
                                     + [0] * (xb.shape[0] - live))
        key = None
        if explainer.needs_key:
            if registry.get(method).fold_keys:
                # Fold PER-REQUEST seeds along the batch axis: every request
                # draws from its own generator, so co-batched stochastic
                # results are identical to singleton serving.  Padding rows
                # redraw under the first seed and are sliced off with the
                # batch.
                key = ([r.key for r in reqs]
                       + [reqs[0].key] * (xb.shape[0] - live))
            else:
                # non-foldable stochastic methods ride singleton buckets
                # (batcher token), so reqs is exactly one request here
                key = reqs[0].key
        logits, rel = explainer.attribute(xb, target=target, key=key)
        block_until_ready(rel)
        host = _host_logits(logits)
        self.stats.record_batch(live, xb.shape[0])
        out = []
        for i, req in enumerate(reqs):
            tgt = (req.target if req.target is not None
                   else int(np.argmax(host[i])))
            out.append(self._finish(req, Response(
                uid=req.uid, kind=EXPLAIN, logits=logits[i],
                relevance=rel[i], targets=(int(tgt),), method=method,
                batch_size=xb.shape[0])))
        return out

    def _explain_cold_bp(self, method: str, reqs: List[Request],
                         degraded: bool = False) -> List[Response]:
        """Cold pure-BP explain: residual forward + seed-batched fused BP,
        warming the residual cache with the forward's packed masks (primary
        adapter only — degraded residuals are engine-incompatible)."""
        adapter = self._adapter_for(degraded)
        xb, live = Batch(("explain",), reqs).stack(self.batcher.fill_target)
        logits, residuals = adapter.predict(xb)
        host = _host_logits(logits)
        targets = [self._targets_for(r, host[i])
                   for i, r in enumerate(reqs)]
        pad = xb.shape[0] - live
        tmat = np.concatenate([np.stack(targets, axis=1),
                               np.zeros((targets[0].shape[0], pad), int)],
                              axis=1)
        seeds = _one_hot(tmat, logits.shape[-1])
        rel = adapter.explain_cached(method, residuals, seeds)
        block_until_ready(rel)
        self.stats.record_batch(live, xb.shape[0])
        out = []
        for i, req in enumerate(reqs):
            if not degraded:
                self.cache.put(req.uid, CacheEntry(
                    logits=logits[i], residuals=slice_example(residuals, i),
                    rules=adapter.store_rules, host_logits=host[i]))
            out.append(self._finish(req, Response(
                uid=req.uid, kind=EXPLAIN, logits=logits[i],
                relevance=rel[:, i] if req.topk is not None else rel[0, i],
                targets=tuple(int(t) for t in targets[i]), method=method,
                batch_size=xb.shape[0])))
        return out


def _host_logits(logits) -> np.ndarray:
    """A batch's logits as one float32 host array (one device-to-host copy;
    bf16 widens exactly first, as NumPy has no bf16)."""
    if isinstance(logits, torch.Tensor):
        return logits.detach().float().cpu().numpy()
    return np.asarray(logits, np.float32)


def _one_hot(idx: np.ndarray, num_classes: int) -> torch.Tensor:
    """Host one-hot seeds ``[..., num_classes]`` (float32); the engine
    moves them to its device in one copy."""
    seeds = np.zeros(idx.shape + (num_classes,), np.float32)
    np.put_along_axis(seeds, idx[..., None].astype(np.int64), 1.0, axis=-1)
    return torch.from_numpy(seeds)
