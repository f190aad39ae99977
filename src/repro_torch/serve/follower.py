"""Multi-rank serving: the leader's call stream and the followers that
join it.

A ``mesh:<profile>:<n>`` CNN engine over n > 1 ranks is collective: every
rank must call each of its programs with the whole batch, in the same
order (:meth:`repro_torch.engine.Engine._shard_fn`), and each rank
computes its rows and gathers the rest.  The
:class:`~repro_torch.serve.server.ExplanationServer` runs on rank 0, the
*leader*: admission, batcher, residual cache, stats and tracer live there
alone.  Every other rank runs a *follower* that joins each launch the
leader's adapter makes, with the same inputs in the same order, and
returns when the leader closes the stream::

    adapter = CNNAdapter(params, cfg, device="mesh:h100:2")   # every rank
    if dist.get_rank() == 0:
        with lead(adapter) as adp:
            server = ExplanationServer(adp, max_batch=32)
            ...                            # submit / poll / drain
    else:
        follow(adapter)

:func:`lead` wraps the adapter in a :class:`StreamAdapter`, which
announces each call that reaches the mesh before making it:

  * ``predict`` (the batch), ``explain_cached`` (the seeds, and the
    residual tree of a hit batch), ``attribute`` (a registry explainer's
    call: the batch, targets, per-request seeds, the method's options),
    ``with_precision`` (the lazily built fxp16 sibling) and
    ``engine_for`` (a rule set's engine);
  * an announcement is one object broadcast (a header of at most
    :data:`HEADER_BYTES`: op, adapter, method, targets, seeds, the
    tensors' dtypes and shapes) over a gloo group of the host, and one
    broadcast of every tensor of the call packed as bytes in one buffer
    on the adapter's device;
  * a cold pure-BP explain replays the residuals of the ``predict`` it
    just ran, which every rank holds whole (the sharded forward gathers
    them), so only the seeds travel; a hit batch's residuals, concatenated
    from the leader's cache, travel as bytes (counted in
    :attr:`CallStream.stats`);
  * stochastic methods send their per-request int seeds, never the draws:
    every rank draws the same noise and masks for the whole batch from
    them before the sharded model function takes its rows.

Faults.  Each call is a launch in two agreements, a one-word minimum
all-reduced over the gloo group: after the announcement every rank says
whether it could prepare the call (decode it, resolve its adapter and
explainer), and nobody launches unless all could; after the call (its
device work waited for) every rank says whether it ran.  Engine builds
(``with_precision``, ``engine_for``) run inside a launch on every rank,
as on the leader.  Either "no" makes the leader raise :class:`RankFault`,
which the server's dispatch answers as error responses, and the world
serves the next batch.  What the leader can refuse before a collective
(``_validate``, the host targets) it refuses before announcing.

A rank that says "no" after the call waits at most :data:`FAULT_GRACE_S`
for the others' word.  They all come when the ranks are still in step:
every rank met the same fault, or the fault came after the launch's last
collective.  They do not come when the fault left the others inside one
of the engine's collectives, waiting for this rank's rows: the world is
then out of step, and this rank ends its process at once
(:data:`LOST_EXIT_CODE`, no teardown of the process groups, whose
destructors would wait on the collectives in flight).  So does a rank
whose announcement, payload or agreement fails because another rank has
gone.  On gloo the ranks left see their peers' sockets close and end in
turn; on NCCL ``torchrun`` (or the harness that started the world) stops
them when the first rank exits.  An idle follower waits for the next
header up to :data:`CONTROL_TIMEOUT`.  Nothing falls back to one rank or
to the CPU.
"""
from __future__ import annotations

import os
import pickle
import sys
import time
from datetime import timedelta
from typing import Any, Callable, Dict, List, NoReturn, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as trees
from repro_torch.serve import registry
from repro_torch.serve.adapters import block_until_ready

#: Capacity of the header broadcast; a larger header takes a second one.
HEADER_BYTES = 4096
#: Byte alignment of each tensor in the packed payload: every tensor views
#: its bytes in its own dtype, at an address the kernels' vector loads
#: take (the caching allocator's own alignment).
_ALIGN = 256
_STOP = "stop"
#: Seconds a rank that says "no" after a call waits for the others' word
#: before it takes the world for out of step (module docstring).
FAULT_GRACE_S = 60.0
#: How long a follower waits for the next header: the longest a server on
#: the leader may sit idle (the control group's timeout).
CONTROL_TIMEOUT = timedelta(days=1)
#: The exit code of a rank whose serving world is lost.
LOST_EXIT_CODE = 70


class RankFault(RuntimeError):
    """A launch that did not run, or did not run to its end, on some rank
    of the serving world; every rank agreed on it and goes on."""


class _Packed(int):
    """A tensor leaf of a shipped residual tree: its index in the
    payload."""


class CallStream:
    """The leader's announcements and every rank's agreements.

    Construct on every rank at the same point (it makes a process group).
    ``device`` is where the payload travels: the adapter's device (NCCL
    carries the card's tensors, gloo the CPU's and, staged through the
    host, the card's).  :attr:`stats` counts, on each rank, the calls by
    op, the stream's own collectives, the header, payload and residual
    bytes, and the seconds spent announcing and agreeing.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        # headers and agreements on the host, whatever carries the payload
        self.control = dist.new_group(backend="gloo",
                                      timeout=CONTROL_TIMEOUT)
        self.stats: Dict[str, Any] = dict(
            calls={}, collectives=0, header_bytes=0, payload_bytes=0,
            residual_bytes=0, announce_s=0.0, agree_s=0.0)

    # -- the header and the payload ------------------------------------------

    def _header(self, header: Optional[dict]) -> dict:
        """Broadcast ``header`` from rank 0 (None on the others): one
        collective of :data:`HEADER_BYTES`, two for a longer header."""
        buf = torch.zeros(HEADER_BYTES, dtype=torch.uint8)
        if self.rank == 0:
            raw = pickle.dumps(header)
            head = len(raw).to_bytes(8, "little") + raw
            buf[:min(len(head), HEADER_BYTES)] = torch.frombuffer(
                bytearray(head[:HEADER_BYTES]), dtype=torch.uint8)
        self._collective("header", dist.broadcast, buf, src=0,
                         group=self.control)
        n = int.from_bytes(bytes(buf[:8].tolist()), "little")
        if 8 + n > HEADER_BYTES:
            rest = torch.zeros(8 + n - HEADER_BYTES, dtype=torch.uint8)
            if self.rank == 0:
                rest.copy_(torch.frombuffer(bytearray(head[HEADER_BYTES:]),
                                            dtype=torch.uint8))
            self._collective("header", dist.broadcast, rest, src=0,
                             group=self.control)
            buf = torch.cat([buf, rest])
        self.stats["header_bytes"] += n
        return header if self.rank == 0 else pickle.loads(
            bytes(buf[8:8 + n].numpy()))

    def _payload(self, specs, tensors=None) -> List[torch.Tensor]:
        """Broadcast the call's tensors from rank 0 as one byte buffer on
        :attr:`device`; every rank gets them back as views of it, in
        their dtypes and shapes."""
        if not specs:
            return []
        sizes = [_aligned(_nbytes(dtype, shape)) for dtype, shape in specs]
        buf = torch.empty(sum(sizes), dtype=torch.uint8, device=self.device)
        if self.rank == 0:
            off = 0
            for t, size in zip(tensors, sizes):
                raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
                buf[off:off + raw.numel()].copy_(raw)
                off += size
        self._collective("payload", dist.broadcast, buf, src=0)
        self.stats["payload_bytes"] += buf.numel()
        out, off = [], 0
        for (dtype, shape), size in zip(specs, sizes):
            n = _nbytes(dtype, shape)
            out.append(buf[off:off + n].view(_DTYPES[dtype]).reshape(shape))
            off += size
        return out

    def announce(self, op: str, header: dict,
                 tensors=()) -> List[torch.Tensor]:
        """Rank 0: send a call and its tensors; returns the tensors as
        every rank received them (on :attr:`device`)."""
        t0 = time.perf_counter()
        specs = [(str(t.dtype), tuple(t.shape)) for t in tensors]
        self._header(dict(header, op=op, specs=specs))
        out = self._payload(specs, list(tensors))
        self.stats["announce_s"] += time.perf_counter() - t0
        calls = self.stats["calls"]
        calls[op] = calls.get(op, 0) + 1
        return out

    def receive(self):
        """Ranks > 0: the next call's header and tensors."""
        header = self._header(None)
        tensors = self._payload(header["specs"])
        calls = self.stats["calls"]
        calls[header["op"]] = calls.get(header["op"], 0) + 1
        return header, tensors

    def _collective(self, what: str, fn, *args, **kwargs) -> None:
        try:
            fn(*args, **kwargs)
        except Exception as e:                          # noqa: BLE001
            self.lose(f"the {what} broadcast failed: {e}")
        self.stats["collectives"] += 1

    def agree(self, ok: bool) -> bool:
        """Every rank's ``ok``, and-ed: one word all-reduced (minimum).  A
        rank that says no waits at most :data:`FAULT_GRACE_S` for the
        others, and ends its process if they do not come."""
        t0 = time.perf_counter()
        flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
        work = dist.all_reduce(flag, op=dist.ReduceOp.MIN,
                               group=self.control, async_op=True)
        try:
            if ok:
                work.wait()
            else:
                work.wait(timedelta(seconds=FAULT_GRACE_S))
        except Exception as e:                          # noqa: BLE001
            self.lose(f"the ranks did not agree (this rank said "
                      f"{'yes' if ok else 'no'}): {e}")
        self.stats["collectives"] += 1
        self.stats["agree_s"] += time.perf_counter() - t0
        return bool(flag.item())

    def lose(self, why: str) -> NoReturn:
        """End this rank's process: its world is out of step, or a rank of
        it is gone.  No teardown: a process group's destructor would wait
        on the collectives still in flight."""
        sys.stdout.flush()
        sys.stderr.write(f"[serve/follower] rank {self.rank}: the serving "
                         f"world is lost: {why}\n")
        sys.stderr.flush()
        os._exit(LOST_EXIT_CODE)

    def stop(self) -> None:
        """Rank 0: release the followers."""
        self._header(dict(op=_STOP, specs=[]))


_DTYPES = {str(d): d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16,
    torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
    torch.bool)}


def _nbytes(dtype: str, shape) -> int:
    n = _DTYPES[dtype].itemsize
    for s in shape:
        n *= s
    return n


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _split_tree(tree):
    """``(skeleton, tensors)``: the tree with each tensor leaf replaced by
    its :class:`_Packed` index (other leaves, the ints of a shape and None
    sites, stay), and the tensors in leaf order."""
    tensors = []

    def leaf(t):
        if isinstance(t, torch.Tensor):
            tensors.append(t)
            return _Packed(len(tensors) - 1)
        return t
    return trees.tree_map(leaf, tree), tensors


def _join_tree(skeleton, tensors):
    return trees.tree_map(
        lambda t: tensors[t] if isinstance(t, _Packed) else t, skeleton)


def _explainer_form(explainer) -> str:
    """How the leader's server built ``explainer``: on an engine
    (``from_engine``) or on the adapter's closures (``TimedAdapter``)."""
    return "engine" if explainer.engine is not None else "closure"


class StreamAdapter:
    """Rank 0's adapter: the inner adapter's surface, each call that
    reaches the mesh announced to the followers and agreed on (see the
    module docstring).  ``key`` names the inner adapter to the followers
    (its precision: the primary adapter's, or the rerouted sibling's)."""

    def __init__(self, inner, stream: CallStream, key: Optional[str] = None):
        self.inner = inner
        self.stream = stream
        self.key = key if key is not None else inner.precision
        self.store_rules = inner.store_rules
        self.input_kind = getattr(inner, "input_kind", "image")
        # the residual tree of the last predict, which every rank holds
        self._held = None
        # rule sets whose engine every rank has built
        self._built = {inner.store_rules}

    def __enter__(self) -> "StreamAdapter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Release the followers: their :func:`follow` returns."""
        self.stream.stop()

    # -- the inner adapter's surface -----------------------------------------

    @property
    def example_shape(self):
        return getattr(self.inner, "example_shape", None)

    @property
    def n_shards(self) -> int:
        return getattr(self.inner, "n_shards", 1)

    @property
    def device(self):
        return getattr(self.inner, "device", None)

    @property
    def engine(self):
        return self.inner.engine

    @property
    def precision(self) -> str:
        return self.inner.precision

    def model_fn(self, rules: str):
        """The inner adapter's closure, its engine built on every rank:
        call it inside :meth:`attribute` only (its collectives are the
        announced launch's)."""
        self.engine_for(rules)
        return self.inner.model_fn(rules)

    def manual_backward(self, rules: str):
        self.engine_for(rules)
        return self.inner.manual_backward(rules)

    # -- announced calls -----------------------------------------------------

    def _launch(self, op: str, header: dict, tensors, run: Callable):
        """Announce, agree that every rank prepared, run, agree that
        every rank ran; :class:`RankFault` where some rank did not, the
        call's own error where this rank failed in step with the others
        (:meth:`CallStream.agree` ends the process where it did not)."""
        args = self.stream.announce(op, dict(header, adapter=self.key),
                                    tensors)
        if not self.stream.agree(True):
            raise RankFault(f"{op}: a follower could not prepare the launch")
        try:
            out = block_until_ready(run(*args))
        except BaseException:
            self.stream.agree(False)
            raise
        if not self.stream.agree(True):
            raise RankFault(f"{op}: the launch failed on a follower")
        return out

    def predict(self, xb):
        out = self._launch("predict", {}, [torch.as_tensor(xb)],
                           self.inner.predict)
        self._held = out[1]
        return out

    def explain_cached(self, method: str, residuals, seeds):
        seeds = torch.as_tensor(seeds)
        if residuals is self._held:
            # the predict this explain follows: every rank holds it whole
            return self._launch(
                "explain_cached", dict(method=method, held=True), [seeds],
                lambda s: self.inner.explain_cached(method, residuals, s))
        skeleton, tensors = _split_tree(residuals)
        self.stream.stats["residual_bytes"] += sum(
            t.numel() * t.element_size() for t in tensors)
        return self._launch(
            "explain_cached",
            dict(method=method, held=False, skeleton=skeleton),
            [seeds] + tensors,
            lambda s, *ts: self.inner.explain_cached(
                method, _join_tree(skeleton, ts), s))

    def attribute(self, explainer, xb, *, target=None, key=None):
        """``explainer.attribute(xb, target=, key=)`` on every rank: the
        followers build the same explainer (method, options and form) on
        their adapter."""
        header = dict(method=explainer.name, opts=explainer.opts,
                      form=_explainer_form(explainer),
                      target=None if target is None
                      else torch.as_tensor(target).tolist(),
                      key=key)
        return self._launch(
            "attribute", header, [torch.as_tensor(xb)],
            lambda x: explainer.attribute(x, target=target, key=key))

    def with_precision(self, precision: str) -> "StreamAdapter":
        """The sibling at ``precision``, built on every rank."""
        sibling = self._launch("with_precision", dict(precision=precision),
                               (), lambda: self.inner.with_precision(
                                   precision))
        return StreamAdapter(sibling, self.stream, key=precision)

    def engine_for(self, rules: str):
        """The engine of ``rules``, built on every rank (announced once:
        the inner adapters keep what they built)."""
        if rules in self._built:
            return self.inner.engine_for(rules)
        eng = self._launch("engine_for", dict(rules=rules), (),
                           lambda: self.inner.engine_for(rules))
        self._built.add(rules)
        return eng


def lead(adapter) -> StreamAdapter:
    """Rank 0: the :class:`StreamAdapter` a server drives; closing it (or
    leaving its ``with`` block) releases the followers.  Every rank calls
    :func:`lead` or :func:`follow` at the same point."""
    stream = CallStream(adapter.device)
    if stream.rank != 0:
        raise ValueError(f"rank {stream.rank} follows; rank 0 leads")
    return StreamAdapter(adapter, stream)


class Follower:
    """A rank > 0: joins each launch announced by rank 0's
    :class:`StreamAdapter` on its own ``adapter`` (the same spec as the
    leader's: the same weights and device profile)."""

    def __init__(self, adapter, stream: CallStream):
        self.stream = stream
        self.adapters = {adapter.precision: adapter}
        self._held: Dict[str, Any] = {}
        self._explainers: Dict[tuple, registry.Explainer] = {}
        #: launches this rank could not prepare or run: (op, error)
        self.faults: List[tuple] = []

    def run(self) -> dict:
        """Serve until the leader stops; returns :attr:`CallStream.stats`
        with this rank's faults."""
        while True:
            header, tensors = self.stream.receive()
            op = header["op"]
            if op == _STOP:
                return dict(self.stream.stats, faults=list(self.faults))
            try:
                call = self._prepare(op, header, tensors)
            except Exception as e:                      # noqa: BLE001
                call = None
                self.faults.append((op, f"{type(e).__name__}: {e}"))
            if not self.stream.agree(call is not None):
                continue
            try:
                block_until_ready(call())
                ok = True
            except Exception as e:                      # noqa: BLE001
                ok = False
                self.faults.append((op, f"{type(e).__name__}: {e}"))
            self.stream.agree(ok)

    def _explainer(self, key, method, opts, form):
        # one server's options are not another's (their launches differ)
        ck = (key, method, form, repr(sorted(opts.items())))
        if ck not in self._explainers:
            self._explainers[ck] = registry.explainer_for(
                self.adapters[key], method, opts, form)
        return self._explainers[ck]

    def _prepare(self, op: str, header: dict, tensors) -> Callable:
        """The call to run, everything that may fail before it done."""
        key = header["adapter"]
        adapter = self.adapters[key]
        if op == "predict":
            def run():
                out = adapter.predict(tensors[0])
                self._held[key] = out[1]
                return out
            return run
        if op == "explain_cached":
            residuals = (self._held[key] if header["held"]
                         else _join_tree(header["skeleton"], tensors[1:]))
            return lambda: adapter.explain_cached(header["method"],
                                                  residuals, tensors[0])
        if op == "attribute":
            explainer = self._explainer(key, header["method"],
                                        header["opts"], header["form"])
            target = header["target"]
            target = None if target is None else torch.as_tensor(target)
            return lambda: explainer.attribute(tensors[0], target=target,
                                               key=header["key"])
        # engine builds make the mesh's groups: they run where the
        # leader's do, after the first agreement
        if op == "with_precision":
            p = header["precision"]

            def run():
                if p not in self.adapters:
                    self.adapters[p] = adapter.with_precision(p)
            return run
        if op == "engine_for":
            return lambda: adapter.engine_for(header["rules"])
        raise ValueError(f"unknown call {op!r} in the stream")


def follow(adapter) -> dict:
    """Ranks > 0: join every launch of rank 0's server on ``adapter``
    until it closes its stream; returns this rank's stream stats and
    faults."""
    stream = CallStream(adapter.device)
    if stream.rank == 0:
        raise ValueError("rank 0 leads; ranks > 0 follow")
    return Follower(adapter, stream).run()
