"""Per-request trace spans for the serving engine: stdlib-only,
thread-safe, cheap enough for the flush hot path.

A trace accumulates spans as a request moves ``submit -> queue -> gather
-> dispatch -> scatter -> reply`` and is finished into a bounded ring of
completed traces. Spans are (t0, t1) wall-clock pairs from a monotonic
``perf_counter`` anchored to the epoch once at import.

Recording is amortized per flush, not per request: the engine stamps one
shared ``FlushSpans`` record per micro-batch (one clock read per stage
per flush). A trace the caller passed in attaches to it with one tuple
append; a request the engine's own tracer covers allocates no trace at
all while it is served: the flush worker folds the whole micro-batch
into one ``finish_block`` (one ring append, one lock), and ``Trace``
objects materialize only when the ring is read. In-process traces chain
timestamps exactly, so their spans cover a request end to end.

The in-process half of ``repro.obs.trace``: the cross-process stitching
(``adopt``, ``add_spans``, ``export``) waits for the port's process
mesh. ``Tracer(enabled=False)`` returns None from ``start`` and records
nothing. ``Trace.to_dict`` is what the metrics endpoint's ``/traces``
serves: spans numbered in recording order, and a trace id made only
when it is first read.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

# perf_counter anchored to the epoch once: span timestamps are monotonic
_EPOCH = time.time() - time.perf_counter()
_perf_counter = time.perf_counter

# trace ids: pid + a per-process counter, generated lazily
_ids = itertools.count(1)


class Span:
    """One named [t0, t1] interval, materialized when a trace is read."""

    __slots__ = ("name", "t0", "t1", "sid", "meta")

    def __init__(self, name: str, t0: float, t1: float, sid: int,
                 meta: dict | None = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.sid = sid
        self.meta = meta

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        d = {"name": self.name, "t0": self.t0, "t1": self.t1,
             "sid": self.sid}
        if self.meta:
            d["meta"] = self.meta
        return d

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, dur={self.dur * 1e3:.3f}ms, "
                f"sid={self.sid})")


class FlushSpans:
    """One micro-batch flush's stage stamps, shared by every traced
    request of the batch."""

    __slots__ = ("stamps", "umb")

    def __init__(self):
        self.stamps: list[tuple] = []     # (name, t, meta)
        self.umb: tuple | None = None     # (name, t0, t1)

    def stamp(self, name: str, meta: dict | None = None) -> float:
        """Record stage ``name`` at now; returns the stamp so callers can
        chain an umbrella span off it."""
        t = _EPOCH + _perf_counter()
        self.stamps.append((name, t, meta))
        return t

    def umbrella(self, name: str, t0: float, t1: float) -> None:
        """The explicit [t0, t1] span overlapping the chained stamps
        (the engine's whole-flush span)."""
        self.umb = (name, t0, t1)


class Trace:
    """One request's spans. ``t_last`` chains span boundaries (each
    ``mark`` records [t_last, now] and advances it). Raw records are
    ("m", name, t0, t1, meta) for a marked span and ("f", FlushSpans,
    t0, t_submit) for a flush attach, which expands to a "submit" span
    [t0, t_submit] followed by the flush's stamps chained from
    t_submit."""

    __slots__ = ("tracer", "op", "meta", "status", "closed", "t_last",
                 "_tid", "_raw")

    def __init__(self, tracer: "Tracer", op: str, meta: dict | None,
                 t0: float):
        self.tracer = tracer
        self.op = op
        self.meta = meta if meta is not None else {}
        self.status = "open"
        self.closed = False
        self.t_last = t0
        self._tid: str | None = None
        self._raw: list[tuple] = []

    @property
    def trace_id(self) -> str:
        if self._tid is None:
            self._tid = f"{os.getpid():x}-{next(_ids)}"
        return self._tid

    def mark(self, name: str, t: float | None = None, **meta) -> None:
        """Record the span [t_last, t] (t defaults to now)."""
        if self.closed:
            return
        t = _EPOCH + _perf_counter() if t is None else t
        self._raw.append(("m", name, self.t_last, t, meta or None))
        self.t_last = t

    def attach_flush(self, flush: FlushSpans,
                     t_submit: float | None = None) -> None:
        """Join this request to a shared per-flush record. ``t_submit``
        is the request's enqueue stamp as a raw ``perf_counter``
        reading."""
        if not self.closed:
            t0 = self.t_last
            t_sub = t0 if t_submit is None else _EPOCH + t_submit
            self._raw.append(("f", flush, t0, t_sub))

    def finish(self, status: str = "ok") -> "Trace | None":
        return self.tracer.finish(self, status=status)

    @property
    def spans(self) -> list[Span]:
        """The raw records materialized, in recording order."""
        out: list[Span] = []
        for rec in self._raw:
            if rec[0] == "m":
                _, name, t0, t1, meta = rec
                out.append(Span(name, t0, t1, len(out), meta))
                continue
            _, flush, t0, prev = rec
            if prev > t0:
                out.append(Span("submit", t0, prev, len(out)))
            for name, t, meta in flush.stamps:
                out.append(Span(name, prev, t, len(out), meta))
                prev = t
            if flush.umb is not None:
                out.append(Span(*flush.umb, len(out)))
        return out

    @property
    def duration(self) -> float:
        spans = self.spans
        if not spans:
            return 0.0
        return max(s.t1 for s in spans) - min(s.t0 for s in spans)

    def to_dict(self) -> dict:
        spans = sorted(self.spans, key=lambda s: s.t0)
        return {"trace_id": self.trace_id, "op": self.op,
                "status": self.status, "meta": self.meta,
                "t_start": spans[0].t0 if spans else 0.0,
                "duration": (max(s.t1 for s in spans) - spans[0].t0
                             if spans else 0.0),
                "spans": [s.to_dict() for s in spans]}


class _TraceBlock:
    """A whole flush's deferred traces: per request only a raw
    ``(t_start, t_enq)`` stamp pair plus the shared ``FlushSpans``;
    ``Trace``s materialize (once) when the ring is read."""

    __slots__ = ("op", "meta", "flush", "entries", "status", "_traces")

    def __init__(self, op: str, meta: dict | None, flush: FlushSpans,
                 entries: list, status: str):
        self.op = op
        self.meta = meta
        self.flush = flush
        self.entries = entries
        self.status = status
        self._traces: list[Trace] | None = None

    @property
    def n(self) -> int:
        return len(self.entries)

    def materialize(self, tracer: "Tracer") -> list[Trace]:
        if self._traces is None:
            out = []
            for t0, t_enq in self.entries:
                tr = Trace(tracer, self.op, self.meta, _EPOCH + t0)
                tr._raw.append(("f", self.flush, _EPOCH + t0,
                                _EPOCH + t_enq))
                tr.closed = True
                tr.status = self.status
                out.append(tr)
            self._traces = out
        return self._traces


def finish_all(traces, status: str = "ok") -> None:
    """Finish a whole flush's traces, taking each tracer's ring lock
    once."""
    by_tracer: dict[int, tuple[Tracer, list[Trace]]] = {}
    for t in traces:
        by_tracer.setdefault(id(t.tracer), (t.tracer, []))[1].append(t)
    for tracer, group in by_tracer.values():
        tracer.finish_many(group, status=status)


class Tracer:
    """Bounded, thread-safe trace store: a ring of the most recent
    completed traces."""

    def __init__(self, capacity: int = 256, enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = enabled
        self.capacity = capacity
        self._lock = threading.Lock()
        # completed traces, oldest first: Trace entries interleaved with
        # _TraceBlock entries (a block counts as its n traces)
        self._done: deque = deque()
        self._count = 0
        self.started = 0
        self.finished = 0

    def _evict(self) -> None:
        """Trim the ring to capacity (caller holds the lock)."""
        while self._count > self.capacity:
            head = self._done[0]
            if isinstance(head, Trace):
                self._done.popleft()
                self._count -= 1
            else:
                drop = min(head.n, self._count - self.capacity)
                del head.entries[:drop]
                if head._traces is not None:
                    del head._traces[:drop]
                self._count -= drop
                if not head.entries:
                    self._done.popleft()

    def start(self, op: str, t0: float | None = None,
              meta: dict | None = None) -> Trace | None:
        """Open a trace; None when tracing is disabled. ``meta`` is kept
        by reference."""
        if not self.enabled:
            return None
        self.started += 1
        return Trace(self, op, meta,
                     _EPOCH + _perf_counter() if t0 is None else t0)

    def finish(self, trace: Trace, status: str = "ok") -> Trace | None:
        """Move the trace into the completed ring; None if it was
        already finished."""
        if trace.closed:
            return None
        self.finish_many([trace], status=status)
        return trace

    def finish_many(self, traces, status: str = "ok") -> None:
        """``finish`` a whole flush's traces under one ring lock."""
        with self._lock:
            for trace in traces:
                if trace.closed:
                    continue
                trace.closed = True
                trace.status = status
                self._done.append(trace)
                self._count += 1
                self.finished += 1
            self._evict()

    def finish_block(self, op: str, meta: dict | None, flush: FlushSpans,
                     entries: list, status: str = "ok") -> None:
        """Complete a whole flush's deferred traces at once: ``entries``
        are raw perf_counter ``(t_start, t_enq)`` pairs."""
        if not entries:
            return
        block = _TraceBlock(op, meta, flush, entries, status)
        with self._lock:
            self._done.append(block)
            n = len(entries)
            self._count += n
            self.started += n
            self.finished += n
            self._evict()

    def traces(self, n: int | None = None) -> list[Trace]:
        """Most recent completed traces, oldest first."""
        with self._lock:
            out: list[Trace] = []
            for e in self._done:
                if isinstance(e, Trace):
                    out.append(e)
                else:
                    out.extend(e.materialize(self))
        return out if n is None else out[-n:]

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "started": self.started,
                    "finished": self.finished, "completed": self._count}
