"""Dynamic micro-batching engine: a request queue drained by a worker
thread that groups requests by (model, length bucket), right-pads them
into fixed bucket shapes, and runs one ``predict`` per batch. A window
is [T, F] features (the paper LSTM) or [T] int32 token ids (a zoo LM,
whose ``feature_dim`` is 0), as in ``repro.serving.engine``.

Flush policy: a group is dispatched as soon as it holds ``max_batch``
requests, or when its oldest request has waited ``max_wait_ms``. Shapes
are quantized (lengths to a bucket, batch to a power of two), so the set
of shapes the card sees is small and fixed; ``warmup`` runs each once.

Streaming sessions ride the same queue: ``submit_step`` enqueues one
observation for a client's session, and the worker flushes every queued
step for a model as ONE ``generate`` over the device-resident decode
slots (``RecurrentSessionRunner.step_many``) instead of one call per
client.

The flush worker is its own thread: the forecaster's kernels launch on
that thread's current CUDA stream, and results reach the host through
one device-to-host copy per flush. ``ServingEngine`` is the single-shard
engine; the sharded mesh and ensemble fan-out of
``repro.serving.engine`` wait for later slices of the port.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from repro_torch.obs.trace import _EPOCH as _TRACE_EPOCH
from repro_torch.obs.trace import FlushSpans as _FlushSpans
from repro_torch.obs.trace import finish_all as _finish_all
from repro_torch.serving.sessions import (RecurrentSessionRunner,
                                          SessionCache)
from repro_torch.serving.telemetry import Telemetry


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_batch: int = 32
    max_wait_ms: float = 2.0
    # admissible padded lengths; () -> round up to the next power of two
    length_buckets: tuple[int, ...] = ()
    # pad the batch dim to a power of two (<= max_batch) so the shapes
    # run are {pow2 batches} x {length buckets}, not arbitrary
    pad_batch: bool = True
    # device-resident decode lanes per model runner (rounded up to the
    # forecaster's decode width): a step flush is ONE generate.
    # 0 disables slots and uses the cache gather/scatter path
    decode_slots: int = 64

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.decode_slots < 0:
            raise ValueError(
                f"decode_slots must be >= 0, got {self.decode_slots}")
        if self.pad_batch and self.max_batch & (self.max_batch - 1):
            # a non-pow2 max_batch would make bucket_batch emit a
            # non-pow2 clamped shape: round it down
            object.__setattr__(self, "max_batch",
                               1 << (self.max_batch.bit_length() - 1))

    def bucket_len(self, t: int) -> int:
        if not self.length_buckets:
            return _next_pow2(max(t, 8))
        for b in sorted(self.length_buckets):
            if t <= b:
                return b
        # longer than every configured bucket: clamp to the largest one
        # instead of emitting a shape outside the fixed set. ``submit``
        # truncates the payload to its newest ``bucket`` rows; the LSTM
        # is causal, so those rows are what the clamped window serves.
        return max(self.length_buckets)

    def bucket_batch(self, n: int) -> int:
        if not self.pad_batch:
            return n
        return min(_next_pow2(n), self.max_batch)


class _Request:
    __slots__ = ("payload", "length", "future", "t_enq", "client_id",
                 "trace", "t_trace")

    def __init__(self, payload: np.ndarray, t_enq: float,
                 client_id: str | None = None, trace=None,
                 t_trace=None):
        self.payload = payload
        self.length = payload.shape[0]
        self.future: Future = Future()
        self.t_enq = t_enq
        self.client_id = client_id
        self.trace = trace          # upstream Trace | None
        self.t_trace = t_trace      # deferred-trace submit stamp | None


class _StepRequest:
    """One streaming step: a single feature vector for a session, grouped
    per model and flushed as one ``generate``."""

    __slots__ = ("payload", "history", "future", "t_enq", "client_id",
                 "trace", "t_trace")

    def __init__(self, payload: np.ndarray, t_enq: float, client_id: str,
                 history=None, trace=None, t_trace=None):
        self.payload = payload
        self.history = history
        self.future: Future = Future()
        self.t_enq = t_enq
        self.client_id = client_id
        self.trace = trace
        self.t_trace = t_trace


# pseudo length-bucket under which step requests group in the pending
# map: one flush group per model, orthogonal to the window buckets
_STEP_BUCKET = -1


class EngineShard:
    """One serving worker: a request queue drained by a thread that
    groups, pads and dispatches micro-batches over a ``ModelRegistry``
    (anything with ``get(key) -> forecaster`` works)."""

    def __init__(self, registry, config: BatcherConfig | None = None,
                 tracer=None):
        self.registry = registry
        self.config = config or BatcherConfig()
        self.telemetry = Telemetry()
        # per-request trace spans (repro_torch.obs.Tracer); None -> off
        self.tracer = tracer
        self._trace_meta: dict[str, dict] = {}
        self._queue: queue.Queue = queue.Queue()
        self._pending: dict[tuple[str, int], list] = {}
        self._running = False
        # makes submit's running-check + enqueue atomic w.r.t. stop()
        self._state_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        # streaming sessions: the spill-tier carry cache + one runner per
        # hosted model, built lazily on the first step
        self.sessions = SessionCache(telemetry=self.telemetry)
        self._runners: dict[str, RecurrentSessionRunner] = {}
        self._runners_lock = threading.Lock()

    def _step_runner(self, model_key: str):
        runner = self._runners.get(model_key)
        if runner is None:
            with self._runners_lock:
                runner = self._runners.get(model_key)
                if runner is None:
                    # provider-backed: the runner re-resolves the key
                    # each flush, so hot-swaps are picked up
                    def provider():
                        return self.registry.get(model_key)

                    fc = provider()
                    n_slots = self.config.decode_slots \
                        if hasattr(fc, "init_slots") else 0
                    runner = RecurrentSessionRunner(
                        provider, cache=self.sessions, num_slots=n_slots)
                    self._runners[model_key] = runner
        return runner

    def session_clients(self) -> list[str]:
        """Every client with live session state on this shard: spill
        tier (cache) plus lane-resident sessions."""
        clients = set(self.sessions.clients())
        with self._runners_lock:
            runners = list(self._runners.values())
        for r in runners:
            clients.update(r.resident_clients())
        return sorted(clients)

    def slot_stats(self) -> dict:
        """Aggregate decode-slot occupancy over this shard's runners."""
        with self._runners_lock:
            runners = list(self._runners.values())
        agg = {"lanes": 0, "active": 0, "inserts": 0, "spills": 0,
               "expiries": 0}
        for r in runners:
            for k, v in r.slot_stats().items():
                agg[k] += v
        return agg

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "EngineShard":
        with self._state_lock:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(
            target=self._worker, name="serving-engine",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._state_lock:
            if not self._running:
                return
            self._running = False
        # any submit that saw _running under the lock has already
        # enqueued, and the worker drains queue + pending before exiting
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "EngineShard":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _meta_for(self, model_key: str) -> dict:
        meta = self._trace_meta.get(model_key)
        if meta is None:
            meta = self._trace_meta[model_key] = {"model": model_key}
        return meta

    @staticmethod
    def _trace_gather(tracer, reqs):
        """One pass over a flush's requests collecting its tracing work:
        ``traced`` are caller-supplied Traces joining the shared
        FlushSpans record; ``deferred`` are (t_submit, t_enq) stamp pairs
        of in-process requests, folded into one ring block."""
        traced, deferred, fspans = [], [], None
        for r in reqs:
            if r.trace is not None:
                if fspans is None:
                    fspans = _FlushSpans()
                r.trace.attach_flush(fspans, r.t_enq)
                traced.append(r.trace)
            elif r.t_trace is not None and tracer is not None:
                deferred.append((r.t_trace, r.t_enq))
        if deferred and fspans is None:
            fspans = _FlushSpans()
        return traced, deferred, fspans

    def _reject(self, op: str, model_key: str, trace, t_tr) -> None:
        """Record a synchronous reject as an error trace."""
        if trace is not None:
            trace.finish(status="error")
        elif t_tr is not None:
            err = self.tracer.start(op, t0=_TRACE_EPOCH + t_tr,
                                    meta=self._meta_for(model_key))
            if err is not None:
                err.finish(status="error")

    def _enqueue(self, model_key: str, req) -> Future:
        with self._state_lock:
            if not self._running:
                raise RuntimeError("engine is not running (use start() or a "
                                   "with-block)")
            self._queue.put((model_key, req))
        return req.future

    def _trace_stamp(self, trace):
        tracer = self.tracer
        return (time.perf_counter()
                if trace is None and tracer is not None and tracer.enabled
                else None)

    # -- client API --------------------------------------------------------
    def submit(self, model_key: str, window,
               client_id: str | None = None, trace=None) -> Future:
        """Enqueue one window: [T, F] features, or [T] int token ids for
        a model without a feature axis (a zoo LM); returns a Future
        resolving to (forecast, p_extreme) scalars. ``client_id`` feeds
        per-client telemetry; ``trace`` is a caller's Trace (with none,
        the engine's tracer records the request)."""
        t_tr = self._trace_stamp(trace)
        try:
            payload = np.asarray(window)
            fc = self.registry.get(model_key)
            F = fc.feature_dim
            if payload.ndim != (2 if F else 1) or payload.shape[0] < 1 \
                    or (F and payload.shape[1] != F):
                raise ValueError(
                    f"{model_key!r} expects windows of shape "
                    f"{f'[T>=1, {F}]' if F else '[T>=1]'}, got "
                    f"{payload.shape}")
        except Exception:
            self._reject("predict", model_key, trace, t_tr)
            raise
        bucket = self.config.bucket_len(payload.shape[0])
        if payload.shape[0] > bucket:
            # over-long window clamped to the largest length bucket
            payload = payload[-bucket:]
        return self._enqueue(model_key, _Request(
            payload, time.perf_counter(), client_id=client_id, trace=trace,
            t_trace=t_tr))

    def predict(self, model_key: str, window, timeout: float | None = 30.0,
                client_id: str | None = None):
        return self.submit(model_key, window,
                           client_id=client_id).result(timeout=timeout)

    def submit_step(self, model_key: str, client_id: str, x_t,
                    history=None, trace=None) -> Future:
        """Enqueue one streaming step for ``client_id``'s session: ``x_t``
        is a single [F] feature vector, ``history`` an optional [T, F]
        window prefix replayed on a cache miss. Steps for a model group
        into ONE ``generate`` per flush. Returns a Future resolving to
        (forecast, p_extreme) scalars."""
        t_tr = self._trace_stamp(trace)
        try:
            fc = self.registry.get(model_key)
            if not hasattr(fc, "step") or not fc.feature_dim:
                raise ValueError(
                    f"{model_key!r} does not support incremental session "
                    f"serving (needs step/init_carry/replay and a feature "
                    f"dim)")
            payload = np.asarray(x_t, np.float32)
            if payload.ndim == 2 and payload.shape[0] == 1:
                payload = payload[0]
            if payload.shape != (fc.feature_dim,):
                raise ValueError(
                    f"{model_key!r} expects step vectors of shape "
                    f"[{fc.feature_dim}], got {payload.shape}")
            if history is not None:
                # validate against this caller only: a malformed history
                # failing inside the flush would fail every client in it
                history = np.asarray(history, np.float32)
                if history.ndim != 2 or history.shape[0] < 1 \
                        or history.shape[1] != fc.feature_dim:
                    raise ValueError(
                        f"history must be [T>=1, {fc.feature_dim}], got "
                        f"{history.shape}")
            if client_id is None:
                raise ValueError("streaming steps require a client_id "
                                 "(the session key)")
        except Exception:
            self._reject("step", model_key, trace, t_tr)
            raise
        return self._enqueue(model_key, _StepRequest(
            payload, time.perf_counter(), str(client_id), history=history,
            trace=trace, t_trace=t_tr))

    def step(self, model_key: str, client_id: str, x_t, history=None,
             timeout: float | None = 30.0):
        """Blocking ``submit_step``: one (forecast, p_extreme) tuple."""
        return self.submit_step(model_key, client_id, x_t,
                                history=history).result(timeout=timeout)

    def warmup(self, model_key: str, lengths: tuple[int, ...] | None = None
               ) -> int:
        """Run every (pow2 batch) x (length bucket) predict the hot path
        can hit, plus the decode paths, off the serving path (on the card
        the first call also builds the kernel). Returns #shapes run."""
        fc = self.registry.get(model_key)
        lens = lengths if lengths is not None else (fc.window,)
        max_b = self.config.max_batch
        if self.config.pad_batch:
            batches = sorted({min(1 << i, max_b)
                              for i in range(max_b.bit_length() + 1)})
        else:
            batches = list(range(1, max_b + 1))
        n = 0
        for t in {self.config.bucket_len(x) for x in lens}:
            for b in batches:
                zeros = [np.zeros(self._payload_shape(fc, t),
                                  self._payload_dtype(fc))] * b
                fc.predict(*self._padded(fc, zeros, [t] * b, b, t))
                n += 1
        if hasattr(fc, "warm_decode") and fc.feature_dim:
            n += fc.warm_decode()
            self._step_runner(model_key)
        return n

    # -- batching internals ------------------------------------------------
    @staticmethod
    def _payload_shape(fc, t: int):
        return (t, fc.feature_dim) if fc.feature_dim else (t,)

    @staticmethod
    def _payload_dtype(fc):
        return np.float32 if fc.feature_dim else np.int32

    def _padded(self, fc, payloads, lengths, bucket_b: int, bucket_t: int):
        """Stack variable-length payloads into one right-padded batch of
        shape [bucket_b, bucket_t, ...]; padded rows get length 1."""
        x = np.zeros((bucket_b,) + self._payload_shape(fc, bucket_t),
                     self._payload_dtype(fc))
        out_len = np.ones((bucket_b,), np.int32)
        for i, (p, t) in enumerate(zip(payloads, lengths)):
            x[i, :t] = p
            out_len[i] = t
        return x, out_len

    def _fail(self, op, model_key, reqs, exc, traced, deferred, fspans):
        for r in reqs:
            r.future.set_exception(exc)
        _finish_all(traced, status="error")
        if deferred:
            self.tracer.finish_block(op, self._meta_for(model_key), fspans,
                                     deferred, status="error")

    def _deliver(self, op, model_key, reqs, values, version, traced,
                 deferred, fspans, t0f):
        if fspans is not None:
            # scatter + the umbrella flush span, before set_result
            fspans.umbrella("flush", t0f, fspans.stamp("scatter"))
        for r, value in zip(reqs, values):
            # attribution before set_result: a client that wakes on the
            # result sees which model version produced it
            r.future.model_version = version
            r.future.client_id = r.client_id
            r.future.set_result(value)
        if fspans is not None:
            fspans.stamp("reply")
            _finish_all(traced)
            if deferred:
                self.tracer.finish_block(op, self._meta_for(model_key),
                                         fspans, deferred)

    def _flush_steps(self, model_key: str, reqs: list[_StepRequest]) -> None:
        """One batched decode flush: every queued step for ``model_key``
        through the session runner's ``step_many`` (one ``generate``)."""
        reqs = [r for r in reqs if r.future.set_running_or_notify_cancel()]
        if not reqs:
            return
        traced, deferred, fspans = self._trace_gather(self.tracer, reqs)
        t0f = fspans.stamp("queue") if fspans is not None else None
        try:
            runner = self._step_runner(model_key)
            fc = runner._resolve()
            outs = runner.step_many([(r.client_id, r.payload, r.history)
                                     for r in reqs])
        except Exception as e:  # noqa: BLE001 - fail the steps, not the engine
            self._fail("step", model_key, reqs, e, traced, deferred, fspans)
            return
        if fspans is not None:
            fspans.stamp("dispatch")
        now = time.perf_counter()
        self.telemetry.record_step_batch(
            [now - r.t_enq for r in reqs],
            n_padded=getattr(runner, "last_step_slots", len(reqs)),
            model=model_key)
        self._deliver("step", model_key, reqs, outs,
                      getattr(fc, "version", None), traced, deferred,
                      fspans, t0f)

    def _flush(self, model_key: str, bucket_t: int, reqs: list) -> None:
        if bucket_t == _STEP_BUCKET:
            self._flush_steps(model_key, reqs)
            return
        # transition futures to RUNNING; drops client-cancelled requests
        reqs = [r for r in reqs if r.future.set_running_or_notify_cancel()]
        if not reqs:
            return
        traced, deferred, fspans = self._trace_gather(self.tracer, reqs)
        t0f = fspans.stamp("queue") if fspans is not None else None
        try:
            # one reference per flush: the whole micro-batch serves on
            # these weights even if the registry swaps mid-predict
            fc = self.registry.get(model_key)
            bucket_b = self.config.bucket_batch(len(reqs))
            x, lens = self._padded(fc, [r.payload for r in reqs],
                                   [r.length for r in reqs], bucket_b,
                                   bucket_t)
            if fspans is not None:
                fspans.stamp("gather", meta={"batch": len(reqs),
                                             "padded": bucket_b})
            forecast, p_extreme = fc.predict(x, lens)
        except Exception as e:  # noqa: BLE001 - fail the requests, not the engine
            self._fail("predict", model_key, reqs, e, traced, deferred,
                       fspans)
            return
        if fspans is not None:
            fspans.stamp("dispatch")
        now = time.perf_counter()
        version = getattr(fc, "version", None)
        published = getattr(fc, "published_at", None)
        self.telemetry.record_batch(len(reqs), bucket_b)
        self.telemetry.record_requests(
            [now - r.t_enq for r in reqs], version=version,
            staleness_s=(now - published) if published is not None else None,
            client_ids=[r.client_id for r in reqs], model=model_key)
        self._deliver("predict", model_key, reqs,
                      [(float(forecast[i]), float(p_extreme[i]))
                       for i in range(len(reqs))],
                      version, traced, deferred, fspans, t0f)

    def _enqueue_pending(self, model_key: str, req) -> None:
        key = (model_key, _STEP_BUCKET if isinstance(req, _StepRequest)
               else self.config.bucket_len(req.length))
        self._pending.setdefault(key, []).append(req)

    def _worker(self) -> None:
        cfg = self.config
        max_wait = cfg.max_wait_ms * 1e-3
        while self._running or not self._queue.empty() or self._pending:
            # drain everything already queued, then block briefly
            drained = False
            while True:
                try:
                    model_key, req = self._queue.get_nowait()
                except queue.Empty:
                    break
                drained = True
                self._enqueue_pending(model_key, req)
            now = time.perf_counter()
            # flush full groups and expired groups
            for key in list(self._pending):
                reqs = self._pending[key]
                while len(reqs) >= cfg.max_batch:
                    self._flush(key[0], key[1], reqs[:cfg.max_batch])
                    del reqs[:cfg.max_batch]
                if reqs and (now - reqs[0].t_enq >= max_wait
                             or not self._running):
                    self._flush(key[0], key[1], reqs)
                    reqs.clear()
                if not reqs:
                    del self._pending[key]
            if drained:
                continue
            # sleep until the next group deadline (or a short poll)
            timeout = max_wait if not self._pending else max(
                1e-4, min(r[0].t_enq + max_wait
                          for r in self._pending.values())
                - time.perf_counter())
            try:
                model_key, req = self._queue.get(timeout=min(timeout, 0.05))
            except queue.Empty:
                continue
            self._enqueue_pending(model_key, req)


class ServingEngine(EngineShard):
    """Single-shard serving engine (``submit`` / ``predict`` /
    ``submit_step`` / ``warmup``)."""
