"""Serving telemetry: latency percentiles, throughput, batch occupancy,
cache hit-rate and decode-slot occupancy. Pure stdlib, thread-safe,
O(1) per event, cheap enough to sit on the micro-batcher's hot path.

The single-process half of ``repro.serving.telemetry``, with the swap
counter and the sampled history ring that the online path reads; the
fleet merge, ``raw_samples`` and the ensemble / durable-restore
counters wait for the slices of the port that record them.
"""

from __future__ import annotations

import threading
import time
from collections import deque


def _pick(data: list[float], p: float) -> float:
    """Nearest-rank percentile from an ALREADY SORTED sample list."""
    if not data:
        return 0.0
    k = min(len(data) - 1, max(0, int(round(p / 100.0 * (len(data) - 1)))))
    return data[k]


def _percentiles(data: list[float], ps) -> list[float]:
    """Several percentiles of one sample set with a single sort."""
    data = sorted(data)
    return [_pick(data, p) for p in ps]


class _Reservoir:
    """Fixed-size ring of the most recent samples (enough for stable
    p50/p95/p99 at serving rates without unbounded memory)."""

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._buf: list[float] = []
        self._pos = 0

    def add(self, value: float) -> None:
        if len(self._buf) < self.capacity:
            self._buf.append(value)
        else:
            self._buf[self._pos] = value
            self._pos = (self._pos + 1) % self.capacity

    def percentile(self, p: float) -> float:
        return _pick(sorted(self._buf), p)

    def percentiles(self, ps) -> list[float]:
        return _percentiles(self._buf, ps)


class Telemetry:
    """Counters + reservoirs for one serving engine."""

    # per-client attribution tracks at most this many distinct client
    # ids; requests from clients beyond the cap are counted in
    # ``untracked_client_requests``
    MAX_TRACKED_CLIENTS = 4096

    # sampled time-series ring: ``sample()`` snapshots land here (the
    # metrics endpoint's /history reads it)
    HISTORY_CAPACITY = 512

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        self._history: deque[dict] = deque(maxlen=self.HISTORY_CAPACITY)
        self._sampler: threading.Thread | None = None
        self._sampler_stop = threading.Event()
        self.requests = 0
        self.batches = 0
        self.padded_slots = 0      # total batch capacity dispatched
        self.real_slots = 0        # non-padding rows dispatched
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0
        self.swaps = 0             # weight hot-swaps observed (cumulative)
        self.reprimes = 0          # session carries re-primed after a swap
        self.requests_by_version: dict[int, int] = {}
        self.requests_by_client: dict[str, int] = {}
        self.requests_by_model: dict[str, int] = {}
        self.untracked_client_requests = 0
        # batched decode path: streaming steps flushed as fused batches
        self.step_requests = 0
        self.step_batches = 0
        self.step_real_slots = 0    # sessions stepped
        self.step_padded_slots = 0  # decode-lane slots dispatched
        # device-resident decode slots: cumulative insert/spill traffic
        # plus occupancy gauges (last seen)
        self.slot_inserts = 0
        self.slot_spills = 0
        self.slot_active = 0
        self.slot_lanes = 0
        self._latency = _Reservoir()
        self._staleness = _Reservoir()   # model age at serve time (s)
        self._batch_sizes = _Reservoir()
        self._step_latency = _Reservoir()

    # -- recording ---------------------------------------------------------
    def record_request(self, latency_s: float, version: int | None = None,
                       staleness_s: float | None = None) -> None:
        with self._lock:
            self.requests += 1
            self._latency.add(latency_s)
            if version is not None:
                self.requests_by_version[version] = \
                    self.requests_by_version.get(version, 0) + 1
            if staleness_s is not None:
                self._staleness.add(staleness_s)

    def record_requests(self, latencies_s, version: int | None = None,
                        staleness_s: float | None = None,
                        client_ids=None, model: str | None = None) -> None:
        """One flush's requests under a single lock acquisition. All rows
        share the flush's version/staleness/``model``; ``client_ids``
        (one per row, None for anonymous requests) feed per-client
        attribution."""
        with self._lock:
            for lat in latencies_s:
                self.requests += 1
                self._latency.add(lat)
                if staleness_s is not None:
                    self._staleness.add(staleness_s)
            if version is not None and latencies_s:
                self.requests_by_version[version] = \
                    self.requests_by_version.get(version, 0) \
                    + len(latencies_s)
            if model is not None and latencies_s:
                self.requests_by_model[model] = \
                    self.requests_by_model.get(model, 0) + len(latencies_s)
            for cid in client_ids or ():
                if cid is None:
                    continue
                if cid in self.requests_by_client or \
                        len(self.requests_by_client) \
                        < self.MAX_TRACKED_CLIENTS:
                    self.requests_by_client[cid] = \
                        self.requests_by_client.get(cid, 0) + 1
                else:
                    self.untracked_client_requests += 1

    def record_swap(self, n: int = 1) -> None:
        with self._lock:
            self.swaps += n

    def record_reprime(self, n: int = 1) -> None:
        with self._lock:
            self.reprimes += n

    def record_step_batch(self, latencies_s, n_padded: int | None = None,
                          model: str | None = None) -> None:
        """One batched streaming-step flush: per-step latencies plus
        decode-lane occupancy (``n_padded`` = lane slots dispatched)."""
        latencies_s = list(latencies_s)
        with self._lock:
            self.step_batches += 1
            self.step_requests += len(latencies_s)
            self.step_real_slots += len(latencies_s)
            self.step_padded_slots += (n_padded if n_padded is not None
                                       else len(latencies_s))
            for lat in latencies_s:
                self._step_latency.add(lat)
            if model is not None and latencies_s:
                self.requests_by_model[model] = \
                    self.requests_by_model.get(model, 0) + len(latencies_s)

    def record_batch(self, n_real: int, n_padded: int) -> None:
        with self._lock:
            self.batches += 1
            self.real_slots += n_real
            self.padded_slots += n_padded
            self._batch_sizes.add(float(n_real))

    def record_cache(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    def record_eviction(self, n: int = 1) -> None:
        with self._lock:
            self.cache_evictions += n

    def record_slots(self, inserts: int = 0, spills: int = 0,
                     active: int | None = None,
                     lanes: int | None = None) -> None:
        """Decode-slot traffic: ``inserts``/``spills`` accumulate (steady
        state adds zero of each); ``active``/``lanes`` are gauges."""
        with self._lock:
            self.slot_inserts += inserts
            self.slot_spills += spills
            if active is not None:
                self.slot_active = active
            if lanes is not None:
                self.slot_lanes = lanes

    # -- reading -----------------------------------------------------------
    def latency_percentile_ms(self, p: float) -> float:
        with self._lock:
            return self._latency.percentile(p) * 1e3

    def snapshot(self) -> dict:
        with self._lock:
            elapsed = max(self._clock() - self._t0, 1e-9)
            lookups = self.cache_hits + self.cache_misses
            lat50, lat95, lat99 = self._latency.percentiles((50, 95, 99))
            stale50, stale95 = self._staleness.percentiles((50, 95))
            batch50, batch95 = self._batch_sizes.percentiles((50, 95))
            step50, step95 = self._step_latency.percentiles((50, 95))
            return {
                "requests": self.requests,
                "batches": self.batches,
                "throughput_rps": self.requests / elapsed,
                "p50_ms": lat50 * 1e3,
                "p95_ms": lat95 * 1e3,
                "p99_ms": lat99 * 1e3,
                "mean_batch": (self.real_slots / self.batches
                               if self.batches else 0.0),
                "batch_p50": batch50,
                "batch_p95": batch95,
                "batch_occupancy": (self.real_slots / self.padded_slots
                                    if self.padded_slots else 0.0),
                "cache_hit_rate": (self.cache_hits / lookups
                                   if lookups else 0.0),
                "cache_evictions": self.cache_evictions,
                "swaps": self.swaps,
                "reprimes": self.reprimes,
                "staleness_p50_s": stale50,
                "staleness_p95_s": stale95,
                "requests_by_version": dict(self.requests_by_version),
                "requests_by_client": dict(self.requests_by_client),
                "requests_by_model": dict(self.requests_by_model),
                "unique_clients": len(self.requests_by_client),
                "untracked_client_requests":
                    self.untracked_client_requests,
                "step_requests": self.step_requests,
                "step_batches": self.step_batches,
                "steps_per_s": self.step_requests / elapsed,
                "mean_step_batch": (self.step_real_slots / self.step_batches
                                    if self.step_batches else 0.0),
                "step_occupancy": (self.step_real_slots
                                   / self.step_padded_slots
                                   if self.step_padded_slots else 0.0),
                "step_p50_ms": step50 * 1e3,
                "step_p95_ms": step95 * 1e3,
                "slot_inserts": self.slot_inserts,
                "slot_spills": self.slot_spills,
                "slot_active": self.slot_active,
                "slot_lanes": self.slot_lanes,
                "slot_occupancy": (self.slot_active / self.slot_lanes
                                   if self.slot_lanes else 0.0),
            }

    # -- sampled time series ----------------------------------------------
    def sample(self) -> dict:
        """One snapshot, timestamped and appended to the ``history``
        ring: the time-series view of this engine's own metrics."""
        snap = self.snapshot()
        snap["ts"] = time.time()
        self._history.append(snap)
        return snap

    def history(self, n: int | None = None) -> list[dict]:
        """The sampled snapshot series, oldest first (bounded ring of
        ``HISTORY_CAPACITY`` samples)."""
        out = list(self._history)
        return out if n is None else out[-n:]

    def start_sampler(self, interval_s: float = 1.0) -> None:
        """Sample ``snapshot()`` into the history ring every
        ``interval_s`` on a daemon thread (idempotent)."""
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if self._sampler is not None:
            return
        self._sampler_stop.clear()

        def loop() -> None:
            while not self._sampler_stop.wait(interval_s):
                self.sample()

        self._sampler = threading.Thread(target=loop,
                                         name="telemetry-sampler",
                                         daemon=True)
        self._sampler.start()

    def stop_sampler(self) -> None:
        if self._sampler is None:
            return
        self._sampler_stop.set()
        self._sampler.join()
        self._sampler = None

    def reset_clock(self) -> None:
        """Restart the measurement window (e.g. after warmup): throughput
        counters AND latency/batch reservoirs, so a snapshot never mixes
        the two windows. Cache and swap counters are cumulative state and
        kept; per-version request counts follow the window."""
        with self._lock:
            self._t0 = self._clock()
            self.requests = 0
            self.batches = 0
            self.real_slots = 0
            self.padded_slots = 0
            self.requests_by_version = {}
            self.requests_by_client = {}
            self.requests_by_model = {}
            self.untracked_client_requests = 0
            self.step_requests = 0
            self.step_batches = 0
            self.step_real_slots = 0
            self.step_padded_slots = 0
            self._latency = _Reservoir()
            self._staleness = _Reservoir()
            self._batch_sizes = _Reservoir()
            self._step_latency = _Reservoir()

    @staticmethod
    def format(snap: dict) -> str:
        line = (f"{snap['requests']} req in {snap['batches']} batches | "
                f"{snap['throughput_rps']:.0f} req/s | "
                f"p50 {snap['p50_ms']:.2f} ms  p95 {snap['p95_ms']:.2f} ms  "
                f"p99 {snap['p99_ms']:.2f} ms | "
                f"mean batch {snap['mean_batch']:.1f} "
                f"(occupancy {snap['batch_occupancy']:.0%}) | "
                f"cache hit {snap['cache_hit_rate']:.0%}")
        if snap.get("swaps"):
            line += (f" | {snap['swaps']} swaps, staleness p95 "
                     f"{snap['staleness_p95_s']:.2f} s, "
                     f"{len(snap['requests_by_version'])} versions served")
        if snap.get("step_requests"):
            line += (f" | {snap['step_requests']} steps in "
                     f"{snap['step_batches']} fused flushes "
                     f"({snap['steps_per_s']:.0f} steps/s, mean batch "
                     f"{snap['mean_step_batch']:.1f}, step p95 "
                     f"{snap['step_p95_ms']:.2f} ms)")
        if snap.get("slot_lanes"):
            line += (f" | slots {snap['slot_active']}/{snap['slot_lanes']} "
                     f"resident ({snap['slot_inserts']} inserts, "
                     f"{snap['slot_spills']} spills)")
        if len(snap.get("requests_by_model", {})) > 1:
            per = " ".join(f"{m}:{n}" for m, n in
                           sorted(snap["requests_by_model"].items()))
            line += f" | by model {per}"
        return line
