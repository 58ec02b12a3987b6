"""Recurrent session cache: per-client carry state kept resident between
requests so a streaming step is O(1) instead of O(window).

``SessionCache`` is model-agnostic (opaque carries with byte
accounting, LRU eviction with an optional TTL and byte budget).
``RecurrentSessionRunner`` binds it to a forecaster with ``init_carry``
/ ``step`` / ``replay``. For a forecaster with the slot lifecycle
(``init_slots`` / ``prefill`` / ``insert`` / ``generate``) the runner is
a slot allocator: sessions live in fixed device lanes between steps, a
batched ``step_many`` is "ensure resident -> one ``generate`` -> read the
requested rows", and the cache is the spill tier that holds carries of
sessions LRU-evicted off the lanes, bitwise-identical on reload. With
``num_slots=0`` carries are gathered from the cache, stepped together at
the decode-lane width and scattered back. Both are bitwise-equal to
stepping each session alone. A cache miss replays the client's window
prefix through the same per-step computation, so, given history on a
miss, eviction never changes the numbers a client sees, only latency.

The fleet-sharded cache of ``repro.serving.sessions`` waits for the
port's mesh.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import OrderedDict
from typing import Any

import numpy as np

from repro_torch.serving.telemetry import Telemetry


@dataclasses.dataclass
class _Session:
    carry: Any
    nbytes: int
    last_used: float
    created: float
    steps: int = 0
    version: int = 0             # model version the carry was built under


class SessionCache:
    """LRU + TTL cache of per-client carries with capacity accounting."""

    def __init__(self, max_sessions: int = 4096,
                 max_bytes: int | None = None,
                 ttl_s: float | None = None,
                 telemetry: Telemetry | None = None,
                 clock=time.monotonic):
        if max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        self.max_sessions = max_sessions
        self.max_bytes = max_bytes
        self.ttl_s = ttl_s
        self.telemetry = telemetry
        self._clock = clock
        self._lock = threading.Lock()
        self._sessions: OrderedDict[str, _Session] = OrderedDict()
        self.nbytes_in_use = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.oversize_admissions = 0   # carries bigger than max_bytes
        self._warned_oversize = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def get_entry(self, client_id: str) -> tuple[Any, int] | None:
        """(carry, model_version) of ``client_id``'s session, refreshing
        its LRU place, or None. The version lets callers detect carries
        built under weights since hot-swapped out."""
        with self._lock:
            expired = self._expire_locked()
            s = self._sessions.get(client_id)
            hit = s is not None
            if hit:
                self._sessions.move_to_end(client_id)
                s.last_used = self._clock()
                self.hits += 1
            else:
                self.misses += 1
        if self.telemetry is not None:
            if expired:
                self.telemetry.record_eviction(expired)
            self.telemetry.record_cache(hit)
        return (s.carry, s.version) if hit else None

    def put(self, client_id: str, carry, nbytes: int,
            version: int = 0) -> None:
        warn_oversize = False
        with self._lock:
            now = self._clock()
            old = self._sessions.pop(client_id, None)
            if old is not None:
                self.nbytes_in_use -= old.nbytes
            if self.max_bytes is not None and nbytes > self.max_bytes:
                # one carry bigger than the whole budget is admitted
                # (evicting it would silently restart the client's
                # stream) but the cache sits over budget: warn once
                self.oversize_admissions += 1
                if not self._warned_oversize:
                    self._warned_oversize = True
                    warn_oversize = True
            self._sessions[client_id] = _Session(
                carry=carry, nbytes=nbytes, last_used=now,
                created=old.created if old else now,
                steps=(old.steps + 1) if old else 1, version=version)
            self.nbytes_in_use += nbytes
            evicted = self._evict_over_locked()
        if warn_oversize:
            warnings.warn(
                f"session carry for {client_id!r} is {nbytes} bytes, over "
                f"the cache's max_bytes={self.max_bytes}: admitted, but "
                f"the cache is over budget until it is evicted "
                f"(stats()['over_budget'] tracks this)",
                RuntimeWarning, stacklevel=2)
        if evicted and self.telemetry is not None:
            self.telemetry.record_eviction(evicted)

    def _evict_over_locked(self) -> int:
        """Evict LRU entries until within the session/byte budgets (a
        lone over-budget session is kept - see ``put``)."""
        evicted = 0
        while len(self._sessions) > self.max_sessions or (
                self.max_bytes is not None
                and self.nbytes_in_use > self.max_bytes
                and len(self._sessions) > 1):
            _, victim = self._sessions.popitem(last=False)
            self.nbytes_in_use -= victim.nbytes
            self.evictions += 1
            evicted += 1
        return evicted

    def clients(self) -> list[str]:
        """Ids of the currently cached sessions (LRU -> MRU order)."""
        with self._lock:
            return list(self._sessions)

    def drop(self, client_id: str) -> bool:
        with self._lock:
            s = self._sessions.pop(client_id, None)
            if s is not None:
                self.nbytes_in_use -= s.nbytes
            return s is not None

    def _expire_locked(self) -> int:
        if self.ttl_s is None:
            return 0
        cutoff = self._clock() - self.ttl_s
        stale = [cid for cid, s in self._sessions.items()
                 if s.last_used < cutoff]
        for cid in stale:
            s = self._sessions.pop(cid)
            self.nbytes_in_use -= s.nbytes
            self.evictions += 1
        return len(stale)

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "sessions": len(self._sessions),
                "nbytes_in_use": self.nbytes_in_use,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / lookups if lookups else 0.0,
                "evictions": self.evictions,
                "over_budget": (self.max_bytes is not None
                                and self.nbytes_in_use > self.max_bytes),
                "oversize_admissions": self.oversize_admissions,
            }


DEFAULT_NUM_SLOTS = 64               # lanes per runner when unspecified


class RecurrentSessionRunner:
    """Streaming serving for a recurrent forecaster: each client is a
    session whose state lives in a device decode lane between requests
    (slot forecasters) or in the session cache (``num_slots=0``).

    ``forecaster`` may be the forecaster itself or a zero-arg provider
    returning the current one (``lambda: registry.get(key)``), so a
    runner follows a registry key across weight hot-swaps. Carries are
    stamped with the model version they were built under; a step that
    sees a newer version re-primes the carry from ``history`` when
    given, and otherwise carries the live state across (swapped versions
    share the config)."""

    def __init__(self, forecaster, cache: SessionCache | None = None,
                 on_miss: str = "zeros", num_slots: int | None = None):
        if callable(forecaster) and not hasattr(forecaster, "step"):
            self._provider = forecaster
        else:
            self._provider = None
            self.forecaster = forecaster
        self.last_step_slots = 0     # lane slots of the last step_many
        fc = self._resolve()
        if on_miss not in ("zeros", "error"):
            raise ValueError("on_miss must be 'zeros' or 'error'")
        self.cache = cache if cache is not None else SessionCache()
        self.on_miss = on_miss
        self._nbytes = fc.carry_nbytes(1)
        self.reprimes = 0            # carries replayed onto new weights
        self.carried_across_swap = 0  # carries reused without history
        # -- device-resident decode slots --------------------------------
        slot_capable = hasattr(fc, "init_slots") \
            and getattr(fc, "feature_dim", 0)
        if num_slots is None:
            num_slots = DEFAULT_NUM_SLOTS if slot_capable else 0
        if num_slots and not slot_capable:
            raise TypeError(
                f"forecaster {type(fc).__name__} does not support "
                f"decode slots (missing init_slots); pass num_slots=0")
        self._slots = fc.init_slots(num_slots) if num_slots else None
        self.num_slots = self._slots.num_slots if self._slots else 0
        self._slots_lock = threading.Lock()
        self._lanes: OrderedDict[str, int] = OrderedDict()  # cid -> lane
        self._free = list(reversed(range(self.num_slots)))  # pop() -> 0..
        self._lane_stamp: dict[str, int] = {}
        self._lane_last_used: dict[str, float] = {}
        self.slot_inserts = 0        # sessions written into a lane
        self.slot_spills = 0         # lane carries spilled to the cache
        self.slot_expiries = 0       # lanes freed by TTL (state dropped)
        window = getattr(fc, "window", None)
        if window and getattr(fc, "feature_dim", 0):
            # run the full-window replay (and the slot lifecycle) once
            # here, off the serving path: on the card the first call
            # builds the kernel
            fc.replay(np.zeros((1, window, fc.feature_dim), np.float32))
            if self._slots is not None:
                fc.warm_slots(self.num_slots)

    def _resolve(self):
        fc = self._provider() if self._provider is not None \
            else self.forecaster
        for attr in ("init_carry", "step", "replay"):
            if not hasattr(fc, attr):
                raise TypeError(
                    f"forecaster {type(fc).__name__} does not "
                    f"support incremental serving (missing {attr!r})")
        return fc

    def _resolve_carry(self, fc, client_id: str, hist, version: int):
        """Cache hit (with lazy re-prime when the weights hot-swapped
        under the carry), else rebuild from history, else zero state /
        error. Returns (carry, version stamp for the put-back)."""
        entry = self.cache.get_entry(client_id)
        carry = None
        stamp = version
        if entry is not None:
            carry, carry_version = entry
            if carry_version != version:
                if hist is not None:
                    _, _, carry = fc.replay(hist[None])
                    self.reprimes += 1
                    if self.cache.telemetry is not None:
                        self.cache.telemetry.record_reprime()
                else:
                    # same config, new weights: keep the OLD stamp so a
                    # later step that does bring history still re-primes
                    self.carried_across_swap += 1
                    stamp = carry_version
        if carry is None:
            if hist is not None:
                _, _, carry = fc.replay(hist[None])
            elif self.on_miss == "error":
                raise KeyError(
                    f"no session for {client_id!r} and no history given")
            else:
                carry = fc.init_carry(1)
        return carry, stamp

    @staticmethod
    def _clamp_history(fc, history):
        if history is None:
            return None
        hist = np.asarray(history, np.float32)
        window = getattr(fc, "window", None)
        if window and hist.shape[0] > window:
            # the serving contract replays window prefixes (the model is
            # causal over a sliding window): keep the newest steps
            hist = hist[-window:]
        return hist

    def step(self, client_id: str, x_t, history=None):
        """One streaming step for ``client_id``: ``x_t`` is one feature
        vector [F] (or [1, F]); on a miss the carry is rebuilt from
        ``history`` ([T, F]) or starts from zero state. Returns
        (forecast, p_extreme) scalars."""
        if self._slots is not None:
            # no out-of-lane step path: a lane-resident session stepped
            # outside its lane would fork its state
            return self.step_many([(client_id, x_t, history)])[0]
        fc = self._resolve()
        version = getattr(fc, "version", 0)
        x_t = np.asarray(x_t, np.float32)
        if x_t.ndim == 1:
            x_t = x_t[None, :]
        hist = self._clamp_history(fc, history)
        carry, stamp = self._resolve_carry(fc, client_id, hist, version)
        y, p, carry = fc.step(x_t, carry)
        self.cache.put(client_id, carry, self._nbytes, version=stamp)
        return float(y[0]), float(p[0])

    def step_many(self, items):
        """Batched streaming step: ``items`` is a list of
        ``(client_id, x_t, history)`` tuples (history may be None). With
        slots, each wave is one ``generate`` over the slot state;
        otherwise carries are gathered, stepped at the lane width and
        scattered back. Duplicate client ids run in follow-up waves, so
        each step sees the carry its predecessor wrote. Returns
        ``[(forecast, p_extreme), ...]`` in item order."""
        fc = self._resolve()
        self.last_step_slots = len(items)
        if not items:
            return []
        if not hasattr(fc, "step_many"):
            return [self.step(cid, x_t, history=h) for cid, x_t, h in items]
        version = getattr(fc, "version", 0)
        results: list = [None] * len(items)
        waves: list[list[int]] = []
        seen_at: dict[str, int] = {}
        for idx, (cid, _x, _h) in enumerate(items):
            wave = seen_at.get(cid, -1) + 1
            seen_at[cid] = wave
            if wave == len(waves):
                waves.append([])
            waves[wave].append(idx)
        if self._slots is not None:
            S = self.num_slots
            n_chunks = 0
            with self._slots_lock:
                self._expire_lanes_locked(fc)
                for wave in waves:
                    for lo in range(0, len(wave), S):
                        n_chunks += 1
                        self._generate_chunk_locked(
                            fc, items, wave[lo:lo + S], version, results)
                tel = self.cache.telemetry
                if tel is not None:
                    tel.record_slots(active=len(self._lanes), lanes=S)
            self.last_step_slots = n_chunks * S
            return results
        width = getattr(fc, "decode_width", None)
        self.last_step_slots = sum(
            (-(-len(w) // width) * width) if width else len(w)
            for w in waves)
        self._run_waves(fc, items, waves, version, results)
        return results

    # -- slot allocator ----------------------------------------------------
    def _expire_lanes_locked(self, fc) -> None:
        """A lane idle past the cache's TTL is freed and its state
        DROPPED (not spilled), as the cache would drop the entry."""
        ttl = self.cache.ttl_s
        if ttl is None or not self._lanes:
            return
        cutoff = self.cache._clock() - ttl
        stale = [cid for cid in self._lanes
                 if self._lane_last_used.get(cid, cutoff) < cutoff]
        for cid in stale:
            lane = self._lanes.pop(cid)
            self._lane_stamp.pop(cid, None)
            self._lane_last_used.pop(cid, None)
            fc.release(self._slots, lane)
            self._free.append(lane)
            self.slot_expiries += 1
        if stale and self.cache.telemetry is not None:
            self.cache.telemetry.record_eviction(len(stale))

    def _alloc_lane_locked(self, fc) -> int:
        """A free lane, else the LRU lane, whose session spills its
        carry to the cache and reloads bitwise-equal on its next step."""
        if self._free:
            return self._free.pop()
        victim, lane = next(iter(self._lanes.items()))
        self._lanes.pop(victim)
        carry = fc.extract(self._slots, lane)
        self.cache.put(victim, carry, self._nbytes,
                       version=self._lane_stamp.pop(victim))
        self._lane_last_used.pop(victim, None)
        self.slot_spills += 1
        if self.cache.telemetry is not None:
            self.cache.telemetry.record_slots(spills=1)
        return lane

    def _ensure_resident_locked(self, fc, cid, hist, version) -> int:
        """Lane hit refreshes LRU (re-priming in place if the weights
        hot-swapped under the lane); otherwise the carry is resolved
        through the spill tier / history / zeros and inserted into an
        allocated lane."""
        now = self.cache._clock()
        lane = self._lanes.get(cid)
        if lane is not None:
            self._lanes.move_to_end(cid)
            self._lane_last_used[cid] = now
            if self._lane_stamp[cid] != version:
                if hist is not None:
                    _, _, carry = fc.prefill(hist[None])
                    fc.insert(self._slots, lane, carry)
                    self._lane_stamp[cid] = version
                    self.reprimes += 1
                    if self.cache.telemetry is not None:
                        self.cache.telemetry.record_reprime()
                else:
                    self.carried_across_swap += 1
            if self.cache.telemetry is not None:
                self.cache.telemetry.record_cache(True)
            return lane
        carry, stamp = self._resolve_carry(fc, cid, hist, version)
        self.cache.drop(cid)          # the lane owns the state now
        lane = self._alloc_lane_locked(fc)
        fc.insert(self._slots, lane, carry)
        self._lanes[cid] = lane
        self._lane_stamp[cid] = stamp
        self._lane_last_used[cid] = now
        self.slot_inserts += 1
        if self.cache.telemetry is not None:
            self.cache.telemetry.record_slots(inserts=1)
        return lane

    def _generate_chunk_locked(self, fc, items, chunk, version,
                               results) -> None:
        xs = np.zeros((self.num_slots, fc.feature_dim), np.float32)
        lanes = []
        for idx in chunk:
            cid, x_t, history = items[idx]
            x_t = np.asarray(x_t, np.float32)
            hist = self._clamp_history(fc, history)
            lane = self._ensure_resident_locked(fc, cid, hist, version)
            xs[lane] = x_t[0] if x_t.ndim == 2 else x_t
            lanes.append(lane)
        ys, ps, _ = fc.generate(self._slots, xs, lanes=lanes)
        for row, idx in enumerate(chunk):
            results[idx] = (float(ys[lanes[row]]), float(ps[lanes[row]]))

    def resident_clients(self) -> list[str]:
        """Client ids currently occupying a device lane."""
        with self._slots_lock:
            return list(self._lanes)

    def slot_stats(self) -> dict:
        with self._slots_lock:
            return {"lanes": self.num_slots,
                    "active": len(self._lanes),
                    "inserts": self.slot_inserts,
                    "spills": self.slot_spills,
                    "expiries": self.slot_expiries}

    def _run_waves(self, fc, items, waves, version, results) -> None:
        for wave in waves:
            xs = np.zeros((len(wave), fc.feature_dim), np.float32)
            carries, stamps = [], []
            for row, idx in enumerate(wave):
                cid, x_t, history = items[idx]
                x_t = np.asarray(x_t, np.float32)
                xs[row] = x_t[0] if x_t.ndim == 2 else x_t
                hist = self._clamp_history(fc, history)
                carry, stamp = self._resolve_carry(fc, cid, hist, version)
                carries.append(carry)
                stamps.append(stamp)
            ys, ps, new_carries = fc.step_many(xs, carries)
            for row, idx in enumerate(wave):
                self.cache.put(items[idx][0], new_carries[row], self._nbytes,
                               version=stamps[row])
                results[idx] = (float(ys[row]), float(ps[row]))
