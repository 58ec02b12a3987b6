"""Multi-model hosting: forecasters keyed by name, with atomic weight
hot-swapping.

Versioning: every key carries a monotonically increasing model version.
``register`` publishes version 1 (or bumps an existing key); ``swap``
atomically replaces the hosted forecaster and returns the new version.
Readers (``get``) take one reference under the lock, so an in-flight
micro-batch that already resolved its forecaster keeps serving the old
weights while the next flush picks up the new ones.

Ensembles, checkpoint save/load and the durable store of
``repro.serving.registry`` wait for later slices of the port.
"""

from __future__ import annotations

import threading
import time
from typing import Any, NamedTuple


class RegistryEntry(NamedTuple):
    """Immutable snapshot of one hosted model."""

    forecaster: Any
    version: int
    published_at: float


class ModelRegistry:
    """Thread-safe name -> forecaster map used by the serving engine."""

    def __init__(self, clock=time.perf_counter):
        self._lock = threading.Lock()
        self._clock = clock
        self._entries: dict[str, RegistryEntry] = {}
        self._subscribers: list = []
        self.swap_count = 0

    def subscribe(self, callback) -> None:
        """Register ``callback(key, version)`` to run after every
        publication (register/swap), outside the registry lock, on the
        publishing thread."""
        with self._lock:
            self._subscribers.append(callback)

    def _notify(self, key: str, version: int) -> None:
        with self._lock:
            subscribers = list(self._subscribers)
        for fn in subscribers:
            fn(key, version)

    def _publish_locked(self, key: str, forecaster,
                        version: int | None) -> int:
        cur = self._entries.get(key)
        floor = cur.version if cur is not None else 0
        new_version = version if version is not None else floor + 1
        if new_version <= floor:
            raise ValueError(
                f"model version must increase monotonically: {key!r} is at "
                f"v{floor}, refusing v{new_version}")
        now = self._clock()
        try:
            # stamp before publication so readers never see a torn entry
            forecaster.version = new_version
            forecaster.published_at = now
        except AttributeError:
            pass                 # duck-typed stand-ins without attributes
        self._entries[key] = RegistryEntry(forecaster, new_version, now)
        return new_version

    def register(self, key: str, forecaster, version: int | None = None):
        """Host ``forecaster`` under ``key`` (bumping the version if the
        key already exists). Returns the forecaster."""
        with self._lock:
            v = self._publish_locked(key, forecaster, version)
        self._notify(key, v)
        return forecaster

    def swap(self, key: str, forecaster, version: int | None = None) -> int:
        """Atomically replace the forecaster hosted at ``key`` (which
        must exist). Returns the new, monotonically increased version."""
        with self._lock:
            if key not in self._entries:
                raise KeyError(f"cannot swap unknown model {key!r}; "
                               f"hosted: {sorted(self._entries)}")
            v = self._publish_locked(key, forecaster, version)
            self.swap_count += 1
        self._notify(key, v)
        return v

    def get(self, key: str):
        return self.get_entry(key).forecaster

    def get_entry(self, key: str) -> RegistryEntry:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                raise KeyError(f"unknown model {key!r}; hosted: "
                               f"{sorted(self._entries)}")
            return entry

    def version(self, key: str) -> int:
        return self.get_entry(key).version

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries
