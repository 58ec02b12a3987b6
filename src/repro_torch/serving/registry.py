"""Multi-model hosting: forecasters keyed by name, with atomic weight
hot-swapping and checkpoint save/load through
``repro_torch.checkpoint.io`` (the forecaster's config, EVT tail
calibration, indicator thresholds and model version ride along as
metadata, so a loaded model serves identically to the one that was
saved, and a checkpoint of the JAX package's registry loads here).

Versioning: every key carries a monotonically increasing model version.
``register`` publishes version 1 (or bumps an existing key); ``swap``
atomically replaces the hosted forecaster and returns the new version.
Readers (``get``) take one reference under the lock, so an in-flight
micro-batch that already resolved its forecaster keeps serving the old
weights while the next flush picks up the new ones.

Ensembles and the durable store of ``repro.serving.registry`` wait for
later slices of the port.
"""

from __future__ import annotations

import threading
import time
from typing import Any, NamedTuple

from repro_torch.checkpoint.io import (assemble, dump_checkpoint_bytes,
                                       load_checkpoint, load_checkpoint_bytes,
                                       save_checkpoint)
from repro_torch.device import resolve_device
from repro_torch.models.rnn import RNNConfig, init_rnn
from repro_torch.serving.forecaster import LSTMForecaster, ZooForecaster


class RegistryEntry(NamedTuple):
    """Immutable snapshot of one hosted model."""

    forecaster: Any
    version: int
    published_at: float


def _rnn_cfg_meta(cfg: RNNConfig) -> dict:
    return {"input_dim": cfg.input_dim, "hidden": cfg.hidden,
            "num_layers": cfg.num_layers, "fc_dims": list(cfg.fc_dims),
            "window": cfg.window, "evl_head": cfg.evl_head}


def _rnn_cfg_from_meta(m: dict) -> RNNConfig:
    return RNNConfig(input_dim=m["input_dim"], hidden=m["hidden"],
                     num_layers=m["num_layers"],
                     fc_dims=tuple(m["fc_dims"]), window=m["window"],
                     evl_head=m["evl_head"])


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

    def unsubscribe(self, callback) -> bool:
        """Detach a subscriber; returns whether it was subscribed."""
        with self._lock:
            try:
                self._subscribers.remove(callback)
                return True
            except ValueError:
                return False

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

    def unregister(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)

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

    def items(self) -> list[tuple[str, Any]]:
        """Snapshot of (key, forecaster) pairs taken under the lock: safe
        to iterate while other threads register, unregister or swap."""
        with self._lock:
            return [(k, e.forecaster)
                    for k, e in sorted(self._entries.items())]

    def entries(self) -> list[tuple[str, RegistryEntry]]:
        """Snapshot of (key, entry) pairs, the same contract as
        ``items``."""
        with self._lock:
            return sorted(self._entries.items())

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- persistence -------------------------------------------------------
    def _save_meta(self, key: str):
        """(forecaster, checkpoint metadata) for the hosted ``key``."""
        entry = self.get_entry(key)
        fc = entry.forecaster
        meta: dict = {"kind": fc.kind, "tail": fc.tail, "gamma": fc.gamma,
                      "version": entry.version}
        if fc.kind == "lstm":
            meta["cfg"] = _rnn_cfg_meta(fc.cfg)
            meta["eps"] = list(fc.eps)
        elif fc.kind == "zoo":
            name = fc.cfg.name
            meta["reduced"] = name.endswith("-smoke")
            meta["arch"] = name[:-len("-smoke")] if meta["reduced"] else name
        else:
            raise ValueError(f"cannot persist forecaster kind {fc.kind!r}")
        return fc, meta

    def save(self, key: str, path: str) -> None:
        fc, meta = self._save_meta(key)
        save_checkpoint(path, fc.params, metadata=meta)

    def save_bytes(self, key: str) -> bytes:
        """The hosted model as in-memory checkpoint bytes (config, EVT
        calibration and version ride along)."""
        fc, meta = self._save_meta(key)
        return dump_checkpoint_bytes(fc.params, metadata=meta)

    def _rebuild(self, flat, meta, origin: str, device):
        """The forecaster a checkpoint describes, on ``device``. The
        target nest comes from the port's init on the meta device (no
        weights drawn), so each leaf takes the init's dtype: a bf16
        model keeps ``dt_bias``/``A_log`` in fp32."""
        if not meta or "kind" not in meta:
            raise ValueError(f"{origin}: not a serving checkpoint (no kind "
                             "metadata)")
        kind = meta["kind"]
        if kind == "lstm":
            cfg = _rnn_cfg_from_meta(meta["cfg"])
            params = assemble(flat, init_rnn(None, cfg, device="meta"),
                              device)
            fc = LSTMForecaster(cfg=cfg, params=params,
                                tail=meta.get("tail"),
                                eps=tuple(meta.get("eps", (0.01, 0.01))),
                                gamma=meta.get("gamma", 5.0), device=device)
        elif kind == "zoo":
            from repro_torch.configs import get_config
            from repro_torch.configs.base import reduced as reduce_cfg
            from repro_torch.models.transformer import init_lm

            acfg = get_config(meta["arch"])
            if meta.get("reduced"):
                acfg = reduce_cfg(acfg)
            params = assemble(flat, init_lm(acfg, None), device)
            fc = ZooForecaster(cfg=acfg, params=params,
                               tail=meta.get("tail"),
                               gamma=meta.get("gamma", 5.0), device=device)
        else:
            raise ValueError(f"{origin}: unknown forecaster kind {kind!r}")
        fc.version = int(meta.get("version", 0))
        return fc

    def _register_loaded(self, fc, key: str | None):
        if key is not None:
            with self._lock:
                cur = self._entries.get(key)
                saved = fc.version or None
                if cur is not None and saved is not None \
                        and saved <= cur.version:
                    saved = None     # key moved on: fall back to a bump
                v = self._publish_locked(key, fc, saved)
            self._notify(key, v)
        return fc

    def load(self, path: str, key: str | None = None, device="cuda"):
        """Rebuild a forecaster on ``device`` from a checkpoint and
        (optionally) register it under ``key`` at the saved version (or
        the next monotone version if the key has already moved past it).
        Returns the forecaster."""
        flat, meta = load_checkpoint(path)
        return self._register_loaded(
            self._rebuild(flat, meta, path, resolve_device(device)), key)

    def load_bytes(self, data: bytes, key: str | None = None,
                   device="cuda"):
        """``load`` for in-memory checkpoint bytes (``save_bytes``
        output)."""
        flat, meta = load_checkpoint_bytes(data)
        return self._register_loaded(
            self._rebuild(flat, meta, "<bytes>", resolve_device(device)),
            key)
