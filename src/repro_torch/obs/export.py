"""Metrics export: Prometheus text exposition, JSONL event logs, and a
tiny stdlib HTTP endpoint serving both (a copy of ``repro.obs.export``:
stdlib only, and the port imports nothing of the JAX package).

- ``render_prometheus(snapshot)`` flattens a ``Telemetry.snapshot()``
  dict (or any numeric dict) into the text exposition format: scalars
  become gauges, ``*_by_<label>`` dicts/lists become labeled series.
- ``EventLog`` is a bounded ring of timestamped JSON events with an
  optional append-to-file mirror.
- ``MetricsServer`` serves ``/metrics`` (Prometheus), ``/metrics.json``
  (raw snapshot), ``/history`` (the sampled time series), ``/traces``
  (the tracer's completed ring) and ``/events`` (the JSONL log) from a
  daemon ``ThreadingHTTPServer``: ``--metrics-port`` on the online CLI.

Everything here is off the serving hot path: rendering happens per
scrape, sampling on its own thread.
"""

from __future__ import annotations

import json
import re
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(prefix: str, key: str) -> str:
    return _NAME_RE.sub("_", f"{prefix}_{key}")


def _fmt_labels(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_NAME_RE.sub("_", str(k))}="{v}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _label_for(key: str) -> str:
    # requests_by_version -> "version", requests_by_shard -> "shard";
    # anything else labels by the generic "key"
    m = re.search(r"_by_([a-z0-9]+)$", key)
    return m.group(1) if m else "key"


def render_prometheus(snapshot: dict, prefix: str = "repro",
                      labels: dict | None = None) -> str:
    """One snapshot as Prometheus text exposition. Scalars (int, float,
    bool) become gauges; dict values one labeled series per entry; list
    values one series per index (labeled by ``_by_<x>`` when the key
    names one). Non-numeric values are skipped."""
    base = _fmt_labels(labels)
    lines: list[str] = []

    def emit(name: str, value, extra: dict | None = None) -> None:
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            return
        lab = dict(labels or {})
        if extra:
            lab.update(extra)
        lines.append(f"{name}{_fmt_labels(lab) if lab else base} "
                     f"{float(value):g}")

    for key in sorted(snapshot):
        value = snapshot[key]
        name = _metric_name(prefix, key)
        if isinstance(value, dict):
            lines.append(f"# TYPE {name} gauge")
            label = _label_for(key)
            for k in sorted(value, key=str):
                emit(name, value[k], {label: k})
        elif isinstance(value, (list, tuple)):
            lines.append(f"# TYPE {name} gauge")
            label = _label_for(key)
            for i, v in enumerate(value):
                emit(name, v, {label: i})
        elif isinstance(value, (bool, int, float)):
            lines.append(f"# TYPE {name} gauge")
            emit(name, value)
    return "\n".join(lines) + "\n"


class EventLog:
    """Bounded ring of timestamped events, optionally mirrored to a
    JSONL file (append-only, flushed per event — the log must survive a
    crash of the process it is diagnosing)."""

    def __init__(self, capacity: int = 4096, path: str | None = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=capacity)
        self._file = open(path, "a") if path else None
        self.path = path

    def log(self, kind: str, **fields) -> dict:
        event = {"ts": time.time(), "kind": kind, **fields}
        with self._lock:
            self._events.append(event)
            if self._file is not None:
                self._file.write(json.dumps(event) + "\n")
                self._file.flush()
        return event

    def events(self, n: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._events)
        return out if n is None else out[-n:]

    def lines(self) -> str:
        return "".join(json.dumps(e) + "\n" for e in self.events())

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


class MetricsServer:
    """Stdlib HTTP endpoint over a snapshot callable.

    ``snapshot_fn`` is whatever produces the current metrics dict —
    ``engine.telemetry.snapshot`` for one engine, ``engine.snapshot``
    for a mesh (the merged fleet view). ``history_fn`` serves the
    sampled time series (``Telemetry.history`` for one engine); when
    omitted but ``sample_interval_s`` is set, the server samples
    ``snapshot_fn`` itself on a daemon thread. ``tracer`` and ``events``
    expose the trace ring and the event log when given."""

    def __init__(self, snapshot_fn, host: str = "127.0.0.1",
                 port: int = 0, prefix: str = "repro",
                 labels: dict | None = None, tracer=None,
                 history_fn=None, events: EventLog | None = None,
                 sample_interval_s: float | None = None,
                 history_capacity: int = 512):
        self.snapshot_fn = snapshot_fn
        self.host = host
        self.port = port
        self.prefix = prefix
        self.labels = labels
        self.tracer = tracer
        self.events = events
        self._history_fn = history_fn
        self._history: deque[dict] = deque(maxlen=history_capacity)
        self._interval = sample_interval_s
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._sampler: threading.Thread | None = None
        self._stop = threading.Event()

    # -- content -----------------------------------------------------------
    def history(self) -> list[dict]:
        if self._history_fn is not None:
            return list(self._history_fn())
        return list(self._history)

    def _sample_loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                snap = dict(self.snapshot_fn())
                snap["ts"] = time.time()
                self._history.append(snap)
            except Exception:  # noqa: BLE001 — sampling must not kill serving
                pass

    def _routes(self) -> dict:
        return {
            "/metrics": lambda: ("text/plain; version=0.0.4",
                                 render_prometheus(self.snapshot_fn(),
                                                   self.prefix,
                                                   self.labels)),
            "/metrics.json": lambda: (
                "application/json", json.dumps(self.snapshot_fn())),
            "/history": lambda: (
                "application/json", json.dumps(self.history())),
            "/traces": lambda: ("application/json", json.dumps(
                [t.to_dict() for t in self.tracer.traces()]
                if self.tracer is not None else [])),
            "/events": lambda: (
                "application/x-ndjson",
                self.events.lines() if self.events is not None else ""),
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API name
                route = server._routes().get(self.path.split("?")[0])
                if route is None:
                    self.send_error(404)
                    return
                try:
                    ctype, body = route()
                except Exception as e:  # noqa: BLE001 — scrape, not serving
                    self.send_error(500, f"{type(e).__name__}: {e}")
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):  # quiet: scrapes are not news
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()
        if self._interval is not None and self._history_fn is None:
            self._stop.clear()
            self._sampler = threading.Thread(target=self._sample_loop,
                                             name="metrics-sampler",
                                             daemon=True)
            self._sampler.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._sampler is not None:
            self._sampler.join()
            self._sampler = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
