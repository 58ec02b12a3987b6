"""The port's metrics export (``repro_torch.obs.export``) and the
telemetry history it serves, on the CPU: ``render_prometheus`` byte for
byte the JAX package's on a real port snapshot and on drawn dicts;
``EventLog``'s ring and its JSONL mirror; ``MetricsServer``'s endpoints
against a CPU engine (as ``tests/test_obs.py`` drives the reference's);
the history ring and the sampler; and the snapshot's keys, the
reference's less the counters the port does not record yet."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.obs import render_prometheus as jax_render
from repro.serving import Telemetry as JaxTelemetry
from repro_torch.models.rnn import RNNConfig, init_rnn
from repro_torch.obs import EventLog, MetricsServer, Tracer, render_prometheus
from repro_torch.serving import (BatcherConfig, LSTMForecaster,
                                 ModelRegistry, ServingEngine, Telemetry)

CFG = RNNConfig(input_dim=3, hidden=8, num_layers=1, fc_dims=(4,),
                window=8, evl_head=True)
BCFG = BatcherConfig(max_batch=4, max_wait_ms=2.0, length_buckets=(8,))
# snapshot keys of the reference the port does not record yet: the
# durable restore's and the ensembles' (ROADMAP, Mesh and durability)
NOT_PORTED_KEYS = {"restored_sessions", "restored_stale",
                   "ensemble_requests", "ensemble_alerts", "anomaly_mode"}


def _windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, CFG.window, 3)).astype(np.float32) * 0.02


@pytest.fixture(scope="module")
def registry():
    fc = LSTMForecaster(cfg=CFG, params=init_rnn(
        torch.Generator().manual_seed(0), CFG, device="cpu"), device="cpu")
    fc.calibrate(_windows(64))
    reg = ModelRegistry()
    reg.register("m", fc)
    return reg


def _wait(pred, timeout=5.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _busy_telemetry() -> Telemetry:
    tel = Telemetry()
    tel.record_batch(3, 4)
    tel.record_requests([0.001, 0.002, 0.004], version=2, staleness_s=0.5,
                        client_ids=["a", "b", None], model="m")
    tel.record_request(0.003, version=3, staleness_s=0.1)
    tel.record_swap(2)
    tel.record_cache(True)
    tel.record_step_batch([0.001, 0.002], n_padded=8, model="m")
    tel.record_slots(inserts=2, active=2, lanes=8)
    return tel


# -- render_prometheus -----------------------------------------------------

@pytest.mark.parametrize("labels", [None, {"shard": "fleet"}])
def test_render_prometheus_equals_reference_on_a_port_snapshot(labels):
    snap = _busy_telemetry().snapshot()
    text = render_prometheus(snap, prefix="repro", labels=labels)
    assert text == jax_render(snap, prefix="repro", labels=labels)
    assert "repro_swaps" in text and "# TYPE repro_requests gauge" in text
    assert text.endswith("\n")


_scalars = st.one_of(st.integers(-10**6, 10**6), st.booleans(),
                     st.floats(allow_nan=False, width=32), st.text(max_size=4),
                     st.none())
_keys = st.text(alphabet="abc_XYZ.-09", min_size=1, max_size=12)


@settings(max_examples=60, deadline=None)
@given(snap=st.dictionaries(
    st.one_of(_keys, _keys.map(lambda k: k + "_by_version")),
    st.one_of(_scalars,
              st.dictionaries(st.one_of(st.integers(0, 9), _keys), _scalars,
                              max_size=3),
              st.lists(_scalars, max_size=3)),
    max_size=6),
    labels=st.one_of(st.none(), st.dictionaries(_keys, _keys, max_size=2)),
    prefix=st.sampled_from(["repro", "port-x"]))
def test_render_prometheus_equals_reference_on_drawn_dicts(snap, labels,
                                                           prefix):
    assert render_prometheus(snap, prefix, labels) == \
        jax_render(snap, prefix, labels)


# -- EventLog --------------------------------------------------------------

def test_event_log_ring_and_jsonl(tmp_path):
    path = tmp_path / "events.jsonl"
    log = EventLog(capacity=4, path=str(path))
    for i in range(6):
        log.log("tick", i=i)
    assert len(log) == 4                     # ring bounded
    assert [e["i"] for e in log.events()] == [2, 3, 4, 5]
    assert [e["i"] for e in log.events(2)] == [4, 5]
    assert [json.loads(line)["i"] for line in
            log.lines().splitlines()] == [2, 3, 4, 5]
    log.close()
    lines = [json.loads(line) for line in
             path.read_text().strip().splitlines()]
    assert [e["i"] for e in lines] == list(range(6))   # file keeps all
    assert all(e["kind"] == "tick" and "ts" in e for e in lines)
    with pytest.raises(ValueError):
        EventLog(capacity=0)


# -- MetricsServer ---------------------------------------------------------

def test_metrics_server_endpoints(registry):
    tracer = Tracer()
    events = EventLog()
    events.log("phase", name="test")
    with ServingEngine(registry, BCFG, tracer=tracer) as eng:
        eng.warmup("m", lengths=(CFG.window,))
        eng.submit("m", _windows(1)[0]).result(timeout=10.0)
        with MetricsServer(eng.telemetry.snapshot, port=0,
                           tracer=tracer, events=events,
                           history_fn=eng.telemetry.history) as srv:
            def get(route):
                with urllib.request.urlopen(f"{srv.url}{route}",
                                            timeout=5.0) as r:
                    return r.read().decode()

            text = get("/metrics")
            assert "repro_requests 1" in text
            snap = json.loads(get("/metrics.json"))
            assert snap["requests"] == 1
            eng.telemetry.sample()
            hist = json.loads(get("/history"))
            assert len(hist) == 1 and hist[0]["requests"] == 1
            assert _wait(lambda: len(tracer.traces()) == 1)
            traces = json.loads(get("/traces"))
            assert len(traces) == 1
            spans = traces[0]["spans"]
            assert spans[0]["name"] == "submit"
            assert [s["name"] for s in spans][-1] == "reply"
            assert sorted(s["sid"] for s in spans) == list(range(len(spans)))
            assert traces[0]["op"] == "predict" and traces[0]["trace_id"]
            ev = [json.loads(line) for line in
                  get("/events").strip().splitlines()]
            assert ev[0]["name"] == "test"
            with pytest.raises(urllib.error.HTTPError):
                get("/nope")


def test_metrics_server_samples_itself_without_a_history_fn():
    tel = _busy_telemetry()
    with MetricsServer(tel.snapshot, port=0,
                       sample_interval_s=0.02) as srv:
        assert _wait(lambda: len(srv.history()) >= 2)
        with urllib.request.urlopen(f"{srv.url}/history", timeout=5.0) as r:
            hist = json.loads(r.read().decode())
    assert hist and all(h["swaps"] == 2 and "ts" in h for h in hist)
    assert srv.url.startswith("http://127.0.0.1:")


# -- telemetry history and snapshot ----------------------------------------

def test_history_ring_and_sampler():
    tel = Telemetry()
    tel.record_request(0.01)
    snap = tel.sample()
    assert "ts" in snap
    assert tel.history() == [snap]
    tel.start_sampler(interval_s=0.02)
    tel.start_sampler(interval_s=0.02)       # idempotent
    assert _wait(lambda: len(tel.history()) >= 3)
    tel.stop_sampler()
    n = len(tel.history())
    time.sleep(0.06)
    assert len(tel.history()) == n           # stopped means stopped
    assert len(tel.history(2)) == 2
    # bounded ring
    for _ in range(Telemetry.HISTORY_CAPACITY + 10):
        tel.sample()
    assert len(tel.history()) == Telemetry.HISTORY_CAPACITY
    with pytest.raises(ValueError):
        tel.start_sampler(interval_s=0.0)


def test_snapshot_keys_match_the_reference():
    port, ref = Telemetry().snapshot(), JaxTelemetry().snapshot()
    assert NOT_PORTED_KEYS <= set(ref)
    assert set(port) == set(ref) - NOT_PORTED_KEYS


def test_swaps_survive_reset_clock_and_latency_percentile():
    """As in the reference: swaps are cumulative across the measurement
    window, the request counters and reservoirs follow it."""
    port, ref = _busy_telemetry(), JaxTelemetry()
    ref.record_batch(3, 4)
    ref.record_requests([0.001, 0.002, 0.004], version=2, staleness_s=0.5,
                        client_ids=["a", "b", None], model="m")
    ref.record_request(0.003, version=3, staleness_s=0.1)
    ref.record_swap(2)
    for p in (0, 50, 95, 100):
        assert port.latency_percentile_ms(p) == ref.latency_percentile_ms(p)
    for tel in (port, ref):
        tel.reset_clock()
    snap = port.snapshot()
    assert snap["swaps"] == ref.snapshot()["swaps"] == 2
    assert snap["requests"] == 0 and snap["requests_by_version"] == {}
    assert port.latency_percentile_ms(50) == 0.0
    assert "2 swaps" in Telemetry.format(
        {**snap, "requests_by_version": {1: 3}})
