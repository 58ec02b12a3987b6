"""The port's serving stack (registry, engine, session runner) on the
CPU: results equal the port's own predict/replay bitwise, a steady step
flush is exactly one ``slots_generate``, and the served numbers match
the JAX package's engine on the same weights (allclose, rtol 1e-4 /
atol 1e-5, as the forecaster parity)."""

import jax
import numpy as np
import pytest

from repro.models.rnn import RNNConfig as JRNNConfig
from repro.models.rnn import init_rnn as jinit_rnn
from repro.serving import BatcherConfig as JBatcherConfig
from repro.serving import LSTMForecaster as JForecaster
from repro.serving import ModelRegistry as JModelRegistry
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models.rnn import RNNConfig
from repro_torch.obs import Tracer
from repro_torch.serving import (BatcherConfig, LSTMForecaster,
                                 ModelRegistry, RecurrentSessionRunner,
                                 ServingEngine, SessionCache)

W = 6
CFG_J = JRNNConfig(input_dim=5, hidden=16, num_layers=2, fc_dims=(8, 4),
                   window=W, evl_head=True)
CFG = RNNConfig(input_dim=5, hidden=16, num_layers=2, fc_dims=(8, 4),
                window=W, evl_head=True)


def _windows(n, t=W, seed=0):
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (n, t, 5))).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jparams = jinit_rnn(jax.random.PRNGKey(1), CFG_J)
    ref = JForecaster(cfg=CFG_J, params=jparams)
    ref.calibrate(_windows(64, seed=9))
    ours = LSTMForecaster(
        cfg=CFG, params=params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
        tail=dict(ref.tail), eps=ref.eps, device="cpu")
    return ref, ours


@pytest.fixture()
def registry(pair):
    reg = ModelRegistry()
    reg.register("m", pair[1])
    return reg


def test_engine_results_equal_own_predict_bitwise(registry, pair):
    _, fc = pair
    wins = _windows(8, seed=1)
    cfg = BatcherConfig(max_batch=8, max_wait_ms=60_000.0,
                        length_buckets=(W,))
    with ServingEngine(registry, cfg) as eng:
        futs = [eng.submit("m", w, client_id=f"c{i}")
                for i, w in enumerate(wins)]
        got = [f.result(timeout=10.0) for f in futs]
    y, p = fc.predict(wins)                   # the same one batch of 8
    assert got == [(float(a), float(b)) for a, b in zip(y, p)]
    assert futs[0].model_version == 1 and futs[3].client_id == "c3"
    snap = eng.telemetry.snapshot()
    assert snap["requests"] == 8 and snap["batches"] == 1


def test_engine_matches_jax_engine(pair):
    ref, ours = pair
    lengths = (6, 3, 5, 6, 2, 6)
    wins = [_windows(1, t, seed=10 + t)[0] for t in lengths]
    outs = []
    for engine_cls, cfg_cls, reg_cls, fc in (
            (ServingEngine, BatcherConfig, ModelRegistry, ours),
            (JServingEngine, JBatcherConfig, JModelRegistry, ref)):
        reg = reg_cls()
        reg.register("m", fc)
        with engine_cls(reg, cfg_cls(max_batch=8, max_wait_ms=5.0)) as eng:
            outs.append([eng.predict("m", w, timeout=30.0) for w in wins])
    np.testing.assert_allclose(np.asarray(outs[0]), np.asarray(outs[1]),
                               rtol=1e-4, atol=1e-5)


def test_one_slots_generate_per_steady_step_flush(registry, pair):
    _, fc = pair
    streams = _windows(5, seed=2)
    cfg = BatcherConfig(max_batch=64, max_wait_ms=5.0, decode_slots=16)
    tracer = Tracer(capacity=64)
    with ServingEngine(registry, cfg, tracer=tracer) as eng:
        eng.warmup("m", lengths=(W,))
        for t in range(W):
            before = eng.telemetry.step_batches
            with dispatch.counting() as counts:
                futs = [eng.submit_step("m", f"s{c}", streams[c, t])
                        for c in range(5)]
                last = [f.result(timeout=10.0) for f in futs]
            flushes = eng.telemetry.step_batches - before
            assert counts["slots_generate"] == flushes >= 1
            assert counts["decode_many"] == 0 and counts["decode_step"] == 0
            if t > 0:       # steady state: every session already resident
                assert counts["slots_insert"] == 0
        stats = eng.slot_stats()
        assert eng.session_clients() == [f"s{c}" for c in range(5)]
    assert stats["active"] == 5 and stats["inserts"] == 5
    assert tracer.stats()["finished"] == 5 * W
    y, p, _ = fc.replay(streams)
    assert last == [(float(a), float(b)) for a, b in zip(y, p)]


def test_spilled_sessions_reload_bitwise_and_match_slotless(pair):
    _, fc = pair
    streams = _windows(12, seed=3)
    slotted = RecurrentSessionRunner(fc, num_slots=8)      # 12 > 8 lanes
    slotless = RecurrentSessionRunner(fc, num_slots=0)
    for t in range(W):
        items = [(f"c{c}", streams[c, t], None) for c in range(12)]
        a = slotted.step_many(items)
        b = slotless.step_many(items)
        assert a == b
    assert slotted.slot_spills > 0 and slotted.num_slots == 8
    y, p, _ = fc.replay(streams)
    assert a == [(float(u), float(v)) for u, v in zip(y, p)]
    assert len(slotted.resident_clients()) == 8
    assert len(slotted.cache) == 4            # the spill tier


def test_runner_history_miss_reprime_and_duplicates(pair):
    _, fc = pair
    x = _windows(1, seed=4)[0]
    runner = RecurrentSessionRunner(fc, cache=SessionCache(max_sessions=4))
    # a miss with history replays it: the step equals the full replay
    got = runner.step("c", x[-1], history=x[:-1])
    y, p, _ = fc.replay(x[None])
    assert got == (float(y[0]), float(p[0]))
    # duplicate ids in one batch run in order, one wave each
    fresh = RecurrentSessionRunner(fc)
    out = fresh.step_many([("d", x[0], None), ("d", x[1], None)])
    y2, p2, _ = fc.replay(x[None, :2])
    assert out[1] == (float(y2[0]), float(p2[0]))
    with pytest.raises(KeyError):
        RecurrentSessionRunner(fc, on_miss="error", num_slots=0).step(
            "e", x[0])


def test_bucket_len_clamps_over_long_windows(registry, pair):
    _, fc = pair
    cfg = BatcherConfig(max_batch=4, max_wait_ms=1.0, length_buckets=(4,))
    assert cfg.bucket_len(9) == 4 and cfg.bucket_len(3) == 4
    assert BatcherConfig(length_buckets=()).bucket_len(3) == 8
    assert BatcherConfig(max_batch=12).max_batch == 8
    long = _windows(1, t=9, seed=5)[0]
    with ServingEngine(registry, cfg) as eng:
        got = eng.predict("m", long, timeout=10.0)
        with pytest.raises(ValueError, match="expects windows"):
            eng.submit("m", long[:, :3])
        with pytest.raises(ValueError, match="client_id"):
            eng.submit_step("m", None, long[0])
    y, p = fc.predict(long[None, -4:])          # causal: newest 4 rows
    assert got == (float(y[0]), float(p[0]))
    with pytest.raises(RuntimeError, match="not running"):
        eng.submit("m", long)


def test_registry_versions_and_swap(pair):
    _, fc = pair
    reg = ModelRegistry()
    seen = []
    reg.subscribe(lambda k, v: seen.append((k, v)))
    reg.register("m", fc)
    assert reg.version("m") == 1 and "m" in reg and reg.keys() == ["m"]
    v = reg.swap("m", fc.with_params(fc.params))
    assert v == 2 and reg.get_entry("m").version == 2
    assert reg.get("m").version == 2 and reg.swap_count == 1
    assert seen == [("m", 1), ("m", 2)]
    with pytest.raises(ValueError, match="monotonically"):
        reg.register("m", fc, version=1)
    with pytest.raises(KeyError):
        reg.swap("other", fc)
