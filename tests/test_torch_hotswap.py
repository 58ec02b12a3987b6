"""The port's weight hot-swapping (``repro_torch.serving.hotswap`` and
the registry's listing surface) on the CPU: every test of
``tests/test_hotswap.py`` mirrored on the port (atomic swaps under
concurrent serving, version attribution, staleness telemetry, the
stop-the-world baseline, the publisher's recalibration and rate limit,
session carries across swaps, the registry listing race), less
``test_checkpoint_version_roundtrip``, which
``tests/test_torch_registry_persistence.py``'s
``test_lstm_round_trip_keeps_config_calibration_and_version`` mirrors.
Then two parity tests against the JAX package: its ``WeightPublisher``
and the port's fed the same params and calibration windows, and its
``train_rnn_local_sgd(round_callback=publisher)`` beside the port's."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.data import load_stock, make_windows, train_test_split
from repro.models import rnn as jrnn
from repro.serving import LSTMForecaster as JaxForecaster
from repro.serving import ModelRegistry as JaxRegistry
from repro.serving import WeightPublisher as JaxPublisher
from repro.training import loop as jloop
from repro_torch.checkpoint.convert import (params_from_numpy,
                                           params_to_numpy, stack_workers)
from repro_torch.models.rnn import RNNConfig, init_rnn
from repro_torch.serving import (BatcherConfig, LSTMForecaster,
                                 ModelRegistry, RecurrentSessionRunner,
                                 ServingEngine, SessionCache,
                                 WeightPublisher, stop_the_world_swap)
from repro_torch.training import loop
from repro_torch.tree import tree_leaves, tree_map

CFG = RNNConfig(input_dim=3, hidden=8, num_layers=1, fc_dims=(4,),
                window=8, evl_head=True)
# the calibration's tail and eps against the JAX package's, as
# tests/test_torch_extreme.py holds fit_tail
CAL_RTOL, CAL_ATOL = 1e-5, 1e-6
# published params against the JAX package's after the same rounds, as
# tests/test_torch_local_sgd.py holds the trainer's
RTOL, ATOL = 1e-5, 1e-6


def _params(seed: int, scale: float = 1.0):
    p = init_rnn(torch.Generator().manual_seed(seed), CFG, device="cpu")
    if scale != 1.0:
        p = tree_map(lambda a: a * scale, p)
    return p


def _forecaster(seed: int = 0) -> LSTMForecaster:
    fc = LSTMForecaster(cfg=CFG, params=_params(seed), device="cpu")
    rng = np.random.default_rng(seed)
    fc.calibrate(rng.standard_normal((32, CFG.window, 3)).astype(np.float32)
                 * 0.02)
    return fc


def _windows(n, t=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, t, 3)).astype(np.float32) * 0.02


# -- registry versioning ---------------------------------------------------

def test_register_and_swap_bump_versions_monotonically():
    reg = ModelRegistry()
    fc1, fc2, fc3 = _forecaster(0), _forecaster(1), _forecaster(2)
    reg.register("m", fc1)
    assert reg.version("m") == 1 and fc1.version == 1
    assert reg.swap("m", fc2) == 2
    assert reg.get("m") is fc2 and fc2.published_at is not None
    # explicit versions must still increase
    assert reg.swap("m", fc3, version=7) == 7
    with pytest.raises(ValueError):
        reg.swap("m", fc1, version=7)
    with pytest.raises(KeyError):
        reg.swap("nope", fc1)
    assert reg.swap_count == 2
    # re-register of an existing key keeps the monotone sequence
    reg.register("m", fc1)
    assert reg.version("m") == 8


def test_registry_entry_snapshot_and_len():
    reg = ModelRegistry()
    seen = []

    def on_publish(key, version):
        seen.append((key, version))

    reg.subscribe(on_publish)
    reg.register("a", _forecaster(0))
    reg.register("b", _forecaster(1))
    assert len(reg) == 2
    entries = dict(reg.entries())
    assert entries["a"].version == 1
    assert [k for k, _ in reg.items()] == ["a", "b"]
    assert seen == [("a", 1), ("b", 1)]
    # a detached subscriber hears nothing more; detaching twice is a no-op
    assert reg.unsubscribe(on_publish) is True
    assert reg.unsubscribe(on_publish) is False
    reg.swap("a", _forecaster(2))
    assert seen == [("a", 1), ("b", 1)]
    reg.unregister("a")
    reg.unregister("a")                     # unknown key: a no-op
    assert len(reg) == 1 and "a" not in reg


def test_registry_listing_race_register_unregister():
    """register/unregister/swap from other threads must never make a
    hosted-model listing raise (listings are snapshots under the lock)."""
    reg = ModelRegistry()
    for i in range(8):
        reg.register(f"m{i}", _forecaster(0))
    stop = threading.Event()
    errors: list[BaseException] = []

    def churn(seed: int) -> None:
        rng = np.random.default_rng(seed)
        fc = _forecaster(0)
        try:
            while not stop.is_set():
                i = int(rng.integers(0, 8))
                op = int(rng.integers(0, 3))
                if op == 0:
                    reg.register(f"m{i}", fc)
                elif op == 1:
                    reg.unregister(f"m{i}")
                else:
                    try:
                        reg.swap(f"m{i}", fc)
                    except KeyError:
                        pass       # unregistered by the other thread: fine
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=churn, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    try:
        deadline = time.perf_counter() + 1.0
        while time.perf_counter() < deadline:
            for key, fc in reg.items():        # snapshot: safe to iterate
                assert isinstance(key, str)
            for key, entry in reg.entries():
                assert entry.version >= 1
            reg.keys()
            try:
                reg.get("m0")
            except KeyError:
                pass               # unregistered is a valid outcome,
                # a RuntimeError from mutation-during-iteration is not
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors


# -- swap semantics under the engine ---------------------------------------

def test_flush_serves_swapped_weights_and_attributes_version():
    """A flush that starts before a swap serves the old weights; the next
    flush serves the new ones, and every future says which version."""
    reg = ModelRegistry()
    fc1 = _forecaster(0)
    reg.register("m", fc1)
    w = _windows(1)[0]
    cfg = BatcherConfig(max_batch=4, max_wait_ms=1.0, length_buckets=(8,))
    with ServingEngine(reg, cfg) as eng:
        f1 = eng.submit("m", w)
        y1, _ = f1.result(timeout=10.0)
        fc2 = fc1.with_params(_params(1))
        assert fc2.version == 0            # unpublished until swapped
        assert reg.swap("m", fc2) == 2
        f2 = eng.submit("m", w)
        y2, _ = f2.result(timeout=10.0)
    assert f1.model_version == 1 and f2.model_version == 2
    # different weights, different forecast (same input)
    y1_ref, _ = fc1.predict(w[None])
    y2_ref, _ = fc2.predict(w[None])
    assert y1 == float(y1_ref[0]) and y2 == float(y2_ref[0])
    assert y1 != y2
    snap = eng.telemetry.snapshot()
    assert snap["requests_by_version"] == {1: 1, 2: 1}
    assert snap["staleness_p95_s"] >= 0.0


def test_hotswap_storm_drops_nothing_and_attributes_every_response():
    """One thread swapping weights every few ms while N threads predict:
    zero dropped or failed requests, every response attributable to a
    registered version, a consistent final registry."""
    reg = ModelRegistry()
    fc0 = _forecaster(0)
    reg.register("m", fc0)
    variants = [_params(0, scale=1.0 + 0.1 * i) for i in range(3)]

    cfg = BatcherConfig(max_batch=8, max_wait_ms=1.0, length_buckets=(8,))
    eng = ServingEngine(reg, cfg)
    publisher = WeightPublisher(reg, "m", template=fc0,
                                telemetry=eng.telemetry)
    n_threads, n_requests = 4, 30
    results: dict[int, list] = {i: [] for i in range(n_threads)}
    errors: list[BaseException] = []
    stop = threading.Event()

    def swapper() -> None:
        i = 0
        try:
            while not stop.is_set() and i < 2000:
                publisher.publish(variants[i % len(variants)])
                i += 1
                time.sleep(0.002)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    with eng:
        eng.warmup("m", lengths=(8,))
        eng.telemetry.reset_clock()

        def client(tid: int) -> None:
            try:
                for j in range(n_requests):
                    fut = eng.submit("m", _windows(1, seed=tid * 100 + j)[0])
                    y, p = fut.result(timeout=30.0)
                    results[tid].append((y, p, fut.model_version))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        sw = threading.Thread(target=swapper, name="swapper")
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        sw.start()
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        stop.set()
        sw.join()
        snap = eng.telemetry.snapshot()

    assert not errors                       # zero dropped/failed requests
    total = sum(len(r) for r in results.values())
    assert total == n_threads * n_requests
    final_version = reg.version("m")
    assert publisher.published >= 1
    assert final_version == publisher.last_version
    for r in results.values():
        for y, p, version in r:
            assert np.isfinite(y) and 0.0 <= p <= 1.0
            assert isinstance(version, int) and 1 <= version <= final_version
    # telemetry accounted every engine-served request to some version
    assert sum(snap["requests_by_version"].values()) == total
    assert snap["swaps"] == publisher.published
    # the hosted forecaster carries the version the registry reports
    entry = reg.get_entry("m")
    assert entry.forecaster.version == entry.version == final_version


def test_stop_the_world_swap_rejects_requests_while_stopped():
    """The baseline the hot swap replaces: engine halted around the
    weight update, so a submit in that window is a dropped request."""
    reg = ModelRegistry()
    fc = _forecaster(0)
    reg.register("m", fc)
    eng = ServingEngine(reg, BatcherConfig(max_batch=2, max_wait_ms=1.0,
                                           length_buckets=(8,)))
    eng.start()
    try:
        assert eng.predict("m", _windows(1)[0], timeout=10.0)
        eng.stop()
        with pytest.raises(RuntimeError):
            eng.submit("m", _windows(1)[0])    # the dropped request
        eng.start()
        v = stop_the_world_swap(eng, reg, "m", fc.with_params(_params(1)))
        assert v == 2
        fut = eng.submit("m", _windows(1)[0])
        fut.result(timeout=10.0)
        assert fut.model_version == 2
    finally:
        eng.stop()


# -- publisher -------------------------------------------------------------

def test_publisher_recalibrates_tail_on_publish():
    reg = ModelRegistry()
    fc0 = _forecaster(0)
    reg.register("m", fc0)
    calib = _windows(32, seed=5)
    pub = WeightPublisher(reg, "m", calib_windows=calib)
    v = pub.publish(_params(1))
    fc1 = reg.get("m")
    assert v == 2 and fc1.version == 2
    assert fc1.tail is not None
    # calibration ran on the *new* weights' forecast distribution
    expect = fc0.with_params(_params(1)).calibrate(calib).tail
    assert fc1.tail == pytest.approx(expect)


def test_publisher_rate_limit_and_first_publish_registers():
    reg = ModelRegistry()
    template = _forecaster(0)
    pub = WeightPublisher(reg, "m", template=template, min_interval_s=60.0)
    assert "m" not in reg
    assert pub.publish(_params(1), round_idx=1) == 1   # registers key
    assert "m" in reg and pub.last_round == 1
    assert pub.publish(_params(2), round_idx=2) is None  # rate-limited
    assert pub.skipped == 1 and reg.version("m") == 1
    # tail/eps carried over from the template when not recalibrating
    assert reg.get("m").tail == pytest.approx(template.tail)
    # flush publishes the freshest rate-limited round (the trained final
    # weights are never left behind the served ones), then clears it
    assert pub.flush() == 2
    assert reg.version("m") == 2 and pub.last_round == 2
    y_flush, _ = reg.get("m").predict(_windows(2))
    y_want, _ = template.with_params(_params(2)).predict(_windows(2))
    np.testing.assert_array_equal(y_flush, y_want)
    assert pub.flush() is None


def test_publish_stacked_publishes_the_worker_mean():
    """Trainer-side params [W, ...] publish as their worker mean (the
    paper's model exchange), as the JAX package's ``publish_stacked``."""
    reg = ModelRegistry()
    reg.register("m", _forecaster(0))
    stacked = stack_workers(_params(1), 3)
    stacked = tree_map(lambda a: a * torch.arange(
        1.0, 4.0).reshape((3,) + (1,) * (a.dim() - 1)), stacked)
    pub = WeightPublisher(reg, "m")
    assert pub.publish_stacked(stacked, round_idx=5) == 2
    assert pub.last_round == 5
    for got, want in zip(tree_leaves(reg.get("m").params),
                         tree_leaves(_params(1))):
        torch.testing.assert_close(got, 2.0 * want, rtol=1e-6, atol=0)


# -- sessions across swaps -------------------------------------------------

def test_session_carry_reprimes_with_history_after_swap():
    """A live session must survive a hot swap: with history the carry is
    replayed through the new weights (numbers match a fresh replay)."""
    reg = ModelRegistry()
    fc1 = _forecaster(0)
    reg.register("m", fc1)
    runner = RecurrentSessionRunner(lambda: reg.get("m"),
                                    SessionCache(max_sessions=4))
    w = _windows(1, seed=9)[0]
    half = CFG.window // 2
    for t in range(half):
        runner.step("c", w[t])

    fc2 = fc1.with_params(_params(1))
    reg.swap("m", fc2)
    for t in range(half, CFG.window):
        y_live, _ = runner.step("c", w[t], history=w[:t])
    assert runner.reprimes == 1             # re-primed once, then v2 carry

    # reference: the same stream served on v2 from scratch
    runner2 = RecurrentSessionRunner(fc2, SessionCache(max_sessions=4))
    for t in range(CFG.window):
        y_ref, _ = runner2.step("c2", w[t])
    assert y_live == y_ref


def test_session_carry_survives_swap_without_history():
    """Without history the carry is kept (not dropped): serving continues
    on the new weights, and the carry stays marked stale so history
    arriving on ANY later step still triggers the lazy re-prime."""
    reg = ModelRegistry()
    fc1 = _forecaster(0)
    reg.register("m", fc1)
    runner = RecurrentSessionRunner(lambda: reg.get("m"),
                                    SessionCache(max_sessions=4))
    w = _windows(1, seed=11)[0]
    for t in range(4):
        runner.step("c", w[t])
    fc2 = fc1.with_params(_params(2))
    reg.swap("m", fc2)
    y, p = runner.step("c", w[4])           # no history: must not raise
    assert np.isfinite(y) and 0.0 <= p <= 1.0
    assert runner.carried_across_swap == 1
    runner.step("c", w[5])                  # still no history: still stale
    assert runner.carried_across_swap == 2 and runner.reprimes == 0
    # history finally arrives -> re-primed through the new weights,
    # bitwise equal to a v2-only session from scratch
    y_live, _ = runner.step("c", w[6], history=w[:6])
    assert runner.reprimes == 1
    runner.step("c", w[7])
    assert runner.carried_across_swap == 2  # current again: no more carries
    runner2 = RecurrentSessionRunner(fc2, SessionCache(max_sessions=4))
    y_ref = None
    for t in range(7):
        y_ref, _ = runner2.step("c2", w[t])
    assert y_live == y_ref


# -- parity with the JAX package -------------------------------------------

JCFG = jrnn.RNNConfig(input_dim=3, hidden=8, num_layers=1, fc_dims=(4,),
                      window=8, evl_head=True)


def _jax_params(seed: int):
    return jrnn.init_rnn(jax.random.PRNGKey(seed), JCFG)


def _to_port(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


def _assert_tail_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=CAL_RTOL,
                                   atol=CAL_ATOL, err_msg=k)


def test_publisher_matches_jax_publisher():
    """The same series of params, converted, and the same calibration
    windows through both publishers: the same versions, and each
    version's tail and eps within fit_tail's tolerance of the JAX
    package's."""
    calib = _windows(64, seed=3) * 10.0
    jreg, treg = JaxRegistry(), ModelRegistry()
    jreg.register("m", JaxForecaster(cfg=JCFG, params=_jax_params(0)))
    treg.register("m", LSTMForecaster(cfg=CFG, params=_to_port(
        _jax_params(0)), device="cpu"))
    jpub = JaxPublisher(jreg, "m", calib_windows=calib)
    tpub = WeightPublisher(treg, "m", calib_windows=calib)
    for r, seed in enumerate((1, 2, 3, 4), start=1):
        jp = _jax_params(seed)
        assert tpub(r, _to_port(jp)) == jpub(r, jp) == r + 1
        jfc, tfc = jreg.get("m"), treg.get("m")
        assert tfc.version == jfc.version == r + 1
        _assert_tail_close(tfc.tail, jfc.tail)
        np.testing.assert_allclose(tfc.eps, jfc.eps, rtol=CAL_RTOL,
                                   atol=CAL_ATOL)
    assert (tpub.published, tpub.skipped, tpub.last_round) == \
        (jpub.published, jpub.skipped, jpub.last_round) == (4, 0, 4)


TCFG = RNNConfig(input_dim=5, hidden=12, num_layers=2, fc_dims=(8, 4),
                 window=6, evl_head=True)
TJCFG = jrnn.RNNConfig(input_dim=5, hidden=12, num_layers=2, fc_dims=(8, 4),
                       window=6, evl_head=True)


def _published(registry, to_numpy):
    """(version, numpy params) of every publication from now on."""
    out = []

    def on_publish(key, version):
        out.append((version, to_numpy(registry.get(key).params)))

    registry.subscribe(on_publish)
    return out


def test_training_rounds_publish_like_the_jax_package():
    """``train_rnn_local_sgd(round_callback=publisher)`` in both packages,
    from the JAX init, W = 2, 40 iterations, EVL 0.5: the same number
    of publishes and versions, every published version's params within
    the local-SGD tolerance of the JAX package's."""
    tr, te = train_test_split(load_stock("AAPL", n_days=260, seed=0))
    train_ds, test_ds = make_windows(tr, window=6), make_windows(te, window=6)
    jinit = jrnn.init_rnn(jax.random.PRNGKey(0), TJCFG)
    calib = train_ds.x[:32]
    jreg, treg = JaxRegistry(), ModelRegistry()
    jreg.register("m", JaxForecaster(cfg=TJCFG, params=jinit))
    treg.register("m", LSTMForecaster(cfg=TCFG, params=_to_port(jinit),
                                      device="cpu"))
    jseen = _published(jreg, lambda p: jax.tree_util.tree_map(np.asarray,
                                                             p))
    tseen = _published(treg, params_to_numpy)
    jpub = JaxPublisher(jreg, "m", calib_windows=calib)
    tpub = WeightPublisher(treg, "m", calib_windows=calib)
    kw = dict(n_workers=2, iterations=40, batch=16, evl_weight=0.5, seed=0)
    jres = jloop.train_rnn_local_sgd(train_ds, test_ds, cfg=TJCFG,
                                     round_callback=jpub, **kw)
    tres = loop.train_rnn_local_sgd(train_ds, test_ds, cfg=TCFG,
                                    init_params=_to_port(jinit),
                                    round_callback=tpub, device="cpu", **kw)
    assert tres.communications == jres.communications == 3
    assert tpub.published == jpub.published == 3
    assert [v for v, _ in tseen] == [v for v, _ in jseen] == [2, 3, 4]
    for (_, got), (_, want) in zip(tseen, jseen):
        tree_map(lambda a, b: np.testing.assert_allclose(
            a, b, rtol=RTOL, atol=ATOL), got, want)
    # the last published version is the trainer's final model
    for got, want in zip(tree_leaves(treg.get("m").params),
                         tree_leaves(tres.params)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
