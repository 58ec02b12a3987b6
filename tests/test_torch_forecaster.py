"""The port's ``LSTMForecaster`` against the JAX package's on the same
weights and the same EVT tail: predict, replay, and the slotless step
paths. The whole path is held at rtol 1e-4 / atol 1e-5: 2 x T cell
applications sum in XLA's order on one side and oneDNN's on the other,
and the alert's GEV term (gamma = 5) amplifies the difference. Inside
the port, step == replay == slot generate holds bitwise."""

import inspect

import jax
import numpy as np
import pytest
import torch

from repro.models.rnn import RNNConfig as JRNNConfig
from repro.models.rnn import init_rnn as jinit_rnn
from repro.serving.forecaster import LSTMForecaster as JForecaster
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.models.rnn import RNNConfig
from repro_torch.serving import forecaster as fmod
from repro_torch.serving.forecaster import (LSTMForecaster,
                                            _alert_probability,
                                            build_lstm_forecaster)

RTOL, ATOL = 1e-4, 1e-5
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
    jparams = jinit_rnn(jax.random.PRNGKey(0), CFG_J)
    ref = JForecaster(cfg=CFG_J, params=jparams)
    ref.calibrate(_windows(64, seed=9))
    ours = LSTMForecaster(
        cfg=CFG, params=params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
        tail=dict(ref.tail), eps=ref.eps, device="cpu")
    return ref, ours


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _carry_close(got, want):
    for (h, c), (hj, cj) in zip(got, want):
        _close(h.numpy(), hj)
        _close(c.numpy(), cj)


def test_predict_matches_reference(pair):
    ref, ours = pair
    x = _windows(5, t=8, seed=1)
    lengths = np.array([8, 2, 6, 8, 5], np.int32)
    for args in ((x,), (x, lengths)):
        y, p = ours.predict(*args)
        yj, pj = ref.predict(*args)
        assert y.dtype == p.dtype == np.float32 and y.shape == (5,)
        _close(y, yj)
        _close(p, pj)


def test_calibrate_matches_reference(pair):
    ref, ours = pair
    fresh = ours.with_params(ours.params)
    fresh.calibrate(_windows(64, seed=9))
    for k in ref.tail:
        np.testing.assert_allclose(fresh.tail[k], ref.tail[k], rtol=1e-4)
    np.testing.assert_allclose(fresh.eps, ref.eps, rtol=1e-4)
    assert fresh.version == 0 and fresh.published_at is None


def test_replay_and_steps_match_reference_slotless_path(pair):
    ref, ours = pair
    x = _windows(3, seed=2)
    y, p, carry = ours.replay(x)
    yj, pj, cj = ref.replay(x)
    _close(y, yj)
    _close(p, pj)
    _carry_close(carry, cj)
    # single-session steps and a batched step of 3 sessions
    tc, jc = ours.init_carry(1), ref.init_carry(1)
    carries = [ours.init_carry(1) for _ in range(3)]
    jcarries = [ref.init_carry(1) for _ in range(3)]
    for t in range(W):
        ys, ps, tc = ours.step(x[:1, t], tc)
        yjs, pjs, jc = ref.step(x[:1, t], jc)
        _close(ys, yjs)
        _close(ps, pjs)
        ym, pm, carries = ours.step_many(x[:, t], carries)
        yjm, pjm, jcarries = ref.step_many(x[:, t], jcarries)
        _close(ym, yjm)
        _close(pm, pjm)
    _carry_close(tc, jc)


def test_generate_matches_reference_replay(pair):
    ref, ours = pair
    x = _windows(3, seed=3)
    slots = ours.init_slots(20)
    assert slots.num_slots == 24 and slots.n_active == 0
    lanes = [2, 9, 23]
    for lane in lanes:
        ours.insert(slots, lane, ours.init_carry(1))
    for t in range(W):
        xs = np.zeros((24, 5), np.float32)
        xs[lanes] = x[:, t]
        y, p, _ = ours.generate(slots, xs)
    yj, pj, _ = ref.replay(x)
    _close(y[lanes], yj)
    _close(p[lanes], pj)


def test_step_replay_generate_bitwise_inside_port(pair):
    _, ours = pair
    x = _windows(3, seed=4)
    carry = ours.init_carry(1)
    for t in range(W):
        ys, ps, carry = ours.step(x[1:2, t], carry)
    yr, pr, cr = ours.replay(x[1:2])
    ym, pm, cm = ours.replay(x)            # batched replay, 3 rows
    slots = ours.init_slots(16)
    for lane in (3, 11, 13):
        ours.insert(slots, lane, ours.init_carry(1))
    for t in range(W):
        xs = np.zeros((16, 5), np.float32)
        xs[[3, 11, 13]] = x[:, t]
        yg, pg, _ = ours.generate(slots, xs)
    assert ys[0] == yr[0] == ym[1] == yg[11]
    assert ps[0] == pr[0] == pm[1] == pg[11]
    for (h1, c1), (h2, c2), (hm, cmm) in zip(carry, cr, cm):
        assert torch.equal(h1, h2) and torch.equal(c1, c2)
        assert torch.equal(h1[0], hm[1]) and torch.equal(c1[0], cmm[1])
    ex = ours.extract(slots, 11)
    for (h1, c1), (he, ce) in zip(carry, ex):
        assert torch.equal(h1, he) and torch.equal(c1, ce)
    # more sessions than the decode width: chunked step == batched replay
    many = _windows(11, seed=5)
    carries = ours.init_carry(11)
    for t in range(W):
        yk, pk, carries = ours.step(many[:, t], carries)
    yb, pb, _ = ours.replay(many)
    np.testing.assert_array_equal(yk, yb)
    np.testing.assert_array_equal(pk, pb)


def test_generate_updates_only_stepped_lanes_in_place(pair):
    _, ours = pair
    slots = ours.init_slots(16)
    rng = np.random.default_rng(6)
    for lane in range(16):
        carry = tuple((torch.from_numpy(rng.standard_normal((1, 16),
                                                             np.float32)),
                       torch.from_numpy(rng.standard_normal((1, 16),
                                                             np.float32)))
                      for _ in range(2))
        ours.insert(slots, lane, carry)
    tensors = [t for pair_ in slots.carry for t in pair_]
    before = [t.clone() for t in tensors]
    ours.generate(slots, rng.standard_normal((16, 5)).astype(np.float32),
                  lanes=[4, 12])
    for t, b in zip(tensors, before):
        changed = (t != b).any(dim=1).nonzero().flatten().tolist()
        assert changed == [4, 12]
    assert [t.data_ptr() for p_ in slots.carry for t in p_] == \
        [t.data_ptr() for t in tensors]           # same storage: in place
    ours.release(slots, 4)
    assert not slots.active[4] and slots.active[12]
    with pytest.raises(ValueError):
        ours.generate(slots, np.zeros((8, 5), np.float32))


def test_alert_probability_noisy_or():
    score = np.array([0.0, 0.05, 0.5], np.float32)
    head = np.array([0.1, 0.2, 0.3], np.float32)
    p = _alert_probability(score, None, 5.0, head=head)
    np.testing.assert_allclose(p.numpy(), head, rtol=1e-6)
    tail = {"xi": 0.05, "scale": 0.01}
    p = _alert_probability(score, tail, 5.0).numpy()
    assert p[0] < p[1] < p[2] <= 1.0
    np.testing.assert_allclose(p[1], np.exp(-1.0), rtol=1e-6)


def test_entry_points_default_to_the_card():
    params = inspect.signature(build_lstm_forecaster).parameters
    assert params["device"].default == "cuda"
    field = LSTMForecaster.__dataclass_fields__["device"]
    assert field.default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_lstm_forecaster(calibrate_ticker=None)


def test_build_lstm_forecaster_on_cpu_is_calibrated():
    fc = build_lstm_forecaster(seed=0, device="cpu", n_days=120)
    assert fc.cfg.hidden == 64 and fc.window == 20
    assert fc.tail is not None and fc.tail["scale"] > 0
    y, p = fc.predict(np.zeros((2, 20, 5), np.float32))
    assert np.all(np.isfinite(y)) and np.all((p >= 0) & (p <= 1))
    assert fmod.dispatch.impl_for(fc.device) == "torch"
