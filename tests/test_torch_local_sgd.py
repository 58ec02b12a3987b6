"""The port's asynchronous local SGD (``repro_torch.core``) against the
JAX package's: the core invariants of ``tests/test_local_sgd.py``
mirrored on the port (serial equivalence, model vs gradient exchange,
the Definition-1 audit against a numpy recursion, gradient exchange
forcing H == 1, the configuration's validation), the trainer's params
against ``repro.core.AsyncLocalSGD`` after several rounds, and the
schedules and client splits array-equal to the reference.

A port loss takes worker-stacked params and a batch with leaves
[W, B, ...] and returns the W losses; the reference's loss is written
for one worker and vmapped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import async_local_sgd as jlsgd
from repro.core import schedules as jsched
from repro.data.sharding import client_splits as jax_client_splits
from repro.optim.optimizers import sgd as jax_sgd
from repro_torch.core import schedules as tsched
from repro_torch.core.async_local_sgd import (AsyncLocalSGD, LocalSGDConfig,
                                              broadcast_to_workers,
                                              local_sgd_round, sync_step,
                                              value_and_grad, worker_mean)
from repro_torch.data.sharding import client_splits
from repro_torch.optim.optimizers import adam, apply_updates, sgd

RTOL, ATOL = 1e-5, 1e-6


def quad_loss(params, batch):
    """Per-worker MSE of a linear model: params w [W, 3], b [W]; batch
    x [W, B, 3], y [W, B] -> [W]."""
    x, y = batch
    pred = torch.einsum("wbi,wi->wb", x, params["w"]) + params["b"][:, None]
    return torch.mean((pred - y) ** 2, dim=1)


def jax_quad_loss(params, batch):
    x, y = batch
    pred = x @ params["w"] + params["b"]
    return jnp.mean((pred - y) ** 2)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    w_true = np.array([1.0, -2.0, 0.5], np.float32)
    return x, (x @ w_true + 0.1).astype(np.float32)


def _params():
    return {"w": torch.zeros(3), "b": torch.zeros(())}


def _stack(p, W):
    return {k: v.unsqueeze(0).expand((W,) + tuple(v.shape)).contiguous()
            for k, v in p.items()}


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_single_worker_single_step_equals_serial_sgd():
    """W=1, H=1 local SGD == one plain SGD step."""
    opt = sgd()
    x, y = _data(8)
    stacked = _stack(_params(), 1)
    newp, _, losses = local_sgd_round(quad_loss, opt, stacked,
                                      opt.init(stacked),
                                      _t(x[None, None], y[None, None]), 0.1)
    serial = lambda p, b: quad_loss(_stack(p, 1), tuple(a[None] for a in b))[0]
    loss, g = value_and_grad(serial, _params(), _t(x, y))
    upd, _ = opt.update(g, opt.init(_params()), _params(), 0.1)
    want = apply_updates(_params(), upd)
    for k in want:
        torch.testing.assert_close(newp[k][0], want[k], rtol=1e-6, atol=0)
    assert float(losses[0, 0]) == float(loss)


def test_model_vs_gradient_exchange_equal_for_plain_sgd():
    """At H=1 with plain SGD, averaging models == averaging gradients."""
    opt = sgd()
    x, y = _data(16)
    W = 4
    stacked = _stack(_params(), W)
    batch = _t(x.reshape(W, 4, 3), y.reshape(W, 4))
    p_m, _, _ = sync_step(quad_loss, opt, stacked, opt.init(stacked), batch,
                          0.1, exchange="model")
    p_g, _, _ = sync_step(quad_loss, opt, stacked, opt.init(stacked), batch,
                          0.1, exchange="gradient")
    torch.testing.assert_close(p_m["w"][0], p_g["w"][0], rtol=1e-5, atol=0)


def test_identical_workers_identical_data_stay_identical():
    opt = sgd()
    x, y = _data(8)
    W, H = 3, 2
    stacked = _stack(_params(), W)
    batches = _t(np.broadcast_to(x[None, None], (W, H, 8, 3)),
                 np.broadcast_to(y[None, None], (W, H, 8)))
    newp, _, _ = local_sgd_round(quad_loss, opt, stacked, opt.init(stacked),
                                 batches, 0.05)
    for leaf in newp.values():
        for w in range(1, W):
            torch.testing.assert_close(leaf[0], leaf[w], rtol=1e-6, atol=0)


def test_worker_mean_and_broadcast_roundtrip():
    t = {"w": torch.arange(6.0).reshape(3, 2)}
    avg = worker_mean(t)
    torch.testing.assert_close(avg["w"], t["w"].mean(0))
    back = broadcast_to_workers(avg, t)
    assert back["w"].shape == t["w"].shape and back["w"].is_contiguous()


def test_trainer_accounting_and_convergence():
    x, y = _data(512)
    cfg = LocalSGDConfig(n_workers=2, schedule=tsched.SampleSchedule(a=4),
                         stepsize=tsched.StepSizeSchedule(eta0=0.05,
                                                          beta=0.0))
    trainer = AsyncLocalSGD(quad_loss, sgd(), cfg)
    stacked, opt_state = trainer.init(_params())
    rng = np.random.default_rng(0)
    for r in range(1, 13):
        h = trainer.local_steps_for_round(r)
        idx = rng.integers(0, 512, size=(2, h, 32))
        stacked, opt_state, _ = trainer.run_round(stacked, opt_state,
                                                  (x[idx], y[idx]))
    assert trainer.rounds_done == 12 and trainer.communications == 12
    assert trainer.iterations_done > 5 * trainer.rounds_done
    assert trainer.loss_history[-1] < trainer.loss_history[0] * 0.2
    assert trainer.model_bytes(stacked) == 4 * 4
    assert trainer.communication_bytes(stacked) == \
        12 * 2 * 2 * trainer.model_bytes(stacked)


def test_delayed_average_consumed_exactly_at_round_r_plus_tau():
    """Definition 1, exactly: with staleness tau the round-r average is
    consumed at round r + tau, checked against a numpy simulation of the
    recursion w <- avg^(r) + (w - w^(r))."""
    W, H, B, tau, R = 3, 2, 4, 2, 6
    lr = 0.05

    def lin_loss(params, batch):
        (x,) = batch                                  # [W, B, 3]
        return torch.einsum("wi,wi->w", params["w"], x.mean(dim=1))

    cfg = LocalSGDConfig(n_workers=W, tau=tau,
                         stepsize=tsched.StepSizeSchedule(eta0=lr, beta=0.0))
    trainer = AsyncLocalSGD(lin_loss, sgd(), cfg)
    stacked, opt_state = trainer.init({"w": torch.zeros(3)})

    rng = np.random.default_rng(7)
    rounds = [rng.standard_normal((W, H, B, 3)).astype(np.float32)
              for _ in range(R)]
    pw = np.zeros((W, 3), np.float64)
    queue, expected = [], []
    for r, g in enumerate(rounds, start=1):
        for w in range(W):
            for h in range(H):
                pw[w] -= lr * g[w, h].mean(axis=0)
        queue.append((pw.mean(axis=0), pw.copy(), r))
        if len(queue) > tau:
            avg_old, snap_old, r_old = queue.pop(0)
            expected.append((r, r_old))
            pw = avg_old[None] + (pw - snap_old)

    for g in rounds:
        stacked, opt_state, _ = trainer.run_round(stacked, opt_state, (g,))
    assert trainer.consumed_rounds == expected
    assert expected == [(r, r - tau) for r in range(tau + 1, R + 1)]
    np.testing.assert_allclose(stacked["w"].numpy(), pw, rtol=1e-5,
                               atol=1e-6)


def test_gradient_exchange_forces_single_local_step():
    """Paper footnote **: gradient exchange communicates every iteration,
    so a round is one step, and the trainer enforces it."""
    opt = sgd()
    x, y = _data(16)
    cfg = LocalSGDConfig(n_workers=4, exchange="gradient",
                         schedule=tsched.SampleSchedule(a=16),
                         stepsize=tsched.StepSizeSchedule(eta0=0.1, beta=0.0))
    trainer = AsyncLocalSGD(quad_loss, opt, cfg)
    for i in (1, 2, 5, 20):
        assert trainer.local_steps_for_round(i) == 1
    stacked, opt_state = trainer.init(_params())
    xb, yb = x.reshape(4, 1, 4, 3), y.reshape(4, 1, 4)
    newp, _, _ = trainer.run_round(stacked, opt_state, (xb, yb))
    assert trainer.iterations_done == 4 and trainer.communications == 1
    want, _, _ = sync_step(quad_loss, opt, stacked, opt_state,
                           _t(xb[:, 0], yb[:, 0]), trainer.cfg.stepsize(0),
                           exchange="gradient")
    torch.testing.assert_close(newp["w"], want["w"], rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="H == 1"):
        trainer.run_round(newp, opt_state,
                          (np.broadcast_to(xb, (4, 2, 4, 3)),
                           np.broadcast_to(yb, (4, 2, 4))))


def test_gradient_exchange_config_validation():
    with pytest.raises(ValueError):
        LocalSGDConfig(exchange="gradient", tau=1)
    with pytest.raises(ValueError):
        LocalSGDConfig(exchange="momentum")


def test_stale_averaging_satisfies_definition_1():
    x, y = _data(64)
    cfg = LocalSGDConfig(n_workers=2, tau=1,
                         schedule=tsched.SampleSchedule(a=2),
                         stepsize=tsched.StepSizeSchedule(eta0=0.05, beta=0.0))
    trainer = AsyncLocalSGD(quad_loss, sgd(), cfg)
    stacked, opt_state = trainer.init(_params())
    rng = np.random.default_rng(1)
    for r in range(1, 6):
        h = trainer.local_steps_for_round(r)
        idx = rng.integers(0, 64, size=(2, h, 16))
        stacked, opt_state, _ = trainer.run_round(stacked, opt_state,
                                                  (x[idx], y[idx]))
        assert len(trainer._avg_queue) <= cfg.tau
    assert trainer.loss_history[-1] < trainer.loss_history[0]


@pytest.mark.parametrize("tau,exchange,opt", [(0, "model", "sgd"),
                                              (1, "model", "sgd"),
                                              (2, "model", "adam"),
                                              (0, "gradient", "sgd")])
def test_trainer_matches_reference_after_several_rounds(tau, exchange, opt):
    """From the same init and batches, the port's AsyncLocalSGD and the
    reference's give the same params, losses and audit after 6 rounds."""
    from repro.optim.optimizers import adam as jax_adam

    W = 3
    x, y = _data(256, seed=3)
    tcfg = LocalSGDConfig(n_workers=W, tau=tau, exchange=exchange,
                          schedule=tsched.SampleSchedule(a=6),
                          stepsize=tsched.StepSizeSchedule(eta0=0.05))
    jcfg = jlsgd.LocalSGDConfig(n_workers=W, tau=tau, exchange=exchange,
                                schedule=jsched.SampleSchedule(a=6),
                                stepsize=jsched.StepSizeSchedule(eta0=0.05))
    tt = AsyncLocalSGD(quad_loss, adam() if opt == "adam" else sgd(), tcfg)
    jt = jlsgd.AsyncLocalSGD(jax_quad_loss,
                             jax_adam() if opt == "adam" else jax_sgd(), jcfg)
    init = {"w": np.array([0.3, -0.1, 0.2], np.float32),
            "b": np.array(0.05, np.float32)}
    tp, to = tt.init({k: torch.from_numpy(v) for k, v in init.items()})
    jp, jo = jt.init(jax.tree.map(jnp.asarray, init))
    rng = np.random.default_rng(4)
    for r in range(1, 7):
        h = tt.local_steps_for_round(r)
        assert h == jt.local_steps_for_round(r)
        idx = rng.integers(0, 256, size=(W, h, 16))
        tp, to, tl = tt.run_round(tp, to, (x[idx], y[idx]))
        jp, jo, jl = jt.run_round(jp, jo, (x[idx], y[idx]))
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
        for k in init:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL)
    assert tt.consumed_rounds == jt.consumed_rounds
    assert (tt.iterations_done, tt.communications) == \
        (jt.iterations_done, jt.communications)
    assert tt.communication_bytes(tp) == jt.communication_bytes(jp)


def test_schedules_match_reference():
    for ts, js in ((tsched.SampleSchedule(), jsched.SampleSchedule()),
                   (tsched.SampleSchedule(a=3, p=1.5, b=2),
                    jsched.SampleSchedule(a=3, p=1.5, b=2)),
                   (tsched.ConstantSchedule(size=7),
                    jsched.ConstantSchedule(size=7))):
        assert [ts.round_size(i) for i in range(1, 30)] == \
            [js.round_size(i) for i in range(1, 30)]
        assert ts.cumulative(12) == js.cumulative(12)
        assert ts.rounds_for_budget(2000) == js.rounds_for_budget(2000)
        assert ts.sizes_for_budget(777) == js.sizes_for_budget(777)
        with pytest.raises(ValueError):
            ts.round_size(0)
    st, sj = tsched.StepSizeSchedule(), jsched.StepSizeSchedule()
    assert [st(t) for t in range(0, 5000, 97)] == \
        [sj(t) for t in range(0, 5000, 97)]
    assert list(tsched.round_step_sizes(tsched.SampleSchedule(), st, 9)) == \
        list(jsched.round_step_sizes(jsched.SampleSchedule(), sj, 9))
    assert tsched.communication_rounds_constant(1001, 10) == \
        jsched.communication_rounds_constant(1001, 10) == 101


@pytest.mark.parametrize("mode", ["iid", "contiguous", "shared"])
@pytest.mark.parametrize("n,clients,seed", [(838, 4, 0), (101, 3, 7)])
def test_client_splits_match_reference(mode, n, clients, seed):
    got = client_splits(n, clients, mode=mode, seed=seed)
    want = jax_client_splits(n, clients, mode=mode, seed=seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        client_splits(n, clients, mode="bogus")
