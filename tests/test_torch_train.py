"""The port's training path (``repro_torch.training``,
``repro_torch.launch.train``) against the JAX package's at a small size
(hidden 12, window 6): the loss's value and gradient against
``jax.value_and_grad``, the batches, and short serial and local-SGD runs
(loss history and test MSE) from the JAX package's initial weights,
passed in as ``init_params``; the CLI on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import load_stock, make_windows, train_test_split
from repro.extreme.indicators import extreme_fractions as jax_fractions
from repro.models import rnn as jrnn
from repro.training import loop as jloop
from repro.training import metrics as jmetrics
from repro_torch.checkpoint.convert import params_from_numpy, stack_workers
from repro_torch.extreme.indicators import extreme_fractions
from repro_torch.launch import train as train_cli
from repro_torch.models import rnn
from repro_torch.training import loop, metrics
from repro_torch.tree import tree_map

CFG_J = jrnn.RNNConfig(input_dim=5, hidden=12, num_layers=2, fc_dims=(8, 4),
                       window=6, evl_head=True)
CFG = rnn.RNNConfig(input_dim=5, hidden=12, num_layers=2, fc_dims=(8, 4),
                    window=6, evl_head=True)
RTOL, ATOL = 1e-5, 1e-6          # one loss value and its gradient
# A run's loss history and test MSE: both sides are fp32 SGD from the
# same weights on the same batches, and only the order of the sums in
# the products differs (XLA's against oneDNN's). Measured on this
# configuration on a CPU: histories within 2.3e-7 relative, test MSE
# within 7.5e-7 (serial, and W = 2 at tau 0 and 1). 1e-5 is tighter than
# the 1e-4 the run-level bound may take and leaves ~13x that drift.
RUN_RTOL = 1e-5


@pytest.fixture(scope="module")
def data():
    ohlcv = load_stock("AAPL", n_days=260, seed=0)
    tr, te = train_test_split(ohlcv)
    return make_windows(tr, window=6), make_windows(te, window=6)


@pytest.fixture(scope="module")
def init():
    """The JAX package's init_rnn weights, as numpy and in the port."""
    jparams = jrnn.init_rnn(jax.random.PRNGKey(0), CFG_J)
    npy = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_numpy(npy, device="cpu")


def _assert_tree_close(got, want, rtol, atol):
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.detach().numpy(), np.asarray(b), rtol=rtol, atol=atol), got, want)


@pytest.mark.parametrize("evl_weight,l2", [(0.0, 0.0), (0.5, 0.0),
                                           (0.5, 1e-3)])
def test_loss_value_and_grad_match_reference(data, init, evl_weight, l2):
    train_ds, _ = data
    jparams, tparams = init
    idx = np.arange(16) * 3
    weights = np.linspace(0.5, 1.5, len(train_ds)).astype(np.float32)
    batch = loop._batch_arrays(train_ds, idx, weights)
    kw = dict(evl_weight=evl_weight, beta0=0.9, beta1=0.1, l2=l2)
    jval, jgrad = jax.value_and_grad(jloop.make_loss_fn(CFG_J, **kw))(
        jparams, tuple(map(jnp.asarray, batch)))
    p = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    val = loop.make_loss_fn(CFG, **kw)(p, tuple(map(torch.from_numpy,
                                                    batch)))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=RTOL,
                               atol=ATOL)
    _assert_tree_close(tree_map(lambda t: t.grad, p), jgrad, RTOL, ATOL)


def test_worker_stacked_loss_is_one_loss_per_worker(data, init):
    """The loss on worker-stacked params and [W, B, ...] batches is the
    per-worker loss of the reference (its ``jax.vmap``)."""
    train_ds, _ = data
    jparams, tparams = init
    batches = loop._stack_batches(train_ds, np.arange(len(train_ds)), 5, 2,
                                  8)
    jloss = jloop.make_loss_fn(CFG_J, evl_weight=0.5, l2=1e-3)
    stacked_j = jax.tree.map(lambda a: jnp.stack([a, a]), jparams)
    want = jax.vmap(jloss)(stacked_j, tuple(map(jnp.asarray, batches)))
    got = loop.make_loss_fn(CFG, evl_weight=0.5, l2=1e-3)(
        stack_workers(tparams, 2), tuple(map(torch.from_numpy, batches)))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_batches_and_fractions_match_reference(data):
    train_ds, _ = data
    order = np.random.default_rng(3).permutation(len(train_ds))
    for got, want in zip(loop._stack_batches(train_ds, order, 150, 4, 16),
                         jloop._stack_batches(train_ds, order, 150, 4, 16)):
        np.testing.assert_array_equal(got, want)
    assert extreme_fractions(train_ds.v) == jax_fractions(train_ds.v)


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    pred, y = rng.standard_normal((2, 50)).astype(np.float32)
    np.testing.assert_allclose(metrics.mse(pred, y), jmetrics.mse(pred, y),
                               rtol=1e-6)
    np.testing.assert_allclose(metrics.rmse(pred, y),
                               jmetrics.rmse(pred, y), rtol=1e-6)
    u = rng.uniform(size=50)
    v = rng.integers(-1, 2, 50)
    assert metrics.extreme_event_metrics(u, v) == \
        jmetrics.extreme_event_metrics(u, v)


def test_serial_run_matches_reference(data, init):
    """30 iterations of the serial baseline with EVL: the loss history
    and the test MSE track the reference's."""
    train_ds, test_ds = data
    _, tparams = init
    kw = dict(cfg=None, iterations=30, batch=16, evl_weight=0.5, seed=0)
    want = jloop.train_rnn_serial(train_ds, test_ds, **{**kw, "cfg": CFG_J})
    got = loop.train_rnn_serial(train_ds, test_ds, **{**kw, "cfg": CFG},
                                init_params=tparams, device="cpu")
    assert len(got.loss_history) == 30
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=RUN_RTOL)
    np.testing.assert_allclose(got.test_mse, want.test_mse, rtol=RUN_RTOL)
    assert got.test_extreme == want.test_extreme
    assert got.loss_history[-1] < got.loss_history[0]


@pytest.mark.parametrize("tau", [0, 1])
def test_local_sgd_run_matches_reference(data, init, tau):
    """W = 2 workers, the linear schedule (rounds of 10, 20, 30 global
    iterations), EVL on: loss history, test MSE and the communication
    accounting track the reference's."""
    train_ds, test_ds = data
    _, tparams = init
    kw = dict(n_workers=2, iterations=60, batch=16, tau=tau, evl_weight=0.5,
              seed=0)
    want = jloop.train_rnn_local_sgd(train_ds, test_ds, cfg=CFG_J, **kw)
    rounds = []
    got = loop.train_rnn_local_sgd(
        train_ds, test_ds, cfg=CFG, init_params=tparams, device="cpu",
        round_callback=lambda r, p: rounds.append(r), **kw)
    assert len(got.loss_history) == len(want.loss_history) == 3
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=RUN_RTOL)
    np.testing.assert_allclose(got.test_mse, want.test_mse, rtol=RUN_RTOL)
    assert (got.iterations, got.communications, got.comm_bytes) == \
        (want.iterations, want.communications, want.comm_bytes)
    assert rounds == [1, 2, 3]
    _assert_tree_close(got.params, want.params, RUN_RTOL, 1e-5)


def test_port_init_without_init_params_is_seeded(data):
    train_ds, test_ds = data
    a, b = (loop.train_rnn_serial(train_ds, test_ds, cfg=CFG, iterations=3,
                                  batch=8, seed=5, device="cpu")
            for _ in range(2))
    assert a.loss_history == b.loss_history


def test_cli_trains_on_cpu_and_prints_the_summary(capsys):
    res = train_cli.main(["--arch", "paper-lstm", "--workers", "2",
                          "--iterations", "40", "--days", "300",
                          "--evl-weight", "0.5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "test MSE" in out and "communications 3" in out
    assert "comm bytes" in out
    assert res.communications == 3 and np.isfinite(res.test_mse)
    # zoo archs train too (tests/test_torch_zoo_train.py); an arch
    # neither package has is refused by argparse
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "gpt-9", "--device", "cpu"])
