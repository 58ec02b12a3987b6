"""The port's LSTM layer (T time steps from a given carry in one call:
on the card one launch of the layer kernel) against the JAX package:
the plain version and the CPU route of ``dispatch.lstm_layer`` against
``repro.models.rnn.lstm_layer_apply`` (its ``lax.scan``) from a zero
carry and against a loop of its ``lstm_cell`` from a non-zero one, over
the JAX kernel tests' shape sweep at T 1, 7 and 20; the layer's
gradient on the CPU against ``jax.grad``; ``LSTMForecaster.replay``, now
one layer call per layer, against step-by-step ``step`` bitwise and
against the JAX forecaster's ``replay``; and, on a card, the same
replay == steps contract through the kernel.

The JAX package is imported inside the parity tests only, so that the
``cuda`` test also runs on a machine with a card and no jax:
``python -m pytest -q -m cuda tests/test_torch_lstm_layer.py``."""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.lstm import kernel as lstm_kernel
from repro_torch.kernels.lstm.ref import lstm_cell_ref, lstm_layer_ref
from repro_torch.models.rnn import RNNConfig, lstm_layer_apply
from repro_torch.serving.forecaster import LSTMForecaster

RTOL, ATOL = 1e-5, 1e-6      # tests/test_kernels.py's LSTM tolerance

# tests/test_torch_lstm.py's (B, I, H) sweep, the JAX kernel tests' own
SHAPES = [(1, 5, 64), (13, 5, 64), (32, 7, 32), (8, 16, 128), (3, 9, 24),
          (7, 3, 40), (1, 1, 8), (9, 11, 48), (5, 5, 16)]
STEPS = [1, 7, 20]


def _layer(batch, steps, in_dim, hidden, seed=42, lead=()):
    """numpy inputs of one layer: xs, a non-zero carry and weights."""
    rng = np.random.default_rng(seed + batch * 1000 + steps * 100
                                + in_dim * 10 + hidden)
    f = np.float32
    return {"xs": rng.standard_normal(lead + (batch, steps, in_dim)).astype(f),
            "h0": rng.standard_normal(lead + (batch, hidden)).astype(f),
            "c0": rng.standard_normal(lead + (batch, hidden)).astype(f),
            "wx": (0.1 * rng.standard_normal(lead + (in_dim, 4 * hidden))
                   ).astype(f),
            "wh": (0.1 * rng.standard_normal(lead + (hidden, 4 * hidden))
                   ).astype(f),
            "b": (0.1 * rng.standard_normal(lead + (4 * hidden,))).astype(f)}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("batch,in_dim,hidden", SHAPES)
def test_layer_from_zero_carry_matches_jax_scan(batch, in_dim, hidden,
                                                steps):
    """lstm_layer_ref, dispatch.lstm_layer on the CPU and the model's
    lstm_layer_apply against repro.models.rnn.lstm_layer_apply."""
    import jax.numpy as jnp

    from repro.models.rnn import lstm_layer_apply as jax_layer_apply

    a = _layer(batch, steps, in_dim, hidden)
    p = {k: a[k] for k in ("wx", "wh", "b")}
    want = np.asarray(jax_layer_apply({k: jnp.asarray(v)
                                       for k, v in p.items()},
                                      jnp.asarray(a["xs"])))
    t = params_from_numpy(a, device="cpu")
    zero = torch.zeros(batch, hidden)
    hs, hT, cT = lstm_layer_ref(t["xs"], zero, zero, t["wx"], t["wh"],
                                t["b"])
    hs2, hT2, _ = dispatch.lstm_layer(t["xs"], zero, zero, t["wx"], t["wh"],
                                      t["b"])
    hs3, (hT3, _) = lstm_layer_apply(params_from_numpy(p, device="cpu"),
                                     t["xs"])
    assert hs.shape == (batch, steps, hidden) and cT.shape == (batch, hidden)
    for got in (hs, hs2, hs3):
        _close(got.numpy(), want)
    for got in (hT, hT2, hT3):
        _close(got.numpy(), want[:, -1])


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("batch,in_dim,hidden", SHAPES)
def test_layer_from_carry_matches_jax_cell_loop(batch, in_dim, hidden,
                                                steps):
    """From a non-zero (h0, c0): hs and the final (hT, cT) against T steps
    of repro.models.rnn.lstm_cell chained through the carry."""
    import jax.numpy as jnp

    from repro.models.rnn import lstm_cell as jax_cell

    a = _layer(batch, steps, in_dim, hidden, seed=7)
    jp = {k: jnp.asarray(a[k]) for k in ("wx", "wh", "b")}
    h, c = jnp.asarray(a["h0"]), jnp.asarray(a["c0"])
    want = []
    for t in range(steps):
        h, c = jax_cell(jp, jnp.asarray(a["xs"][:, t]), h, c)
        want.append(np.asarray(h))
    t = params_from_numpy(a, device="cpu")
    args = (t["xs"], t["h0"], t["c0"], t["wx"], t["wh"], t["b"])
    for hs, hT, cT in (lstm_layer_ref(*args), dispatch.lstm_layer(*args)):
        _close(hs.numpy(), np.stack(want, axis=1))
        _close(hT.numpy(), h)
        _close(cT.numpy(), c)


@pytest.mark.parametrize("workers,batch,steps,in_dim,hidden",
                         [(3, 4, 7, 5, 16), (2, 5, 20, 9, 24)])
def test_stacked_layer_matches_jax_per_worker(workers, batch, steps, in_dim,
                                              hidden):
    """The worker-stacked layer is W independent layers: each worker's
    rows against the JAX cell loop on that worker's weights."""
    import jax.numpy as jnp

    from repro.models.rnn import lstm_cell as jax_cell

    a = _layer(batch, steps, in_dim, hidden, lead=(workers,))
    t = params_from_numpy(a, device="cpu")
    hs, hT, cT = dispatch.lstm_layer(t["xs"], t["h0"], t["c0"], t["wx"],
                                     t["wh"], t["b"])
    assert hs.shape == (workers, batch, steps, hidden)
    for w in range(workers):
        jp = {k: jnp.asarray(a[k][w]) for k in ("wx", "wh", "b")}
        h, c = jnp.asarray(a["h0"][w]), jnp.asarray(a["c0"][w])
        for s in range(steps):
            h, c = jax_cell(jp, jnp.asarray(a["xs"][w, :, s]), h, c)
            _close(hs[w, :, s].numpy(), h)
        _close(hT[w].numpy(), h)
        _close(cT[w].numpy(), c)


@pytest.mark.parametrize("batch,steps,in_dim,hidden",
                         [(4, 6, 5, 16), (3, 20, 9, 8)])
def test_layer_gradient_on_cpu_matches_jax_grad(batch, steps, in_dim,
                                                hidden):
    """The CPU training path differentiates the plain layer: its gradient
    for xs, the carry and the weights against jax.grad of a JAX cell loop
    from the same carry."""
    import jax
    import jax.numpy as jnp

    from repro.models.rnn import lstm_cell as jax_cell

    a = _layer(batch, steps, in_dim, hidden, seed=3)
    cot = np.random.default_rng(5).standard_normal(
        (batch, steps, hidden)).astype(np.float32)
    names = ("xs", "h0", "c0", "wx", "wh", "b")

    def jloss(xs, h0, c0, wx, wh, b):
        p = {"wx": wx, "wh": wh, "b": b}
        h, c, out = h0, c0, 0.0
        for s in range(steps):
            h, c = jax_cell(p, xs[:, s], h, c)
            out = out + jnp.sum(h * cot[:, s])
        return out + jnp.sum(c)

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a[n]) for n in names))
    ts = [torch.from_numpy(a[n]).requires_grad_(True) for n in names]
    hs, _, cT = dispatch.lstm_layer(*ts)
    got = torch.autograd.grad((hs * torch.from_numpy(cot)).sum()
                              + cT.sum(), ts)
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("in_dim,hidden", [(5, 64), (64, 64), (3, 40)])
def test_layer_is_its_cells_chained_bitwise_on_cpu(in_dim, hidden):
    """Step t of the plain layer is T plain cells chained through the
    carry, bit for bit: the CPU side of the contract the kernel keeps."""
    t = params_from_numpy(_layer(8, 20, in_dim, hidden), device="cpu")
    hs, hT, cT = lstm_layer_ref(t["xs"], t["h0"], t["c0"], t["wx"], t["wh"],
                                t["b"])
    h, c = t["h0"], t["c0"]
    for s in range(20):
        h, c = lstm_cell_ref(t["xs"][:, s].contiguous(), h, c, t["wx"],
                             t["wh"], t["b"])
        assert torch.equal(hs[:, s], h)
    assert torch.equal(hT, h) and torch.equal(cT, c)


def test_cpu_route_launches_nothing_and_takes_empty_windows():
    t = params_from_numpy(_layer(4, 5, 5, 16), device="cpu")
    lstm_kernel.LAUNCHES.reset()
    args = (t["xs"], t["h0"], t["c0"], t["wx"], t["wh"], t["b"])
    hs, hT, cT = dispatch.lstm_layer(*args)
    hr, hTr, cTr = lstm_layer_ref(*args)
    assert torch.equal(hs, hr) and torch.equal(hT, hTr)
    assert torch.equal(cT, cTr)
    assert lstm_kernel.LAUNCHES.total == 0
    hs, hT, cT = dispatch.lstm_layer(t["xs"][:, :0], *args[1:])
    assert hs.shape == (4, 0, 16)
    assert torch.equal(hT, t["h0"]) and torch.equal(cT, t["c0"])


def test_layer_wrapper_rejects_bad_shapes_and_mixed_devices():
    t = params_from_numpy(_layer(2, 3, 5, 8), device="cpu")
    xs, h0, c0, wx, wh, b = (t[k] for k in ("xs", "h0", "c0", "wx", "wh",
                                            "b"))
    with pytest.raises(ValueError, match="x \\[B, T, I\\]"):
        dispatch.lstm_layer(xs[:, 0], h0, c0, wx, wh, b)
    with pytest.raises(ValueError, match="leading dims"):
        dispatch.lstm_layer(xs[:1], h0, c0, wx, wh, b)
    with pytest.raises(ValueError, match="wh must be"):
        dispatch.lstm_layer(xs, h0, c0, wx, wh[:, :-1], b)
    with pytest.raises(ValueError, match="one device"):
        dispatch.lstm_layer(xs, h0, c0, wx, wh, b.to("meta"))


CFG = RNNConfig(input_dim=5, hidden=16, num_layers=2, fc_dims=(8, 4),
                window=6, evl_head=True)


def _forecaster(device="cpu"):
    """The port's forecaster on the JAX package's init weights (seed 0),
    calibrated as the JAX one is, with its tail."""
    import jax

    from repro.models.rnn import RNNConfig as JRNNConfig
    from repro.models.rnn import init_rnn as jinit_rnn
    from repro.serving.forecaster import LSTMForecaster as JForecaster

    cfg_j = JRNNConfig(input_dim=5, hidden=16, num_layers=2, fc_dims=(8, 4),
                       window=6, evl_head=True)
    jparams = jinit_rnn(jax.random.PRNGKey(0), cfg_j)
    ref = JForecaster(cfg=cfg_j, params=jparams)
    ref.calibrate(_windows(64, seed=9))
    ours = LSTMForecaster(
        cfg=CFG, params=params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), device=device),
        tail=dict(ref.tail), eps=ref.eps, device=device)
    return ref, ours


def _windows(n, t=6, seed=0):
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (n, t, 5))).astype(np.float32)


def _carry(ours, n, seed):
    rng = np.random.default_rng(seed)
    return tuple((torch.from_numpy(0.3 * rng.standard_normal(
                      (n, 16)).astype(np.float32)).to(ours.device),
                  torch.from_numpy(0.3 * rng.standard_normal(
                      (n, 16)).astype(np.float32)).to(ours.device))
                 for _ in range(2))


def _assert_replay_is_steps(ours, x, carry):
    """replay from ``carry`` == one ``step`` per time step from it, bit
    for bit: forecast, alert and every layer's carry."""
    yr, pr, cr = ours.replay(x, carry)
    c = carry
    for t in range(x.shape[1]):
        ys, ps, c = ours.step(x[:, t], c)
    np.testing.assert_array_equal(ys, yr)
    np.testing.assert_array_equal(ps, pr)
    for (h1, c1), (h2, c2) in zip(c, cr):
        assert torch.equal(h1, h2) and torch.equal(c1, c2)


@pytest.mark.parametrize("n,steps", [(1, 6), (3, 6), (11, 6), (2, 1),
                                     (5, 20)])
def test_replay_is_its_steps_bitwise_on_cpu(n, steps):
    """The layer-major replay against step-by-step ``step``, from a zero
    and from a non-zero carry; 11 sessions chunk at the decode width."""
    _, ours = _forecaster()
    x = _windows(n, t=steps, seed=n + steps)
    _assert_replay_is_steps(ours, x, ours.init_carry(n))
    _assert_replay_is_steps(ours, x, _carry(ours, n, seed=n))


@pytest.mark.parametrize("n,steps", [(3, 6), (9, 20)])
def test_replay_matches_jax_replay(n, steps):
    """The layer-major replay against the JAX forecaster's replay (one
    unrolled scan of its per-step computation), from a zero and from a
    non-zero carry."""
    ref, ours = _forecaster()
    x = _windows(n, t=steps, seed=11 * n)
    carry = _carry(ours, n, seed=2)
    jcarry = tuple((h.numpy(), c.numpy()) for h, c in carry)
    for args, jargs in (((x,), (x,)), ((x, carry), (x, jcarry))):
        y, p, c = ours.replay(*args)
        yj, pj, cj = ref.replay(*jargs)
        np.testing.assert_allclose(y, np.asarray(yj), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(p, np.asarray(pj), rtol=1e-4, atol=1e-5)
        for (h1, c1), (hj, cjj) in zip(c, cj):
            np.testing.assert_allclose(h1.numpy(), np.asarray(hj),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(c1.numpy(), np.asarray(cjj),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_replay_is_its_steps_bitwise():
    """On the card: replay (one T-step launch per layer) == steps (one
    T = 1 launch per layer per step), bit for bit, and replay makes
    exactly one launch per layer per decode-width chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.rnn import init_rnn

    ours = LSTMForecaster(cfg=CFG, params=init_rnn(gen, CFG, device="cpu"),
                          device="cuda")
    for n, steps in ((1, 6), (3, 20), (11, 6)):
        x = _windows(n, t=steps, seed=n)
        before = lstm_kernel.LAUNCHES.total
        ours.replay(x)
        assert lstm_kernel.LAUNCHES.total - before == 2 * -(-n // 8)
        _assert_replay_is_steps(ours, x, ours.init_carry(n))
        _assert_replay_is_steps(ours, x, _carry(ours, n, seed=n))
