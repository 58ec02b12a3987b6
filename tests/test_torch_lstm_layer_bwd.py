"""The port's LSTM layer backward (T steps in reverse in one call: on the
card one launch of ``lstm_layer_bwd.cu``) against the JAX package: the
plain backward ``lstm_layer_bwd_ref``, with the weight gradients of the
autograd Function's host glue ``ops.layer_grads``, against ``jax.vjp``
of a ``lax.scan`` of ``repro.kernels.lstm.ref.lstm_cell_ref`` from a
non-zero carry over the JAX kernel tests' shape sweep at T 1, 7 and 20
(T = 1 is the cell's backward); the glue with the plain backward against
torch autograd through the plain layer for all six operands, with the
operands the model's two layers differentiate; stacked workers against
per-worker runs; and a T-step backward against T chained T = 1 calls,
bitwise. On a card: the kernel against the plain backward, its bits (a
T-step launch == T chained T = 1 launches; rows independent of B and W;
the same on every run), the wrapper's refusals, and a local step's
gradients through the Function against the CPU.

The JAX package is imported inside the parity test only, so that the
``cuda`` tests also run on a machine with a card and no jax:
``python -m pytest -q -m cuda tests/test_torch_lstm_layer_bwd.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.lstm import kernel as lstm_kernel
from repro_torch.kernels.lstm.ops import layer_grads, lstm_cell, lstm_layer
from repro_torch.kernels.lstm.ref import (lstm_layer_bwd_ref,
                                          lstm_layer_fwd_ref, lstm_layer_ref)

RTOL, ATOL = 1e-5, 1e-6      # tests/test_kernels.py's LSTM tolerance
TRAIN_RTOL = 1e-4            # card vs CPU over a training step

# tests/test_kernels.py's (B, I, H) sweep, odd shapes included
SHAPES = [(1, 5, 64), (13, 5, 64), (32, 7, 32), (8, 16, 128), (3, 9, 24),
          (7, 3, 40), (1, 1, 8), (9, 11, 48), (5, 5, 16)]
STEPS = [1, 7, 20]
NAMES = ("xs", "h0", "c0", "wx", "wh", "b")
# needs_input_grad of the model's layers: the first layer's input is
# data, the second's is the first's hs; the carry starts at zeros
LAYER1 = (False, False, False, True, True, True)
LAYER2 = (True, False, False, True, True, True)
EVERY = (True,) * 6


def _layer(W, B, T, I, H, seed=42):
    """numpy inputs of W stacked layers: xs, a non-zero carry, weights."""
    rng = np.random.default_rng(seed + W * 7 + B * 1000 + T * 100 + I * 10
                                + H)
    f = np.float32
    return [rng.standard_normal((W, B, T, I)).astype(f),
            rng.standard_normal((W, B, H)).astype(f),
            rng.standard_normal((W, B, H)).astype(f),
            (0.1 * rng.standard_normal((W, I, 4 * H))).astype(f),
            (0.1 * rng.standard_normal((W, H, 4 * H))).astype(f),
            (0.1 * rng.standard_normal((W, 4 * H))).astype(f)]


def _cotangents(W, B, T, H, dhs="dense", carry=True, seed=5):
    """(dhs, dhT, dcT): dhs dense, or zero except at the last step (what
    ``rnn_apply``'s last hidden state gives); dhT and dcT given, or None
    (no gradient there)."""
    rng = np.random.default_rng(seed + T)
    f = np.float32
    d = rng.standard_normal((W, B, T, H)).astype(f)
    if dhs == "last":
        d[..., :-1, :] = 0.0
    dT = [rng.standard_normal((W, B, H)).astype(f) for _ in range(2)]
    return d, *(dT if carry else (None, None))


def _t(a, device="cpu"):
    return None if a is None else torch.from_numpy(a).to(device)


def _plain_grads(arrays, cot, need):
    """The glue with the plain backward in the kernel's place: the
    forward's saved tensors from ``lstm_layer_fwd_ref``."""
    ts = [_t(a) for a in arrays]
    hs, _, _, gates, cs = lstm_layer_fwd_ref(*ts)
    saved = (*ts[:5], hs, gates, cs)
    return layer_grads(saved, *map(_t, cot), need, lstm_layer_bwd_ref)


def _weight_grad_scales(arrays, cot):
    """|x|^T |dgates|, |h_prev|^T |dgates| and the sum of |dgates| over
    the window's B x T rows: the sums of the magnitudes of the terms that
    dwx, dwh and db add up. The glue sums them in one product over the
    window where autodiff sums a product per step; where the terms
    cancel, the two differ by rounding relative to these sums, not to
    the result."""
    ts = [_t(a).abs() for a in arrays]
    hs, _, _, gates, cs = lstm_layer_fwd_ref(*(_t(a) for a in arrays))
    dgates = lstm_layer_bwd_ref(*map(_t, cot), gates, cs, _t(arrays[2]),
                                _t(arrays[3]), _t(arrays[4]))[0].abs()
    W, B, T, G = dgates.shape
    rows = dgates.reshape(W, B * T, G)
    h_prev = torch.cat([ts[1].unsqueeze(2), hs.abs()[:, :, :-1]], dim=2)
    return {"wx": torch.bmm(ts[0].reshape(W, B * T, -1).transpose(1, 2),
                            rows),
            "wh": torch.bmm(h_prev.reshape(W, B * T, -1).transpose(1, 2),
                            rows),
            "b": rows.sum(dim=1)}


def _hold(name, got, want, scales):
    """d{name} at rtol 1e-5 / atol 1e-6, or for a weight gradient in
    ``scales`` with its rtol taken relative to its terms' magnitudes
    (``_weight_grad_scales``)."""
    want = torch.from_numpy(np.array(want)).reshape(got.shape)
    if name in scales:
        err = (got - want).abs()
        bound = ATOL + RTOL * scales[name].reshape(got.shape)
        assert bool((err <= bound).all()), (
            f"d{name}: max err {float(err.max()):.3e}, "
            f"{int((err > bound).sum())} entries past the bound")
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=f"d{name}")


@pytest.mark.parametrize("dhs,carry", [("dense", True), ("last", False),
                                       ("dense", False)],
                         ids=["dense-dhT", "last-none", "dense-none"])
@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("batch,in_dim,hidden", SHAPES)
def test_plain_backward_matches_jax_vjp_of_scan(batch, in_dim, hidden, steps,
                                                dhs, carry):
    """The plain backward and the glue's weight gradients against
    jax.vjp of a lax.scan of the JAX cell from a non-zero (h0, c0): all
    six operands. At T = 1 this is the cell's backward."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.lstm.ref import lstm_cell_ref as jax_cell_ref

    arrays = _layer(1, batch, steps, in_dim, hidden)
    cot = _cotangents(1, batch, steps, hidden, dhs, carry)

    def layer(xs, h0, c0, wx, wh, b):
        def step(hc, x_t):
            h, c = jax_cell_ref(x_t, *hc, wx, wh, b)
            return (h, c), h

        (hT, cT), hs = jax.lax.scan(step, (h0, c0), xs.transpose(1, 0, 2))
        return hs.transpose(1, 0, 2), hT, cT

    _, vjp = jax.vjp(layer, *(jnp.asarray(a[0]) for a in arrays))
    zero = np.zeros((batch, hidden), np.float32)
    want = vjp(tuple(jnp.asarray(zero if c is None else c[0]) for c in cot))
    got = _plain_grads(arrays, cot, EVERY)
    # over a window the glue sums one product, autodiff one per step: the
    # weight gradients against their terms' magnitudes; at T = 1 the two
    # are the same single-step product, held at the plain bound
    scales = ({k: v[0] for k, v in _weight_grad_scales(arrays, cot).items()}
              if steps > 1 else {})
    for name, g, w in zip(NAMES, got, want):
        _hold(name, g[0], w, scales)


# (W, B, T, I, H): the cell's backward tests' shapes at T = 1, then
# windows, a model's layer 1 (I 5) and layer 2 (I 64) among them
GLUE_SHAPES = [(1, 8, 1, 5, 16), (2, 5, 1, 5, 16), (3, 4, 1, 16, 8),
               (2, 6, 7, 5, 16), (2, 4, 20, 64, 64), (3, 5, 20, 9, 24)]


@pytest.mark.parametrize("need", [EVERY, LAYER1, LAYER2],
                         ids=["every", "layer1", "layer2"])
@pytest.mark.parametrize("workers,batch,steps,in_dim,hidden", GLUE_SHAPES)
def test_glue_matches_autograd_of_plain_layer(workers, batch, steps, in_dim,
                                              hidden, need):
    """``layer_grads`` with the plain backward equals torch autograd
    through ``lstm_layer_ref``, for each operand asked for, and gives
    None for the rest; a None cotangent counts as zero."""
    arrays = _layer(workers, batch, steps, in_dim, hidden)
    dhs, dhT, dcT = _cotangents(workers, batch, steps, hidden)
    got = _plain_grads(arrays, (dhs, None, dcT), need)
    ts = [_t(a).requires_grad_(n) for a, n in zip(arrays, need)]
    hs, _, cT = lstm_layer_ref(*ts)
    wrt = [t for t, n in zip(ts, need) if n]
    want = iter(torch.autograd.grad((hs, cT), wrt, (_t(dhs), _t(dcT))))
    for name, g, n in zip(NAMES, got, need):
        if not n:
            assert g is None, f"d{name} was not asked for"
            continue
        torch.testing.assert_close(g, next(want), rtol=RTOL, atol=ATOL,
                                   msg=f"d{name}")


def test_glue_takes_no_cotangent_at_all():
    """A layer whose outputs autograd gave no gradient: every operand's
    gradient is zero (the backward reads None as 0)."""
    arrays = _layer(2, 3, 4, 5, 8)
    got = _plain_grads(arrays, (None, None, None), EVERY)
    for name, g in zip(NAMES, got):
        assert g.shape == arrays[NAMES.index(name)].shape
        assert not bool(g.any()), f"d{name}"


@pytest.mark.parametrize("steps", [1, 20])
def test_stacked_backward_equals_per_worker_backward(steps):
    """The worker-stacked plain backward is W independent backwards."""
    ts = [_t(a) for a in _layer(3, 4, steps, 5, 16)]
    cot = [_t(c) for c in _cotangents(3, 4, steps, 16)]
    _, _, _, gates, cs = lstm_layer_fwd_ref(*ts)
    out = lstm_layer_bwd_ref(*cot, gates, cs, ts[2], ts[3], ts[4])
    for w in range(3):
        one = lstm_layer_bwd_ref(*(c[w] for c in cot), gates[w], cs[w],
                                 ts[2][w], ts[3][w], ts[4][w])
        for a, b in zip(one, out):
            torch.testing.assert_close(a, b[w], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("in_dim,hidden", [(5, 64), (64, 64), (3, 40)])
def test_plain_backward_is_its_steps_chained_bitwise(in_dim, hidden):
    """The plain backward at T = 20 is 20 calls at T = 1 chained through
    (dh0, dc0) -> (dhT, dcT), bit for bit: the CPU side of the contract
    the kernel keeps."""
    ts = [_t(a) for a in _layer(2, 8, 20, in_dim, hidden)]
    dhs, dhT, dcT = (_t(c) for c in _cotangents(2, 8, 20, hidden))
    _, _, _, gates, cs = lstm_layer_fwd_ref(*ts)
    c0, wx, wh = ts[2], ts[3], ts[4]
    dgates, dxs, dh0, dc0 = lstm_layer_bwd_ref(dhs, dhT, dcT, gates, cs, c0,
                                               wx, wh)
    dh, dc = dhT, dcT
    for t in reversed(range(20)):
        c_prev = c0 if t == 0 else cs[:, :, t - 1]
        dg, dx, dh, dc = lstm_layer_bwd_ref(
            dhs[:, :, t:t + 1], dh, dc, gates[:, :, t:t + 1],
            cs[:, :, t:t + 1], c_prev, wx, wh)
        assert torch.equal(dg[:, :, 0], dgates[:, :, t])
        assert torch.equal(dx[:, :, 0], dxs[:, :, t])
    assert torch.equal(dh, dh0) and torch.equal(dc, dc0)


def test_layer_function_saves_what_the_backward_reads():
    """``lstm_layer_fwd_ref`` (what the forward kernel saves) is the
    plain layer's hs, hT, cT plus gates and c consistent with them."""
    ts = [_t(a) for a in _layer(2, 3, 6, 5, 16)]
    hs, hT, cT, gates, cs = lstm_layer_fwd_ref(*ts)
    for a, b in zip((hs, hT, cT), lstm_layer_ref(*ts)):
        assert torch.equal(a, b)
    assert gates.shape == (2, 3, 6, 64) and cs.shape == (2, 3, 6, 16)
    assert torch.equal(cs[:, :, -1], cT)
    o = gates[..., 48:]
    torch.testing.assert_close(hs, o * torch.tanh(cs), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


# (W, B, I, H) the training path gives the layer: W in {1, 4} workers,
# batch 32, layer 1 (I = 5) and layer 2 (I = 64), hidden 64
TRAIN_SHAPES = [(1, 32, 5, 64), (4, 32, 5, 64), (1, 32, 64, 64),
                (4, 32, 64, 64)]


def _card_case(W, B, T, I, H, seed=3):
    """Inputs of one backward on the card: the forward's saved tensors
    from the plain layer, the carry and weights, and the cotangents."""
    ts = [_t(a, "cuda") for a in _layer(W, B, T, I, H, seed=seed)]
    hs, _, _, gates, cs = lstm_layer_fwd_ref(*ts)
    cot = [_t(c, "cuda") for c in _cotangents(W, B, T, H, seed=seed)]
    return ts, hs, gates, cs, cot


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx", [False, True], ids=["no-dx", "dx"])
@pytest.mark.parametrize(
    "workers,batch,steps,in_dim,hidden",
    [(W, B, T, I, H) for T in (1, 20) for W, B, I, H in TRAIN_SHAPES]
    + [(1, B, 20, I, H) for B, I, H in SHAPES])
def test_cuda_backward_matches_plain_version(workers, batch, steps, in_dim,
                                             hidden, need_dx):
    """One launch against the plain backward: dgates, dxs, dh0, dc0. The
    sweep's H 128 at I 16 reads its weights from device memory."""
    _card()
    ts, _, gates, cs, cot = _card_case(workers, batch, steps, in_dim, hidden)
    args = (*cot, gates, cs, ts[2], ts[3], ts[4])
    before = lstm_kernel.LAYER_BWD_LAUNCHES.total
    got = lstm_kernel.lstm_layer_bwd_cuda(*args, need_dx=need_dx)
    torch.cuda.synchronize()
    assert lstm_kernel.LAYER_BWD_LAUNCHES.total == before + 1
    want = lstm_layer_bwd_ref(*args, need_dx=need_dx)
    assert (got[1] is None) == (not need_dx)
    for name, a, b in zip(("dgates", "dxs", "dh0", "dc0"), got, want):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL,
                                       msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dim", [5, 64])
def test_cuda_backward_steps_equal_chained_single_steps(in_dim):
    """A T = 20 launch == 20 launches at T = 1 chained through
    (dh0, dc0) -> (dhT, dcT), bitwise: dgates, dxs and the carry."""
    _card()
    ts, _, gates, cs, (dhs, dhT, dcT) = _card_case(4, 32, 20, in_dim, 64)
    c0, wx, wh = ts[2], ts[3], ts[4]
    dgates, dxs, dh0, dc0 = lstm_kernel.lstm_layer_bwd_cuda(
        dhs, dhT, dcT, gates, cs, c0, wx, wh)
    dh, dc = dhT, dcT
    for t in reversed(range(20)):
        c_prev = c0 if t == 0 else cs[:, :, t - 1].contiguous()
        dg, dx, dh, dc = lstm_kernel.lstm_layer_bwd_cuda(
            dhs[:, :, t:t + 1].contiguous(), dh, dc,
            gates[:, :, t:t + 1].contiguous(),
            cs[:, :, t:t + 1].contiguous(), c_prev, wx, wh)
        assert torch.equal(dg[:, :, 0], dgates[:, :, t])
        assert torch.equal(dx[:, :, 0], dxs[:, :, t])
    assert torch.equal(dh, dh0) and torch.equal(dc, dc0)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dim", [5, 64])
def test_cuda_backward_rows_do_not_depend_on_batch_or_workers(in_dim):
    """Rows of B = 8 launches == the same rows of a B = 64 launch, the
    rows of a W = 4 launch == four W = 1 launches, and three runs give
    the same bits."""
    _card()
    ts, _, gates, cs, cot = _card_case(1, 64, 20, in_dim, 64)
    args = (*cot, gates, cs, ts[2], ts[3], ts[4])
    out64 = lstm_kernel.lstm_layer_bwd_cuda(*args)
    for lo in range(0, 64, 8):
        rows = [a[:, lo:lo + 8].contiguous() for a in args[:6]]
        out8 = lstm_kernel.lstm_layer_bwd_cuda(*rows, *args[6:])
        assert all(torch.equal(a, b[:, lo:lo + 8])
                   for a, b in zip(out8, out64))
    ts, _, gates, cs, cot = _card_case(4, 32, 20, in_dim, 64, seed=7)
    args = (*cot, gates, cs, ts[2], ts[3], ts[4])
    out4 = lstm_kernel.lstm_layer_bwd_cuda(*args)
    for w in range(4):
        out1 = lstm_kernel.lstm_layer_bwd_cuda(*(a[w:w + 1] for a in args))
        assert all(torch.equal(a[0], b[w]) for a, b in zip(out1, out4))
    for _ in range(3):
        again = lstm_kernel.lstm_layer_bwd_cuda(*args)
        assert all(torch.equal(a, b) for a, b in zip(again, out4))


@pytest.mark.cuda
def test_cuda_backward_raises_instead_of_falling_back():
    """A launch CUDA refuses (W = 65536 blocks on the grid's second dim)
    raises and counts nothing; on the card the wrapper runs the
    Function (one launch each way) and no plain version."""
    _card()
    big = [torch.zeros((65536, 1, 1, 4), device="cuda"),
           torch.zeros((65536, 1, 1, 1), device="cuda"),
           torch.zeros((65536, 1, 1), device="cuda"),
           torch.zeros((65536, 1, 4), device="cuda"),
           torch.zeros((65536, 1, 4), device="cuda")]
    before = lstm_kernel.LAYER_BWD_LAUNCHES.total
    with pytest.raises(RuntimeError, match="launch failed"):
        lstm_kernel.lstm_layer_bwd_cuda(None, None, None, big[0], big[1],
                                        big[2], big[3], big[4])
    assert lstm_kernel.LAYER_BWD_LAUNCHES.total == before
    xs, h0, c0, wx, wh, b = (_t(a, "cuda").requires_grad_(True)
                             for a in _layer(1, 4, 3, 5, 16))
    with pytest.raises(TypeError, match="float32"):
        lstm_layer(xs.double(), h0, c0, wx, wh, b)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_layer(xs, h0, c0, wx, wh.transpose(1, 2).contiguous()
                   .transpose(1, 2), b)
    assert lstm_kernel.LAYER_BWD_LAUNCHES.total == before


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True], ids=["dense", "strided"])
@pytest.mark.parametrize("workers", [1, 4])
def test_cuda_layer_under_autograd_is_one_launch_each_way(workers, strided):
    """Under autograd the layer is one forward launch at T = window and
    one backward launch, from xs as the model gives it (a training batch
    may be a strided view): its outputs equal one no-grad launch
    bitwise, its gradients the plain layer's autograd; and the cell is
    the same Function at T = 1."""
    _card()
    T = 5
    arrays = _layer(workers, 8, T, 5, 16)
    args = [_t(a, "cuda") for a in arrays]
    if workers == 1:
        args = [a[0] for a in args]
    with torch.no_grad():
        want = lstm_layer(*args)
    t1 = [a.clone().requires_grad_(True) for a in args]
    xs = t1[0]
    if strided:
        xs = xs.transpose(-1, -2).contiguous().transpose(-1, -2)
        assert not xs.is_contiguous()
    fwd = lstm_kernel.LAUNCHES.total
    bwd = lstm_kernel.LAYER_BWD_LAUNCHES.total
    got = lstm_layer(xs, *t1[1:])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert lstm_kernel.LAUNCHES.total == fwd + 1
    g1 = torch.autograd.grad(got[0].sum() + got[2].sum(), t1)
    assert lstm_kernel.LAYER_BWD_LAUNCHES.total == bwd + 1
    assert lstm_kernel.LAYER_BWD_LAUNCHES.by_shape[(workers, 8, T, 5, 16)]
    t2 = [a.clone().requires_grad_(True) for a in args]
    hs, _, cT = lstm_layer_ref(*t2)
    g2 = torch.autograd.grad(hs.sum() + cT.sum(), t2)
    for name, a, b in zip(NAMES, g1, g2):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, msg=name)
    x1 = [a[..., 0, :].contiguous() if n == 0 else a
          for n, a in enumerate(t1)]
    h, c = lstm_cell(*x1)
    gc = torch.autograd.grad(h.sum() + c.sum(), t1[1:])
    assert lstm_kernel.LAYER_BWD_LAUNCHES.total == bwd + 2
    hr, cr = lstm_layer_ref(x1[0][..., None, :], *x1[1:])[1:]
    gr = torch.autograd.grad(hr.sum() + cr.sum(), t1[1:])
    for a, b in zip(gc, gr):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_local_step_gradients_match_cpu():
    """One W = 4 local step of the paper LSTM (full width, EVL on): its
    gradients through the Function on the card equal the CPU's plain
    path to TRAIN_RTOL of each leaf's largest entry, with exactly 2
    forward and 2 backward LSTM launches, both at T = window."""
    _card()
    from repro_torch.checkpoint.convert import params_to, stack_workers
    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.core.async_local_sgd import to_device, value_and_grad
    from repro_torch.data import load_stock, make_windows, train_test_split
    from repro_torch.models.rnn import init_rnn
    from repro_torch.training import loop
    from repro_torch.tree import tree_leaves

    train_ds = make_windows(train_test_split(load_stock("AAPL", n_days=400,
                                                        seed=0))[0])
    params = stack_workers(init_rnn(torch.Generator().manual_seed(0), CONFIG,
                                    device="cpu"), 4)
    idx = np.random.default_rng(0).permutation(len(train_ds))[:4 * 32]
    batch = tuple(np.stack(parts) for parts in zip(*(
        loop._batch_arrays(train_ds, idx[w * 32:(w + 1) * 32])
        for w in range(4))))
    loss_fn = loop._loss_fn_for(train_ds, CONFIG, 0.5)
    lstm_kernel.LAUNCHES.reset()
    lstm_kernel.LAYER_BWD_LAUNCHES.reset()
    loss_g, grads_g = value_and_grad(loss_fn, params_to(params, "cuda"),
                                     to_device(batch, "cuda"))
    torch.cuda.synchronize()
    T = CONFIG.window
    assert lstm_kernel.LAUNCHES.by_shape == {(4, 32, T, 5, 64): 1,
                                             (4, 32, T, 64, 64): 1}
    assert lstm_kernel.LAYER_BWD_LAUNCHES.by_shape == {
        (4, 32, T, 5, 64): 1, (4, 32, T, 64, 64): 1}
    loss_c, grads_c = value_and_grad(loss_fn, params, to_device(batch,
                                                                "cpu"))
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=TRAIN_RTOL, atol=0)
    for g, c in zip(tree_leaves(grads_g), tree_leaves(grads_c)):
        err = float((g.cpu() - c).abs().max() / c.abs().max())
        assert err <= TRAIN_RTOL
