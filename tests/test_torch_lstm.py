"""The port's LSTM cell against the JAX package's: the plain PyTorch
version (what a CPU tensor runs) vs the Pallas kernel in interpret mode
and vs its jnp oracle, over the JAX kernel tests' shape sweep; its
gradient vs ``jax.grad``; the worker-stacked form; the device route and
launch counter of the wrapper; and, on a card, the layer kernel
(``lstm_layer.cu``) vs the plain version over T steps from a zero or a
given carry and as the cell at T = 1, and its bits (a T-step launch ==
T chained launches at T = 1; rows independent of B and W; the same on
every run). The backward, the cell's at T = 1 included, is in
``tests/test_torch_lstm_layer_bwd.py``.

The JAX package is imported inside the parity test only, so that the
``cuda`` tests also run on a machine with a card and no jax:
``python -m pytest -q -m cuda tests/test_torch_lstm.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.lstm import kernel as lstm_kernel
from repro_torch.kernels.lstm.ops import lstm_cell, lstm_layer
from repro_torch.kernels.lstm.ref import lstm_cell_ref, lstm_layer_ref

RTOL, ATOL = 1e-5, 1e-6      # tests/test_kernels.py's LSTM tolerance

# tests/test_kernels.py's sweep, odd shapes included
SHAPES = [(1, 5, 64), (13, 5, 64), (32, 7, 32), (8, 16, 128), (3, 9, 24),
          (7, 3, 40), (1, 1, 8), (9, 11, 48), (5, 5, 16)]


def _inputs(batch, in_dim, hidden, seed=42):
    rng = np.random.default_rng(seed + batch * 1000 + in_dim * 10 + hidden)
    f = np.float32
    return (rng.standard_normal((batch, in_dim)).astype(f),
            rng.standard_normal((batch, hidden)).astype(f),
            rng.standard_normal((batch, hidden)).astype(f),
            (0.1 * rng.standard_normal((in_dim, 4 * hidden))).astype(f),
            (0.1 * rng.standard_normal((hidden, 4 * hidden))).astype(f),
            (0.1 * rng.standard_normal(4 * hidden)).astype(f))


@pytest.mark.parametrize("batch,in_dim,hidden", SHAPES)
def test_plain_cell_matches_pallas_kernel_and_oracle(batch, in_dim, hidden):
    import jax.numpy as jnp

    from repro.kernels.lstm.ops import lstm_cell_fused
    from repro.kernels.lstm.ref import lstm_cell_ref as jax_cell_ref

    arrays = _inputs(batch, in_dim, hidden)
    h, c = lstm_cell(*map(torch.from_numpy, arrays))
    hk, ck = lstm_cell_fused(*map(jnp.asarray, arrays))
    hr, cr = jax_cell_ref(*map(jnp.asarray, arrays))
    for got, want in ((h, hk), (c, ck), (h, hr), (c, cr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def _stacked(workers, batch, in_dim, hidden, seed=42):
    """Worker-stacked inputs: every operand with a leading W."""
    per = [_inputs(batch, in_dim, hidden, seed=seed + 7 * w)
           for w in range(workers)]
    return [np.stack(parts) for parts in zip(*per)]


def _cotangents(shape, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("batch,in_dim,hidden", SHAPES[:5])
def test_plain_cell_gradient_matches_jax_grad(batch, in_dim, hidden):
    """torch autograd through the plain cell (the CPU training path)
    against jax.grad of the JAX package's cell, for every operand."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.lstm.ref import lstm_cell_ref as jax_cell_ref

    arrays = _inputs(batch, in_dim, hidden)
    dh, dc = _cotangents((batch, hidden))

    def jloss(*args):
        h, c = jax_cell_ref(*args[:5], args[5][None])
        return jnp.sum(h * dh) + jnp.sum(c * dc)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray,
                                                         arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    h, c = dispatch.lstm_cell(*ts)
    got = torch.autograd.grad((h, c), ts, (torch.from_numpy(dh),
                                           torch.from_numpy(dc)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape),
                                   rtol=RTOL, atol=ATOL)


def test_stacked_cell_rows_equal_unstacked_cells():
    """The worker-stacked form is W independent cells."""
    arrays = [torch.from_numpy(a) for a in _stacked(3, 4, 5, 16)]
    hs, cs = lstm_cell(*arrays)
    for w in range(3):
        h1, c1 = lstm_cell(*(a[w] for a in arrays))
        torch.testing.assert_close(hs[w], h1, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(cs[w], c1, rtol=RTOL, atol=ATOL)


def test_cpu_tensor_takes_plain_route_and_launches_nothing():
    arrays = [torch.from_numpy(a) for a in _inputs(4, 5, 16)]
    lstm_kernel.LAUNCHES.reset()
    h, c = dispatch.lstm_cell(*arrays)
    hr, cr = lstm_cell_ref(*arrays)
    assert torch.equal(h, hr) and torch.equal(c, cr)
    assert lstm_kernel.LAUNCHES.total == 0
    assert dispatch.impl_for("cpu") == "torch"
    assert dispatch.impl_for("cuda:0") == "cuda"


def test_wrapper_rejects_bad_shapes_and_mixed_devices():
    x, h, c, wx, wh, b = [torch.from_numpy(a) for a in _inputs(2, 5, 8)]
    with pytest.raises(ValueError, match="wh must be"):
        lstm_cell(x, h, c, wx, wh[:, :-1], b)
    with pytest.raises(ValueError, match="x \\[B, I\\]"):
        lstm_cell(x[0], h, c, wx, wh, b)
    with pytest.raises(ValueError, match="one device"):
        lstm_cell(x, h, c, wx, wh, b.to("meta"))
    with pytest.raises(ValueError, match="b must be"):
        lstm_cell(x[None], h[None], c[None], wx[None], wh[None], b)


def test_dispatch_counting_records_device_and_route():
    with dispatch.counting() as outer:
        with dispatch.counting() as inner:
            dispatch.record("predict", batch=8, hidden=64, device="cpu")
        dispatch.record("slots_generate", batch=64, hidden=64,
                        device="cuda")
    assert inner.by_op() == {"predict": 1}
    assert outer["predict"] == 1 and outer["slots_generate"] == 1
    assert ("cuda", "slots_generate", "cuda", (64, 64)) in outer.counts
    assert ("cpu", "predict", "torch", (8, 64)) in outer.counts
    dispatch.record("predict", batch=8, hidden=64, device="cpu")
    assert outer.total() == 2                 # collector uninstalled


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,in_dim,hidden",
                         SHAPES + [(8, 5, 64), (8, 64, 64), (64, 64, 64)])
def test_cuda_kernel_matches_plain_version(batch, in_dim, hidden):
    _card()
    arrays = [torch.from_numpy(a).cuda()
              for a in _inputs(batch, in_dim, hidden)]
    before = lstm_kernel.LAUNCHES.by_shape.get((1, batch, 1, in_dim,
                                                hidden), 0)
    h, c = lstm_cell(*arrays)
    torch.cuda.synchronize()
    # the cell is the layer kernel at W = 1, T = 1
    assert lstm_kernel.LAUNCHES.by_shape[(1, batch, 1, in_dim,
                                          hidden)] == before + 1
    hr, cr = lstm_cell_ref(*arrays)
    torch.testing.assert_close(h, hr, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(c, cr, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dim", [5, 64])
def test_cuda_kernel_rows_do_not_depend_on_batch(in_dim):
    _card()
    x, h, c, wx, wh, b = [torch.from_numpy(a).cuda()
                          for a in _inputs(64, in_dim, 64)]
    h64, c64 = lstm_cell(x, h, c, wx, wh, b)
    for lo in range(0, 64, 8):
        rows = slice(lo, lo + 8)
        h8, c8 = lstm_cell(x[rows].contiguous(), h[rows].contiguous(),
                           c[rows].contiguous(), wx, wh, b)
        assert torch.equal(h8, h64[rows]) and torch.equal(c8, c64[rows])


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back():
    _card()
    x, h, c, wx, wh, b = [torch.from_numpy(a).cuda()
                          for a in _inputs(4, 5, 16)]
    before = lstm_kernel.LAUNCHES.total
    with pytest.raises(TypeError, match="float32"):
        lstm_cell(x.double(), h, c, wx, wh, b)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cell(x, h, c, wx, wh.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="one device"):
        lstm_cell(x, h, c, wx, wh, b.cpu())
    assert lstm_kernel.LAUNCHES.total == before


# (W, B, T, I, H) of the layer kernel: the sweep over a window, and the
# paths' own: a predict flush (B 32, T 20), a replay at the decode width
# (B 8), a training step (W 4, T 20) and the cell under autograd (W 4,
# T 1); layer 1 (I 5) and layer 2 (I 64)
LAYER_SHAPES = ([(1, B, 20, I, H) for B, I, H in SHAPES]
                + [(1, 32, 20, 5, 64), (1, 32, 20, 64, 64), (4, 32, 20, 5, 64),
                   (4, 32, 20, 64, 64), (4, 32, 1, 5, 64), (4, 32, 1, 64, 64),
                   (1, 8, 20, 5, 64)])


def _layer_inputs(W, B, T, I, H, carry=True, seed=11):
    """Worker-stacked layer inputs on the card, from a numpy seed; a zero
    carry unless ``carry``."""
    rng = np.random.default_rng(seed + W * 7 + B * 1000 + T * 100 + I * 10
                                + H)

    def r(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).cuda()

    xs, h0, c0 = r(W, B, T, I), r(W, B, H), r(W, B, H)
    if not carry:
        h0, c0 = torch.zeros_like(h0), torch.zeros_like(c0)
    return (xs, h0, c0, r(W, I, 4 * H, scale=0.1), r(W, H, 4 * H, scale=0.1),
            r(W, 4 * H, scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("carry", [False, True], ids=["zero", "carry"])
@pytest.mark.parametrize("workers,batch,steps,in_dim,hidden", LAYER_SHAPES)
def test_cuda_layer_matches_plain_version(workers, batch, steps, in_dim,
                                          hidden, carry):
    """One launch of the layer kernel against the plain layer: hs, hT and
    cT; the unstacked (serving) form at W = 1."""
    _card()
    args = _layer_inputs(workers, batch, steps, in_dim, hidden, carry)
    if workers == 1:
        args = tuple(a[0] for a in args)
    before = lstm_kernel.LAUNCHES.total
    got = lstm_layer(*args)
    torch.cuda.synchronize()
    assert lstm_kernel.LAUNCHES.total == before + 1
    for a, b in zip(got, lstm_layer_ref(*args)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dim", [5, 64])
def test_cuda_layer_steps_equal_chained_single_steps(in_dim):
    """Step t of one T = 20 launch == 20 launches at T = 1 chained through
    (hT, cT), bitwise, whether through the layer or the cell wrapper."""
    _card()
    xs, h0, c0, wx, wh, b = (a[0] for a in _layer_inputs(1, 32, 20, in_dim,
                                                         64))
    hs, hT, cT = lstm_layer(xs, h0, c0, wx, wh, b)
    h, c = h0, c0
    hc, cc = h0, c0
    for t in range(20):
        x_t = xs[:, t].contiguous()
        hl, h, c = lstm_layer(x_t[:, None], h, c, wx, wh, b)
        hc, cc = lstm_cell(x_t, hc, cc, wx, wh, b)
        assert torch.equal(hs[:, t], hl[:, 0]) and torch.equal(hs[:, t], hc)
    assert torch.equal(hT, h) and torch.equal(cT, c)
    assert torch.equal(hT, hc) and torch.equal(cT, cc)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dim", [5, 64])
def test_cuda_layer_rows_do_not_depend_on_batch_or_workers(in_dim):
    """Rows of B = 8 launches == the same rows of a B = 64 launch, and
    the rows of a W = 4 launch == four W = 1 launches, bitwise, over a
    window of 20 steps."""
    _card()
    xs, h0, c0, wx, wh, b = (a[0] for a in _layer_inputs(1, 64, 20, in_dim,
                                                         64))
    out64 = lstm_layer(xs, h0, c0, wx, wh, b)
    for lo in range(0, 64, 8):
        rows = slice(lo, lo + 8)
        out8 = lstm_layer(xs[rows].contiguous(), h0[rows].contiguous(),
                          c0[rows].contiguous(), wx, wh, b)
        assert all(torch.equal(a, b[rows]) for a, b in zip(out8, out64))
    args = _layer_inputs(4, 32, 20, in_dim, 64, seed=3)
    out4 = lstm_layer(*args)
    for w in range(4):
        out1 = lstm_layer(*(a[w] for a in args))
        assert all(torch.equal(a, b[w]) for a, b in zip(out1, out4))


@pytest.mark.cuda
def test_cuda_layer_is_the_same_on_every_run():
    _card()
    args = _layer_inputs(4, 32, 20, 64, 64)
    first = lstm_layer(*args)
    for _ in range(3):
        assert all(torch.equal(a, b)
                   for a, b in zip(lstm_layer(*args), first))


@pytest.mark.cuda
def test_cuda_layer_raises_instead_of_falling_back():
    """A launch CUDA refuses (W = 65536 blocks on the grid's second
    dim, one more than it takes), a wrong dtype and a non-contiguous
    input each raise, and count no launch."""
    _card()
    xs, h0, c0, wx, wh, b = _layer_inputs(1, 4, 3, 5, 16)
    big = [torch.zeros((65536,) + tuple(t.shape[1:]), device="cuda")
           for t in _layer_inputs(1, 1, 1, 1, 1)]
    before = lstm_kernel.LAUNCHES.total
    with pytest.raises(RuntimeError, match="launch failed"):
        lstm_layer(*big)
    with pytest.raises(TypeError, match="float32"):
        lstm_layer(xs.double(), h0, c0, wx, wh, b)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_layer(xs.transpose(1, 2).contiguous().transpose(1, 2), h0, c0,
                   wx, wh, b)
    assert lstm_kernel.LAUNCHES.total == before


# one launch of the layer kernel per (I, H) given on the command line,
# under the profiler; prints each launch's shared memory from the trace
_SMEM_PROBE = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.lstm.ops import lstm_layer

shapes, trace = json.loads(sys.argv[1]), sys.argv[2]
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for I, H in shapes:
        lstm_layer(torch.zeros(4, 2, I, device="cuda"),
                   *(torch.zeros(4, H, device="cuda") for _ in range(2)),
                   torch.zeros(I, 4 * H, device="cuda"),
                   torch.zeros(H, 4 * H, device="cuda"),
                   torch.zeros(4 * H, device="cuda"))
    torch.cuda.synchronize()
prof.export_chrome_trace(trace)
with open(trace) as f:
    events = json.load(f)["traceEvents"]
launches = sorted((e for e in events if e.get("cat") == "kernel"
                   and "lstm_layer_kernel" in e.get("name", "")),
                  key=lambda e: e["ts"])
print(json.dumps([e["args"]["shared memory"] for e in launches]))
"""


@pytest.mark.cuda
def test_cuda_layer_keeps_the_models_weights_resident(tmp_path):
    """The paper's layers (I 5 and 64, H 64) launch with more shared
    memory than wx | wh take, K x 4H x 4 bytes: the weights are resident;
    the sweep's H 128 at I 16 does not fit and launches with less,
    reading them from device memory in the same kernel. Read from each
    launch's shared memory in a profiler trace, taken in a process of
    its own: a profile taken in the test process left a later test's
    profile there without device events."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    _card()
    shapes = [(5, 64), (64, 64), (16, 128)]
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [src, os.environ.get("PYTHONPATH")]))}
    run = subprocess.run([sys.executable, "-c", _SMEM_PROBE,
                          json.dumps(shapes), str(tmp_path / "trace.json")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    smem = json.loads(run.stdout.splitlines()[-1])
    weights = [(I + H) * 4 * H * 4 for I, H in shapes]
    assert len(smem) == 3
    assert smem[0] > weights[0] and smem[1] > weights[1]
    assert smem[2] < weights[2]


@pytest.mark.cuda
@pytest.mark.parametrize("in_dim", [5, 64])
def test_cuda_worker_rows_equal_single_worker_launches(in_dim):
    """The rows of a W = 4 launch equal four W = 1 launches bitwise, and
    the unstacked (serving) form is the W = 1 launch."""
    _card()
    arrays = [torch.from_numpy(a).cuda() for a in _stacked(4, 32, in_dim, 64)]
    h4, c4 = lstm_cell(*arrays)
    for w in range(4):
        one = [a[w:w + 1] for a in arrays]
        h1, c1 = lstm_cell(*one)
        hu, cu = lstm_cell(*(a[w] for a in arrays))
        assert torch.equal(h1[0], h4[w]) and torch.equal(c1[0], c4[w])
        assert torch.equal(hu, h4[w]) and torch.equal(cu, c4[w])
