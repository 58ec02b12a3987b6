"""The port's LSTM cell against the JAX package's: the plain PyTorch
version (what a CPU tensor runs) vs the Pallas kernel in interpret mode
and vs its jnp oracle, over the JAX kernel tests' shape sweep; the
device route and launch counter of the wrapper; and, on a card, the
hand-written CUDA kernel vs the plain version.

The JAX package is imported inside the parity test only, so that the
``cuda`` tests also run on a machine with a card and no jax:
``python -m pytest -q -m cuda tests/test_torch_lstm.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.lstm import kernel as lstm_kernel
from repro_torch.kernels.lstm.ops import lstm_cell
from repro_torch.kernels.lstm.ref import lstm_cell_ref

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
    before = lstm_kernel.LAUNCHES.total
    h, c = lstm_cell(*arrays)
    torch.cuda.synchronize()
    assert lstm_kernel.LAUNCHES.total == before + 1
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
