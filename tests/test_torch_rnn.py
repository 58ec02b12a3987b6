"""The port's paper model (``repro_torch.models.rnn``) against
``repro.models.rnn`` on the JAX package's weights, passed through
``params_from_numpy``; and the port's own step == apply contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rnn as jrnn
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.models import rnn

CFG_J = jrnn.RNNConfig(input_dim=5, hidden=16, num_layers=2, fc_dims=(8, 4),
                       window=6, evl_head=True)
CFG = rnn.RNNConfig(input_dim=5, hidden=16, num_layers=2, fc_dims=(8, 4),
                    window=6, evl_head=True)
# 2 x T cells summed in XLA's order on one side and oneDNN's on the other
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def params():
    jparams = jrnn.init_rnn(jax.random.PRNGKey(0), CFG_J)
    npy = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_numpy(npy, device="cpu")


def _x(b, t, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (b, t, 5))).astype(np.float32)


def test_params_round_trip(params):
    jparams, tparams = params
    back = params_to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_t = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_t) == 14
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert tparams["lstm"][1]["wx"].shape == (16, 64)
    assert tparams["evl"]["w"].dtype == torch.float32


def test_init_rnn_structure_and_scale():
    ours = rnn.init_rnn(torch.Generator().manual_seed(0), CFG, device="cpu")
    theirs = jrnn.init_rnn(jax.random.PRNGKey(0), CFG_J)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), theirs)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == shapes
    b = ours["lstm"][0]["b"]
    assert torch.equal(b[16:32], torch.ones(16))          # forget bias
    assert torch.count_nonzero(b) == 16
    w = rnn.init_rnn(torch.Generator().manual_seed(1),
                     rnn.RNNConfig(hidden=256), device="cpu")["lstm"][1]["wh"]
    assert abs(float(w.std()) - 256 ** -0.5) < 0.01


def test_rnn_apply_matches_reference(params):
    jparams, tparams = params
    x = _x(4, 6)
    yj, uj = jrnn.rnn_apply(jparams, jnp.asarray(x), CFG_J)
    y, u = rnn.rnn_apply(tparams, torch.from_numpy(x), CFG)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=RTOL,
                               atol=ATOL)


def test_rnn_apply_padded_matches_reference(params):
    jparams, tparams = params
    x = _x(5, 8, seed=1)
    lengths = np.array([8, 3, 6, 1, 5], np.int32)
    yj, uj = jrnn.rnn_apply_padded(jparams, jnp.asarray(x),
                                   jnp.asarray(lengths), CFG_J)
    y, u = rnn.rnn_apply_padded(tparams, torch.from_numpy(x),
                                torch.from_numpy(lengths), CFG)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=RTOL,
                               atol=ATOL)
    # causal: the padded row equals the unpadded apply of its prefix
    y3, _ = rnn.rnn_apply(tparams, torch.from_numpy(x[1:2, :3]), CFG)
    np.testing.assert_allclose(y[1].item(), y3[0].item(), rtol=RTOL,
                               atol=ATOL)


def test_rnn_step_matches_reference_and_own_apply(params):
    jparams, tparams = params
    x = _x(3, 6, seed=2)
    jc = jrnn.init_rnn_carry(jparams, 3)
    tc = rnn.init_rnn_carry(tparams, 3)
    for t in range(6):
        yj, uj, jc = jrnn.rnn_step(jparams, jnp.asarray(x[:, t]), jc, CFG_J)
        y, u, tc = rnn.rnn_step(tparams, torch.from_numpy(x[:, t]), tc, CFG)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=RTOL,
                                   atol=ATOL)
    for (h, c), (hj, cj) in zip(tc, jc):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=RTOL,
                                   atol=ATOL)
    # inside the port: stepping a window == applying it, bitwise
    ya, ua = rnn.rnn_apply(tparams, torch.from_numpy(x), CFG)
    assert torch.equal(y, ya) and torch.equal(u, ua)


def test_stack_and_split_carries(params):
    _, tparams = params
    carries = [tuple((torch.full((1, 16), float(i)),
                      torch.full((1, 16), -float(i))) for _ in range(2))
               for i in range(3)]
    stacked = rnn.stack_rnn_carries(carries, pad_to=8)
    assert stacked[0][0].shape == (8, 16)
    assert torch.equal(stacked[1][1][2], torch.full((16,), -2.0))
    assert torch.count_nonzero(stacked[0][0][3:]) == 0
    back = rnn.split_rnn_carry(stacked, 3)
    assert all(torch.equal(a[1][0], b[1][0]) for a, b in zip(back, carries))
    with pytest.raises(ValueError):
        rnn.stack_rnn_carries(carries, pad_to=2)
    assert rnn.init_rnn_carry(tparams, 4)[1][0].shape == (4, 16)
