"""The port's extreme-event math (``repro_torch.extreme``) against
``repro.extreme``, elementwise in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.extreme import evt as jevt
from repro.extreme import indicators as jind
from repro_torch.extreme import evt, indicators

RNG = np.random.default_rng(3)


@pytest.mark.parametrize("gamma", [0.0, 0.5, 2.0, 5.0])
def test_gev_matches_reference(gamma):
    y = RNG.uniform(-3.0, 8.0, 257).astype(np.float32)
    np.testing.assert_allclose(evt.gev_cdf(y, gamma).numpy(),
                               np.asarray(jevt.gev_cdf(y, gamma)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(evt.gev_log_cdf(y, gamma).numpy(),
                               np.asarray(jevt.gev_log_cdf(y, gamma)),
                               rtol=1e-5, atol=1e-6)


def test_tail_probability_matches_reference():
    y = RNG.uniform(0.0, 0.2, 100).astype(np.float32)
    got = evt.tail_probability(y, 0.05, 0.02, 0.05, 5.0)
    want = jevt.tail_probability(y, 0.05, 0.02, 0.05, 5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("n,q", [(380, 0.95), (1000, 0.9), (7, 0.5)])
def test_fit_tail_matches_reference(n, q):
    y = np.abs(RNG.standard_t(4, n)).astype(np.float32) * 0.01
    got, want = evt.fit_tail(y, q=q), jevt.fit_tail(y, q=q)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)


def test_quantile_thresholds_and_indicator_match_reference():
    y = (RNG.standard_normal(500) * 0.02).astype(np.float32)
    e1, e2 = indicators.quantile_thresholds(y, q=0.9)
    j1, j2 = jind.quantile_thresholds(y, q=0.9)
    np.testing.assert_allclose((e1, e2), (j1, j2), rtol=1e-6, atol=0)
    v = indicators.indicator_sequence(y, e1, e2)
    assert v.dtype == torch.int32
    np.testing.assert_array_equal(
        v.numpy(), np.asarray(jind.indicator_sequence(jnp.asarray(y), e1,
                                                      e2)))
    assert set(np.unique(v.numpy())) == {-1, 0, 1}
    with pytest.raises(ValueError):
        indicators.indicator_sequence(y, 0.0, 0.1)
    # degenerate data falls back to a small positive epsilon
    assert indicators.quantile_thresholds(np.zeros(10)) == (1e-6, 1e-6)
