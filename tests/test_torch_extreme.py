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


def _returns():
    """The training windows' next-step returns and thresholds, as the
    paper's sensitivity study feeds the resamplers."""
    from repro.data import load_stock, make_windows, train_test_split

    tr, _ = train_test_split(load_stock("AAPL", n_days=400, seed=0))
    ds = make_windows(tr)
    return ds.returns, ds.eps1, ds.eps2


@pytest.mark.parametrize("seed", [None, 0, 7])
def test_resampling_matches_reference(seed):
    """The three strategies of the sensitivity study, array-equal to
    ``repro.extreme.resampling`` (the same numpy rng draws)."""
    from repro.extreme import resampling as jres
    from repro_torch.extreme import resampling

    targets, e1, e2 = _returns()
    rng = lambda: None if seed is None else np.random.default_rng(seed)
    np.testing.assert_array_equal(resampling.plain_windows(57, rng()),
                                  jres.plain_windows(57, rng()))
    for f in (0.1, 0.3, 0.6):
        got = resampling.oversample_extreme_windows(targets, e1, e2, f, rng())
        want = jres.oversample_extreme_windows(targets, e1, e2, f, rng())
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # data without extremes: every window once
    flat = np.zeros(33, np.float32)
    np.testing.assert_array_equal(
        resampling.oversample_extreme_windows(flat, e1, e2, rng=rng()),
        jres.oversample_extreme_windows(flat, e1, e2, rng=rng()))
    got = resampling.evl_sample_weights(targets, e1, e2)
    want = jres.evl_sample_weights(targets, e1, e2)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert sorted(resampling.RESAMPLERS) == sorted(jres.RESAMPLERS)
