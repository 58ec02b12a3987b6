"""The port's numpy data pipeline (``repro_torch.data``) gives the JAX
package's arrays exactly: same hashlib-derived seeds, same windows."""

import numpy as np
import pytest

from repro import data as jdata
from repro_torch import data


@pytest.mark.parametrize("ticker,seed,n_days", [("AAPL", 0, 400),
                                                ("CLIENT3", 3, 84),
                                                ("AMZN", 7, 1430)])
def test_generate_ohlcv_is_array_equal(ticker, seed, n_days):
    got = data.generate_ohlcv(ticker, data.SyntheticStockConfig(
        n_days=n_days, seed=seed))
    want = jdata.generate_ohlcv(ticker, jdata.SyntheticStockConfig(
        n_days=n_days, seed=seed))
    assert got.dtype == np.float32 and got.shape == (n_days, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window,eps", [(20, None), (6, (0.01, 0.02))])
def test_make_windows_is_array_equal(window, eps):
    ohlcv = data.load_stock("AAPL", n_days=300)
    np.testing.assert_array_equal(ohlcv, jdata.load_stock("AAPL",
                                                          n_days=300))
    got = data.make_windows(ohlcv, window=window, eps=eps)
    want = jdata.make_windows(ohlcv, window=window, eps=eps)
    for field in ("x", "y", "v", "returns"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert (got.eps1, got.eps2) == (want.eps1, want.eps2)
    assert got.v.dtype == want.v.dtype == np.int32
    with pytest.raises(ValueError):
        data.make_windows(ohlcv[:window], window=window)


def test_split_and_normalize_match():
    ohlcv = data.load_stock("IBM", n_days=120, seed=2)
    for a, b in zip(data.train_test_split(ohlcv, 0.7),
                    jdata.train_test_split(ohlcv, 0.7)):
        np.testing.assert_array_equal(a, b)
    wins = np.stack([ohlcv[t:t + 10] for t in range(5)])
    np.testing.assert_array_equal(data.normalize_windows(wins),
                                  jdata.normalize_windows(wins))
