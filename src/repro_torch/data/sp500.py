"""S&P500 loader with synthetic fallback.

The paper uses the CSV from jaungiers/LSTM-Neural-Network-for-Time-Series-
Prediction (OHLCV, Jan 2012 - Sep 2017), split 2012-2014 train / 2015-2016
test, tickers GOOGL, FB, AAPL, AMZN, IBM, NFLX, EBAY (results reported for
AAPL, AMZN). Offline container: if ``data/<ticker>.csv`` exists we parse
it; otherwise a calibrated synthetic series is generated (see synthetic.py
and its docstring).
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch.data.synthetic import SyntheticStockConfig, generate_ohlcv

PAPER_TICKERS = ("GOOGL", "FB", "AAPL", "AMZN", "IBM", "NFLX", "EBAY")
_COLUMNS = ("Open", "High", "Low", "Close", "Volume")


def _parse_csv(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        header = f.readline().strip().split(",")
        idx = []
        for col in _COLUMNS:
            for j, name in enumerate(header):
                if name.strip().lower() == col.lower():
                    idx.append(j)
                    break
        if len(idx) != 5:
            raise ValueError(f"{path}: could not find OHLCV columns in {header}")
        for line in f:
            parts = line.strip().split(",")
            if len(parts) <= max(idx):
                continue
            try:
                rows.append([float(parts[j]) for j in idx])
            except ValueError:
                continue
    if not rows:
        raise ValueError(f"{path}: no data rows parsed")
    return np.asarray(rows, np.float32)


def load_stock(ticker: str = "AAPL", data_dir: str = "data",
               n_days: int = 1430, seed: int = 0) -> np.ndarray:
    """[n_days, 5] OHLCV. Real CSV if present, else deterministic synthetic."""
    path = os.path.join(data_dir, f"{ticker}.csv")
    if os.path.exists(path):
        return _parse_csv(path)
    generic = os.path.join(data_dir, "sp500.csv")
    if os.path.exists(generic):
        return _parse_csv(generic)
    return generate_ohlcv(ticker, SyntheticStockConfig(n_days=n_days, seed=seed))


def train_test_split(series: np.ndarray,
                     train_fraction: float = 0.6) -> tuple[np.ndarray, np.ndarray]:
    """Chronological split — the paper uses 2012-2014 train (~60%) and
    2015-2016 test. Never shuffle before splitting a time series."""
    n = len(series)
    cut = int(n * train_fraction)
    return series[:cut], series[cut:]
