"""Data pipeline, numpy copies of ``repro.data``: the synthetic
heavy-tailed OHLCV generator (seeded through hashlib, so it gives the
JAX package's arrays bit for bit), the S&P500 loader with its synthetic
fallback, sliding-window datasets, per-client splits, and the model
zoo's synthetic token streams."""

from repro_torch.data.synthetic import SyntheticStockConfig, generate_ohlcv
from repro_torch.data.sp500 import load_stock, train_test_split
from repro_torch.data.sharding import client_splits
from repro_torch.data.tokens import synthetic_token_batch
from repro_torch.data.windows import (WindowDataset, make_windows,
                                      normalize_windows)

__all__ = [
    "SyntheticStockConfig",
    "WindowDataset",
    "client_splits",
    "generate_ohlcv",
    "load_stock",
    "make_windows",
    "normalize_windows",
    "synthetic_token_batch",
    "train_test_split",
]
