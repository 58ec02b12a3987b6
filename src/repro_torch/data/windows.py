"""Sliding-window dataset construction (paper Table I: window = 20).

Windows are built over *normalized* features; the prediction target is the
next-step normalized close price (regression) plus the extreme-event
indicator of the next-step *return* (classification head for EVL).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.extreme.indicators import indicator_sequence


def normalize_windows(windows: np.ndarray) -> np.ndarray:
    """Per-window normalization w[i] -> w[i]/w[0] - 1 (the standard scheme
    of the paper's data-source repo): removes scale, keeps shape."""
    base = windows[:, :1, :]
    return (windows / np.maximum(np.abs(base), 1e-8) - 1.0).astype(np.float32)


@dataclasses.dataclass
class WindowDataset:
    x: np.ndarray          # [N, window, features]  normalized windows
    y: np.ndarray          # [N]                    next-step normalized close
    v: np.ndarray          # [N] int32              extreme indicator of next return
    returns: np.ndarray    # [N]                    raw next-step log return
    eps1: float
    eps2: float

    def __len__(self) -> int:
        return len(self.x)

    def batches(self, batch_size: int, rng: np.random.Generator | None = None,
                indices: np.ndarray | None = None, drop_last: bool = True):
        idx = np.arange(len(self.x)) if indices is None else np.asarray(indices)
        if rng is not None:
            idx = idx.copy()
            rng.shuffle(idx)
        end = (len(idx) // batch_size) * batch_size if drop_last else len(idx)
        for s in range(0, end, batch_size):
            b = idx[s:s + batch_size]
            yield self.x[b], self.y[b], self.v[b]


def make_windows(ohlcv: np.ndarray, window: int = 20,
                 quantile: float = 0.95,
                 eps: tuple[float, float] | None = None) -> WindowDataset:
    """Build the sliding-window dataset from [T, 5] OHLCV.

    Features: normalized OHLCV window. Target: next-day normalized close.
    Extreme labels: indicator of next-day log return vs (eps1, eps2)
    thresholds (defaults: 95% quantiles of |returns| — how [2] sets them).
    """
    close = ohlcv[:, 3]
    logret = np.diff(np.log(np.maximum(close, 1e-8))).astype(np.float32)
    n = len(ohlcv) - window  # windows [t, t+window) predicting index t+window
    if n <= 0:
        raise ValueError(f"series of length {len(ohlcv)} too short for "
                         f"window {window}")
    wins = np.stack([ohlcv[t:t + window] for t in range(n)], axis=0)
    xw = normalize_windows(wins)
    # target: next close normalized by window base
    base = np.maximum(np.abs(wins[:, 0, 3]), 1e-8)
    y = (close[window:window + n] / base - 1.0).astype(np.float32)
    next_ret = logret[window - 1:window - 1 + n]
    if eps is None:
        a = np.abs(logret)
        eps1 = float(np.quantile(a, quantile))
        eps2 = eps1
    else:
        eps1, eps2 = eps
    v = np.asarray(indicator_sequence(next_ret, eps1, eps2))
    return WindowDataset(x=xw, y=y, v=v, returns=next_ret,
                         eps1=eps1, eps2=eps2)
