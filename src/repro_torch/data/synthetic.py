"""Synthetic heavy-tailed OHLCV generator.

The paper trains on S&P500 constituents (AAPL, AMZN, ...) 2012-2017 —
daily OHLCV. Offline here, so we synthesize a series with the stylized
facts that matter for the paper's questions:

- heavy-tailed daily returns (Student-t shocks, nu ~ 3-5): extreme events
  have non-negligible probability (paper §II.A);
- volatility clustering (GARCH(1,1)-style variance recursion): extremes
  arrive in bursts, stressing the imbalanced-sampling strategies;
- occasional jumps (compound-Poisson): the "stock market crash" events;
- a slow drift + regime trend so the LSTM has learnable structure.

Deterministic per (ticker, seed): the ticker string hashes into the seed,
so "AAPL" and "AMZN" give distinct but reproducible series.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticStockConfig:
    n_days: int = 1430            # ~ Jan 2012..Sep 2017 of trading days
    s0: float = 100.0             # initial price
    mu: float = 0.0004            # daily drift
    # GARCH(1,1) variance: sig2_{t+1} = w + alpha * r_t^2 + beta * sig2_t
    garch_omega: float = 2e-6
    garch_alpha: float = 0.10
    garch_beta: float = 0.87
    student_nu: float = 4.0       # heavy-tail dof for shocks
    jump_prob: float = 0.01       # daily jump (crash/rally) probability
    jump_scale: float = 0.04      # jump magnitude scale
    seed: int = 0


def _ticker_seed(ticker: str, seed: int) -> int:
    h = hashlib.sha256(f"{ticker}:{seed}".encode()).digest()
    return int.from_bytes(h[:8], "little") % (2**31)


def generate_ohlcv(ticker: str = "AAPL",
                   config: SyntheticStockConfig | None = None) -> np.ndarray:
    """Return float32 [n_days, 5] array: Open, High, Low, Close, Volume."""
    cfg = config or SyntheticStockConfig()
    rng = np.random.default_rng(_ticker_seed(ticker, cfg.seed))

    n = cfg.n_days
    sig2 = np.empty(n)
    ret = np.empty(n)
    sig2[0] = cfg.garch_omega / max(1e-9, (1 - cfg.garch_alpha - cfg.garch_beta))
    # Student-t shocks normalized to unit variance
    t_shocks = rng.standard_t(cfg.student_nu, size=n)
    t_shocks /= np.sqrt(cfg.student_nu / (cfg.student_nu - 2.0))
    jumps = (rng.random(n) < cfg.jump_prob) * rng.normal(
        0.0, cfg.jump_scale, size=n)
    for t in range(n):
        ret[t] = cfg.mu + np.sqrt(sig2[t]) * t_shocks[t] + jumps[t]
        if t + 1 < n:
            sig2[t + 1] = (cfg.garch_omega + cfg.garch_alpha * ret[t] ** 2
                           + cfg.garch_beta * sig2[t])

    close = cfg.s0 * np.exp(np.cumsum(ret))
    open_ = np.empty(n)
    open_[0] = cfg.s0
    open_[1:] = close[:-1] * np.exp(rng.normal(0, 0.002, size=n - 1))
    intra = np.abs(rng.normal(0, 0.5, size=n)) * np.sqrt(sig2) * close
    high = np.maximum(open_, close) + intra
    low = np.minimum(open_, close) - intra
    low = np.maximum(low, 1e-3)
    # volume spikes with |return| (well-documented stylized fact)
    volume = 1e6 * np.exp(rng.normal(0, 0.3, size=n)) * (
        1.0 + 25.0 * np.abs(ret))
    return np.stack([open_, high, low, close, volume], axis=1).astype(np.float32)


def log_returns(close: np.ndarray) -> np.ndarray:
    close = np.asarray(close, np.float64)
    return np.diff(np.log(close)).astype(np.float32)
