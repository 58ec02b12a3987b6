"""Auxiliary indicator sequence, paper eq. (1).

    v_t =  1   if y_t >  eps1          (right extreme event)
    v_t =  0   if y_t in [-eps2, eps1] (normal event)
    v_t = -1   if y_t < -eps2          (left extreme event)
"""

from __future__ import annotations

import numpy as np
import torch


def indicator_sequence(y, eps1: float, eps2: float):
    """v_t per eq. (1) as int32. Thresholds must be positive."""
    if eps1 <= 0 or eps2 <= 0:
        raise ValueError("thresholds eps1, eps2 must be > 0")
    y = torch.as_tensor(y)
    v = torch.where(y > eps1, 1, torch.where(y < -eps2, -1, 0))
    return v.to(torch.int32)


def extreme_fractions(v) -> dict[str, float]:
    """beta_0 = P(v=0) (normal), P(v=1) (right), P(v=-1) (left): the
    event-class proportions that weight the EVL (eq. 6). Each is a count
    over n divided in float32, as the reference's ``jnp`` division is."""
    v = np.asarray(v)
    n = np.float32(v.size)
    return {"normal": float(np.float32(np.sum(v == 0)) / n),
            "right": float(np.float32(np.sum(v == 1)) / n),
            "left": float(np.float32(np.sum(v == -1)) / n)}


def quantile_thresholds(y, q: float = 0.95) -> tuple[float, float]:
    """Pick (eps1, eps2) from empirical tail quantiles (float32, linear
    interpolation, as ``jnp.quantile``), guarded to stay positive."""
    y = torch.as_tensor(y).to(torch.float32).reshape(-1)
    eps1 = float(torch.quantile(y, q, interpolation="linear"))
    eps2 = float(-torch.quantile(y, 1.0 - q, interpolation="linear"))
    # Guard: thresholds must be positive (eq. 1 requires large positive
    # constants); degenerate data falls back to a small epsilon.
    return max(eps1, 1e-6), max(eps2, 1e-6)
