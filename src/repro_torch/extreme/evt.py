"""Extreme Value Theory, paper eqs. (2)-(4).

Generalized Extreme Value distribution (eq. 3):

    G(y) = exp(-(1 - y/gamma)^gamma)   gamma != 0, 1 - y/gamma > 0
    G(y) = exp(-exp(-y))               gamma == 0   (Gumbel)

Tail modeling (eq. 4):

    1 - F(y) ~ (1 - F(xi)) * [1 - log G((y - xi) / f(xi))],  y > xi

Functions take tensors (kept on their device) or array-likes (made
float32 CPU tensors), and compute in float32 as the JAX package does.
"""

from __future__ import annotations

import torch


def _f32(y):
    if isinstance(y, torch.Tensor):
        return y.to(torch.float32)
    return torch.as_tensor(y, dtype=torch.float32)


def gev_log_cdf(y, gamma: float):
    """log G(y) for the GEV parameterization of eq. (3)."""
    y = _f32(y)
    if gamma == 0.0:
        return -torch.exp(-y)
    base = 1.0 - y / gamma
    # outside the support (base <= 0) the cdf saturates; clamp for safety.
    base = torch.clamp_min(base, 1e-12)
    return -(base ** gamma)


def gev_cdf(y, gamma: float):
    return torch.exp(gev_log_cdf(y, gamma))


def tail_probability(y, xi: float, scale: float, tail_at_xi: float,
                     gamma: float):
    """eq. (4): P(Y > y) for y > xi, using the GEV tail approximation.

    Args:
        y: query points (> xi for the approximation to be meaningful).
        xi: sufficiently large threshold.
        scale: the positive scale function value f(xi).
        tail_at_xi: empirical 1 - F(xi).
        gamma: extreme value index.
    """
    z = (_f32(y) - xi) / scale
    return tail_at_xi * (1.0 - gev_log_cdf(z, gamma))


def fit_tail(y, q: float = 0.95) -> dict[str, float]:
    """Moment-style tail fit: xi at the q-quantile (float32, linear
    interpolation, as ``jnp.quantile``), scale as the mean excess over
    xi. Returns the parameters consumed by ``tail_probability``."""
    y = _f32(y).reshape(-1)
    xi = torch.quantile(y, q, interpolation="linear")
    over = y > xi
    excess = torch.where(over, y - xi, torch.zeros_like(y))
    n_tail = max(int(over.sum()), 1)
    scale = torch.sum(excess) / n_tail
    return {
        "xi": float(xi),
        "scale": float(torch.clamp_min(scale, 1e-8)),
        "tail_at_xi": float(n_tail / y.numel()),
    }
