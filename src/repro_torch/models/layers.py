"""Shared building blocks of the port's models (so far: the init)."""

from __future__ import annotations

import torch


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               device="cpu", scale: float | None = None):
    """LeCun-normal-ish init: std = scale / sqrt(fan_in). Drawn on the
    CPU from ``generator`` and then moved, so one seed gives the same
    weights on every device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = (scale if scale is not None else 1.0) / (fan_in ** 0.5)
    w = torch.randn(tuple(shape), generator=generator,
                    dtype=torch.float32) * std
    return w.to(dtype=dtype, device=device)
