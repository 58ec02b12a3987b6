"""Delay (staleness) models tau(t), Definition 1 of the paper: the port
of ``repro.core.delay`` (plain Python, no tensors).

Asynchronous SGD tolerates delays up to tau(t) ~ sqrt(t / ln t) for
strongly convex problems, far larger than network-induced delay, so
extra asynchrony can be introduced by design. The event-driven
simulator draws its network delays from ``NetworkDelay``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ConstantDelay:
    """tau(t) = tau: bounded staleness, the stacked-workers case."""

    tau: int = 1

    def __call__(self, t: int) -> int:
        return self.tau


@dataclasses.dataclass(frozen=True)
class SqrtLogDelay:
    """tau(t) = floor(c * sqrt(t / ln t)): the theoretical tolerance
    envelope, used to cap simulated staleness."""

    c: float = 1.0

    def __call__(self, t: int) -> int:
        if t < 3:
            return 1
        return max(1, int(self.c * math.sqrt(t / math.log(t))))


@dataclasses.dataclass(frozen=True)
class NetworkDelay:
    """Deterministic pseudo-random per-event delay in [lo, hi], modeling
    heterogeneous client and network latency in the simulator."""

    lo: int = 0
    hi: int = 2
    seed: int = 0

    def __call__(self, t: int) -> int:
        # splitmix64-style hash for determinism without global RNG state
        z = (t + self.seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        z = z ^ (z >> 31)
        return self.lo + z % (self.hi - self.lo + 1)


def check_consistent(applied_round: int, current_round: int, tau: int) -> bool:
    """Definition 1: the model used at round r must include all updates up
    to round r - tau(r)."""
    return applied_round >= current_round - tau
