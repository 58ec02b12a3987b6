"""Schedules from the paper (Table I / Remark 1). Plain Python, a copy of
``repro.core.schedules`` (the port imports nothing of the JAX package).

- Sample-size sequence  s_i = a * i^p + b   (paper: a=10, p=1, b=0)
  s_i is the number of local SGD recursions executed *globally* in
  communication round i; each of n nodes runs ceil(s_i / n).
- Diminishing step size  eta_i = eta0 / (1 + beta * sqrt(t))
  where t is the cumulative number of SGD iterations before round i.

The key property (Remark 1): for K total gradient computations the number
of communication rounds T satisfies K = sum_{j<=T} s_j, so with linear s_i
T ~ sqrt(2K/a) instead of T ~ K/s for a constant schedule — the paper's
communication-cost reduction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class SampleSchedule:
    """s_i = a * i^p + b, with i the 1-based communication round index."""

    a: float = 10.0
    p: float = 1.0
    b: float = 0.0
    minimum: int = 1

    def round_size(self, i: int) -> int:
        if i < 1:
            raise ValueError(f"round index must be >= 1, got {i}")
        return max(self.minimum, int(self.a * (i ** self.p) + self.b))

    def cumulative(self, i: int) -> int:
        """Total SGD iterations completed after round i."""
        return sum(self.round_size(j) for j in range(1, i + 1))

    def rounds_for_budget(self, k: int) -> int:
        """Smallest T with cumulative(T) >= k (number of communication
        rounds needed for K gradient computations)."""
        total, i = 0, 0
        while total < k:
            i += 1
            total += self.round_size(i)
        return i

    def sizes_for_budget(self, k: int) -> list[int]:
        """Round sizes covering exactly k iterations (last round clipped)."""
        sizes: list[int] = []
        total, i = 0, 0
        while total < k:
            i += 1
            s = min(self.round_size(i), k - total)
            sizes.append(s)
            total += s
        return sizes


@dataclasses.dataclass(frozen=True)
class ConstantSchedule(SampleSchedule):
    """Constant-size local SGD (the classical local-SGD baseline [15])."""

    size: int = 10

    def round_size(self, i: int) -> int:  # noqa: D102
        if i < 1:
            raise ValueError(f"round index must be >= 1, got {i}")
        return max(self.minimum, int(self.size))


@dataclasses.dataclass(frozen=True)
class StepSizeSchedule:
    """eta(t) = eta0 / (1 + beta * sqrt(t)) — paper Table I."""

    eta0: float = 0.01
    beta: float = 0.01

    def __call__(self, t) -> float:
        # Works for python ints and tensors alike.
        return self.eta0 / (1.0 + self.beta * (t ** 0.5))


def round_step_sizes(schedule: SampleSchedule, stepsize: StepSizeSchedule,
                     num_rounds: int) -> Iterator[tuple[int, float]]:
    """Yield (s_i, eta_i) pairs; eta_i is evaluated at the cumulative
    iteration count at the *start* of round i (paper's bar-eta_i)."""
    t = 0
    for i in range(1, num_rounds + 1):
        s = schedule.round_size(i)
        yield s, stepsize(t)
        t += s


def communication_rounds_constant(k: int, s: int) -> int:
    """Rounds for constant schedule: ceil(K / s)."""
    return math.ceil(k / s)
