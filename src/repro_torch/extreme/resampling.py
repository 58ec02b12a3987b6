"""Imbalanced-data handling strategies, the paper's sensitivity study
(section I, IV.C task 1): the port of ``repro.extreme.resampling``.

Three strategies over sliding-window samples:

1. ``plain_windows``: standard sliding-window sampling (risk:
   underfitting on extremes; they are rare).
2. ``oversample_extreme_windows``: duplicate windows whose target is an
   extreme event until they reach a target fraction (the paper's
   "duplicate the extreme events to break the imbalanced barrier";
   risk: overfit).
3. ``evl_sample_weights``: keep the sample distribution, reweight the
   loss per sample with EVL-style class weights (the trainers'
   ``weights``).

All are numpy on the host and deterministic given a seed.
"""

from __future__ import annotations

import numpy as np

from repro_torch.extreme.indicators import indicator_sequence


def plain_windows(n_windows: int, rng: np.random.Generator | None = None):
    """Identity sampling: every window once, order shuffled if rng given."""
    idx = np.arange(n_windows)
    if rng is not None:
        rng.shuffle(idx)
    return idx


def oversample_extreme_windows(targets: np.ndarray, eps1: float, eps2: float,
                               target_fraction: float = 0.3,
                               rng: np.random.Generator | None = None):
    """Window indices with extreme-target windows duplicated until they
    make up ``target_fraction`` of the epoch (or all windows if the data
    has no extremes)."""
    v = indicator_sequence(targets, eps1, eps2).numpy()
    extreme = np.nonzero(v != 0)[0]
    normal = np.nonzero(v == 0)[0]
    if extreme.size == 0 or normal.size == 0:
        return plain_windows(len(targets), rng)
    # solve for the duplication count d: d*E / (d*E + N) >= f
    f = target_fraction
    dup = max(1, int(np.ceil(f * normal.size / ((1 - f) * extreme.size))))
    idx = np.concatenate([normal] + [extreme] * dup)
    if rng is not None:
        rng.shuffle(idx)
    return idx


def evl_sample_weights(targets: np.ndarray, eps1: float, eps2: float,
                       gamma: float = 2.0) -> np.ndarray:
    """Per-window loss weights from the event-class proportions: normal
    windows get beta1 (small), extreme windows beta0 (large), the
    sampling-free counterpart of the EVL reweighting."""
    v = indicator_sequence(targets, eps1, eps2).numpy()
    beta0 = float(np.mean(v == 0))
    beta1 = float(np.mean(v != 0))
    beta1 = max(beta1, 1e-6)
    w = np.where(v != 0, beta0, beta1).astype(np.float32)
    # normalize to mean 1 so learning rates stay comparable across methods
    return w / max(w.mean(), 1e-12)


RESAMPLERS = {
    "plain": plain_windows,
    "oversample": oversample_extreme_windows,
    "evl": evl_sample_weights,
}
