"""Extreme-event modeling (paper section II.A): the eq. 1 indicator
sequence and class fractions (``indicators``), the GEV tail machinery
(``evt``), the Extreme Value Loss (``evl``) and the imbalanced-data
strategies of the paper's sensitivity study (``resampling``: plain
sliding windows, extreme oversampling, EVL loss weighting)."""

from repro_torch.extreme.resampling import (RESAMPLERS, evl_sample_weights,
                                            oversample_extreme_windows,
                                            plain_windows)

__all__ = ["RESAMPLERS", "evl_sample_weights", "oversample_extreme_windows",
           "plain_windows"]
