"""Prediction metrics for the paper's experiments (the port of
``repro.training.metrics``)."""

from __future__ import annotations

import numpy as np
import torch


def mse(pred, target) -> float:
    """Mean squared error in float32, on the device ``pred`` lies on."""
    pred = torch.as_tensor(pred, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32, device=pred.device)
    return float(torch.mean(torch.square(pred - target)))


def rmse(pred, target) -> float:
    return float(np.sqrt(mse(pred, target)))


def extreme_event_metrics(u_pred, v_true, threshold: float = 0.5) -> dict:
    """Precision / recall / F1 for the (right-)extreme-event indicator head.
    v_true in {-1, 0, 1} is binarized to |v| (any extreme)."""
    u = np.asarray(u_pred) >= threshold
    v = np.abs(np.asarray(v_true)) > 0
    tp = int(np.sum(u & v))
    fp = int(np.sum(u & ~v))
    fn = int(np.sum(~u & v))
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {"precision": precision, "recall": recall, "f1": f1,
            "tp": tp, "fp": fp, "fn": fn, "n_extreme": int(np.sum(v))}
