"""Optimizers as functions over param nests: ``init(params) -> state``
and ``update(grads, state, params, lr) -> (updates, state)``; apply with
``apply_updates(params, updates)`` (updates are subtracted)."""

from repro_torch.optim.optimizers import (Optimizer, adam, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          sgd)

__all__ = ["Optimizer", "adam", "apply_updates", "clip_by_global_norm",
           "global_norm", "sgd"]
