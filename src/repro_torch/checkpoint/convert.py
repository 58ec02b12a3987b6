"""Weights between the JAX package and the port.

The JAX package's params are a nest of dicts and lists whose leaves are
arrays; ``params_from_numpy`` takes that nest with numpy leaves (e.g.
``jax.tree_util.tree_map(np.asarray, params)``) and returns the same
nest of tensors on ``device``; ``params_to_numpy`` is its inverse.

``stack_workers`` gives a nest the leading worker dim ``[W, ...]`` that
the local-SGD trainer works on, the way the JAX package's
``AsyncLocalSGD.init`` broadcasts it. The JAX package's ``init_rnn``
weights reach the port's trainers as
``params_from_numpy(jax.tree_util.tree_map(np.asarray, params))``
(their ``init_params``), and worker-stacked as ``stack_workers(that, W)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import stack_workers, tree_map

__all__ = ["params_from_numpy", "params_to", "params_to_numpy",
           "stack_workers", "tree_map"]


def params_from_numpy(tree, device="cuda"):
    """numpy-leaved params nest -> the same nest of tensors on
    ``device`` (dtype kept, data copied)."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def params_to_numpy(tree):
    """Tensor-leaved params nest -> the same nest of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def params_to(tree, device):
    """The same nest with every tensor on ``device`` (no copy where a
    tensor is already there)."""
    return tree_map(lambda t: t.to(device), tree)
