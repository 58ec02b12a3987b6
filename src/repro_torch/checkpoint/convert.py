"""Weights between the JAX package and the port.

The JAX package's params are a nest of dicts and lists whose leaves are
arrays; ``params_from_numpy`` takes that nest with numpy leaves (e.g.
``jax.tree_util.tree_map(np.asarray, params)``) and returns the same
nest of tensors on ``device``; ``params_to_numpy`` is its inverse.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a dict/list/tuple nest."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


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
