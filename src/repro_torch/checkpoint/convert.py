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

``zoo_params_from_numpy`` takes the model zoo's params
(``repro.models.transformer.init_lm``, numpy-leaved, stacked [L, ...]
layer leaves) to the port's nest of the same keys and shapes on
``device``, each leaf in the dtype the port's init gives it (read from
``init_lm`` on the meta device): the config's dtype, except Mamba2's
``dt_bias`` and ``A_log``, which stay float32 in a bf16 model, as in
the JAX init. numpy has no bf16, so a bf16 config's params arrive as
fp32 arrays (or as ``ml_dtypes`` bfloat16 arrays, widened exactly to
fp32 first) and are cast leaf by leaf.

``zoo_cache_from_numpy`` does the same for a decode cache
(``repro.models.transformer.lm_prefill`` / ``init_cache``'s, numpy
leaves): each leaf in the dtype of the port's ``init_cache`` (the
counters int32, the SSM state float32, the rest the config's dtype),
so that the port can decode on from the JAX package's own cache.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_cache, init_lm
from repro_torch.tree import stack_workers, tree_map

__all__ = ["params_from_numpy", "params_to", "params_to_numpy",
           "stack_workers", "tree_map", "zoo_cache_from_numpy",
           "zoo_params_from_numpy"]


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


def zoo_params_from_numpy(cfg, tree, device="cuda"):
    """A zoo arch's numpy-leaved params nest -> the same nest of tensors
    on ``device``, each leaf in the dtype of the port's init."""
    device = resolve_device(device)

    return tree_map(lambda a, like: _leaf(a, like.dtype, device), tree,
                    init_lm(cfg, None))


def _leaf(a, dtype, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":              # ml_dtypes: widen exactly
        a = a.astype(np.float32)
    return torch.tensor(a).to(device=device, dtype=dtype)


def zoo_cache_from_numpy(cfg, tree, device="cuda"):
    """A zoo arch's numpy-leaved decode cache (a dict of arrays, as the
    JAX package's ``lm_prefill`` or ``init_cache`` builds it, full or
    ring mode) -> the same dict of tensors on ``device``, each leaf in
    the dtype of the port's ``init_cache``."""
    device = resolve_device(device)
    # max_len 1 takes full mode, whose keys hold the ring's
    like = init_cache(cfg, 1, 1, device="meta")
    return {k: _leaf(a, like[k].dtype, device) for k, a in tree.items()}
