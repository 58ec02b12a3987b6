"""SGD (+momentum, weight decay), Adam, gradient clipping: functions over
param nests, the port of ``repro.optim.optimizers``.

Conventions, as in the reference:
- ``update(grads, state, params, lr)`` returns the step to subtract:
  new_params = params - updates (``apply_updates``).
- ``lr`` is passed at update time, so the paper's diminishing step size
  is driven from outside without rebuilding the state.

The reference runs an optimizer per local-SGD worker under
``jax.vmap``. Here the trainer calls ``update(..., workers=True)`` on
worker-stacked nests, every leaf with a leading worker dim W: the
elementwise updates are the same, and the global norm that clipping
takes, and Adam's step count, are then per worker.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple[PyTree, PyTree]]
    name: str = "optimizer"


def _per_worker(s, like):
    """A per-worker value ([W], or a scalar) shaped to broadcast against
    a worker-stacked leaf [W, ...]."""
    if s.dim() == 0:
        return s
    return s.reshape((-1,) + (1,) * (like.dim() - 1))


def global_norm(tree: PyTree, workers: bool = False):
    """sqrt of the sum of squares of every leaf (in float32); per worker,
    [W], with ``workers``."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(0.0)
    if workers:
        return torch.sqrt(sum(x.float().square().flatten(1).sum(dim=1)
                              for x in leaves))
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))


def clip_by_global_norm(tree: PyTree, max_norm: float,
                        workers: bool = False) -> PyTree:
    norm = global_norm(tree, workers)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda x: x * _per_worker(scale, x).to(x.dtype), tree)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p - u.to(p.dtype), params, updates)


# --------------------------------------------------------------------------
# SGD (+ momentum, + weight decay): the paper's base optimizer.
# --------------------------------------------------------------------------

class SGDState(NamedTuple):
    momentum: PyTree


def sgd(momentum: float = 0.0, weight_decay: float = 0.0,
        clip_norm: float | None = None) -> Optimizer:
    def init(params: PyTree) -> SGDState:
        if momentum == 0.0:
            return SGDState(momentum=None)
        return SGDState(momentum=tree_map(torch.zeros_like, params))

    def update(grads: PyTree, state: SGDState, params: PyTree, lr,
               workers: bool = False) -> tuple[PyTree, SGDState]:
        if clip_norm is not None:
            grads = clip_by_global_norm(grads, clip_norm, workers)
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                             grads, params)
        if momentum == 0.0:
            return tree_map(lambda g: lr * g, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g, state.momentum, grads)
        return tree_map(lambda m: lr * m, new_m), SGDState(momentum=new_m)

    return Optimizer(init=init, update=update, name="sgd")


# --------------------------------------------------------------------------
# Adam
# --------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: Any        # int32 count: a scalar, or [W] per worker
    mu: PyTree
    nu: PyTree


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, clip_norm: float | None = None,
         moment_dtype=torch.float32) -> Optimizer:
    """moment_dtype: storage dtype of mu/nu; the update math runs in
    float32."""
    def init(params: PyTree) -> AdamState:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device)
        return AdamState(step=torch.zeros((), dtype=torch.int32,
                                          device=device),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(grads: PyTree, state: AdamState, params: PyTree, lr,
               workers: bool = False) -> tuple[PyTree, AdamState]:
        if clip_norm is not None:
            grads = clip_by_global_norm(grads, clip_norm, workers)
        step = state.step + 1
        g32 = tree_map(lambda g: g.float(), grads)
        mu = tree_map(lambda m, g: (b1 * m.float() + (1 - b1) * g)
                      .to(moment_dtype), state.mu, g32)
        nu = tree_map(lambda v, g: (b2 * v.float() + (1 - b2) * g.square())
                      .to(moment_dtype), state.nu, g32)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def _upd(m, v, p):
            mhat = m.float() / _per_worker(bc1, m)
            vhat = v.float() / _per_worker(bc2, v)
            u = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return lr * u

        updates = tree_map(_upd, mu, nu, params)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update, name="adam")
