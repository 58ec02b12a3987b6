"""The training half of ``repro.launch.specs``: the zoo's optimizer and
its train step.

    step, opt = make_train_step(cfg, lr=3e-4, microbatches=1)
    opt_state = opt.init(params)
    params, opt_state, loss = step(params, opt_state, tokens, frames)

One optimizer step of ``transformer.lm_loss``: its gradient by autograd
(on the card through the flash kernel's backward, the layers
rematerialized where ``cfg.remat``), then Adam with ``clip_norm`` 1.0
and moments in ``cfg.adam_moment_dtype``. With ``microbatches`` > 1 the
batch is split in order and the gradients accumulate over a Python loop
(the JAX package's scan), in fp32, or in bf16 where the moments are
bf16, as there.

The rest of the JAX module (input specs as shape stand-ins, the
shardings, ``make_local_round``, the prefill and decode step makers for
the dry run) is TPU launch tooling: ROADMAP Queue 1 #13.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any


def make_optimizer(cfg: ArchConfig | None = None):
    """Adam, ``clip_norm`` 1.0, moments stored in the config's
    ``adam_moment_dtype``."""
    mdt = torch.float32
    if cfg is not None and cfg.adam_moment_dtype == "bfloat16":
        mdt = torch.bfloat16
    return adam(clip_norm=1.0, moment_dtype=mdt)


def loss_and_grad(cfg: ArchConfig, params: PyTree, tokens, frames=None):
    """``lm_loss`` and its gradient with respect to every leaf of
    ``params`` (``jax.value_and_grad``): (loss, a nest of gradients in
    the leaves' dtypes). The leaves are taken as detached views, so the
    caller's tensors are left as they are; a leaf the loss does not
    reach gets zeros."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = tfm.lm_loss(cfg, tree_unflatten(params, leaves), tokens,
                           frames)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, lr: float = 1e-4,
                    microbatches: int = 1):
    """One optimizer step, and the optimizer whose state it takes:
    ``train_step(params, opt_state, tokens, frames=None) -> (params,
    opt_state, loss)``. With ``microbatches`` > 1 the batch (a multiple
    of it) is split into that many in order and the gradients summed in
    the accumulation dtype, then divided; the loss is their mean."""
    opt = make_optimizer(cfg)
    acc_dtype = (torch.bfloat16 if cfg.adam_moment_dtype == "bfloat16"
                 else torch.float32)

    def train_step(params, opt_state, tokens, frames=None):
        if microbatches == 1:
            loss, grads = loss_and_grad(cfg, params, tokens, frames)
        else:
            B = tokens.shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            mb = B // microbatches
            loss = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=acc_dtype, device=p.device), params)
            for i in range(microbatches):
                part = slice(i * mb, (i + 1) * mb)
                l, g = loss_and_grad(cfg, params, tokens[part],
                                     None if frames is None
                                     else frames[part])
                grads = tree_map(lambda a, b: a + b.to(acc_dtype), grads, g)
                loss = loss + l
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        updates, opt_state = opt.update(grads, opt_state, params, lr)
        return apply_updates(params, updates), opt_state, loss

    return train_step, opt
