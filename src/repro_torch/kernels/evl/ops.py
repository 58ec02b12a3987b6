"""The EVL loss's wrapper: device routing, argument checks and the
autograd Function around the CUDA kernel.

u, v are [W, N]: one row per local-SGD worker, N its batch. The loss
reduces each row (mean or sum) to [W], or stays [W, N] for ``"none"``.
A CUDA tensor goes to the hand-written kernel or raises: under autograd
``EVLFunction`` launches it once for the loss and its derivative in u
together, and its backward is the chain rule's multiply alone. A CPU
tensor goes to the plain version (``ref.evl_loss_ref`` plus the
reduction), which torch autograd differentiates. With no rows (W = 0)
the card launches nothing, as the LSTM wrapper does on empty inputs,
and the result is empty: [0] for mean and sum, [0, N] for none.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.evl import kernel
from repro_torch.kernels.evl.ref import (evl_loss_and_grad_ref, evl_loss_ref,
                                         reduce_rows)


def evl_loss(u, v, beta0: float, beta1: float, gamma: float = 2.0,
             eps: float = 1e-7, reduce: str = "mean"):
    """Paper eq. 6 per row: u, v [W, N] -> [W] (mean, sum) or [W, N]."""
    if reduce not in kernel.REDUCE:
        raise ValueError(f"evl_loss: reduce must be one of "
                         f"{sorted(kernel.REDUCE)}, got {reduce!r}")
    if u.dim() != 2 or tuple(v.shape) != tuple(u.shape) or u.shape[1] == 0:
        raise ValueError(f"evl_loss expects u and v [W, N] with N >= 1, got "
                         f"{tuple(u.shape)} and {tuple(v.shape)}")
    if u.device != v.device:
        raise ValueError(f"evl_loss: u and v must share one device, got "
                         f"{u.device} and {v.device}")
    if u.device.type == "cpu":
        return reduce_rows(evl_loss_ref(u, v, beta0, beta1, gamma, eps),
                           reduce)
    if u.device.type != "cuda":
        raise ValueError(f"evl_loss runs on cuda or cpu, got {u.device}")
    for name, t in (("u", u), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"evl kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"evl kernel takes contiguous tensors, {name} "
                             f"is not")
    if torch.is_grad_enabled() and u.requires_grad:
        return EVLFunction.apply(u, v, beta0, beta1, gamma, eps, reduce)
    if u.shape[0] == 0:           # no rows: CUDA refuses a grid of 0 blocks
        return _empty(u, reduce)
    return kernel.evl_cuda(u, v, beta0, beta1, gamma, eps, reduce,
                           with_grad=False)[0]


def _empty(u, reduce):
    """The loss of W = 0 rows: [0] for mean and sum, [0, N] for none."""
    return u.new_empty(tuple(u.shape) if reduce == "none" else (0,))


def _loss_and_grad(u, v, beta0, beta1, gamma, eps, reduce):
    """The fused function, routed by device: the kernel for a CUDA
    tensor (no launch for W = 0 rows: an empty loss and a [0, N]
    ``du_unit``), ``evl_loss_and_grad_ref`` for a CPU one."""
    if u.device.type == "cuda" and u.shape[0] == 0:
        return _empty(u, reduce), torch.empty_like(u)
    if u.device.type == "cuda":
        return kernel.evl_cuda(u, v, beta0, beta1, gamma, eps, reduce,
                               with_grad=True)
    return evl_loss_and_grad_ref(u, v, beta0, beta1, gamma, eps, reduce)


class EVLFunction(torch.autograd.Function):
    """The loss as an autograd Function with a gradient for u only (v is
    a label). The forward computes the loss and ``du_unit`` in one call
    (one launch on the card) and saves ``du_unit``; the backward
    multiplies it by the incoming gradient. Inputs must already be
    checked (``evl_loss`` does)."""

    @staticmethod
    def forward(ctx, u, v, beta0, beta1, gamma, eps, reduce):
        out, du = _loss_and_grad(u, v, beta0, beta1, gamma, eps, reduce)
        ctx.save_for_backward(du)
        ctx.reduce = reduce
        return out

    @staticmethod
    def backward(ctx, g):
        (du,) = ctx.saved_tensors
        scale = g if ctx.reduce == "none" else g[:, None]
        return du * scale, None, None, None, None, None, None
