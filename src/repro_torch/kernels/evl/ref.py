"""Plain PyTorch versions of the EVL kernel (paper eq. 6): the loss, the
same math as ``repro.kernels.evl.ref.evl_loss_ref``; its closed-form
dL/du; and the fused kernel's function, the reduced loss with the
derivative of that loss in u. The clip is written as maximum/minimum,
not ``clamp``: at u == eps or 1 - eps exactly they pass half the
gradient, as ``jnp.clip`` does, where ``clamp`` passes all of it."""

from __future__ import annotations

import torch


def _clip(u, eps: float):
    u = u.to(torch.float32)
    return torch.minimum(torch.maximum(u, u.new_full((), eps)),
                         u.new_full((), 1.0 - eps))


def reduce_rows(loss, reduce: str):
    """The kernel's reduction over the last axis: mean, sum or none."""
    if reduce == "mean":
        return loss.mean(dim=-1)
    if reduce == "sum":
        return loss.sum(dim=-1)
    return loss


def evl_loss_ref(u, v, beta0: float, beta1: float, gamma: float = 2.0,
                 eps: float = 1e-7):
    """Elementwise EVL (no reduction). u, v: same shape."""
    u = _clip(u, eps)
    v = v.to(torch.float32)
    floor = u.new_full((), 1e-12)
    w_pos = beta0 * torch.pow(torch.maximum(1.0 - u / gamma, floor), gamma)
    w_neg = beta1 * torch.pow(torch.maximum(1.0 - (1.0 - u) / gamma, floor),
                              gamma)
    return -w_pos * v * torch.log(u) - w_neg * (1.0 - v) * torch.log(1.0 - u)


def _dmax(a, floor: float):
    """d max(a, floor) / da: 1 above, 1/2 at the tie, 0 below."""
    return torch.where(a > floor, 1.0, torch.where(a == floor, 0.5, 0.0))


def evl_grad_ref(u, v, beta0: float, beta1: float, gamma: float = 2.0,
                 eps: float = 1e-7):
    """Elementwise dL/du of ``evl_loss_ref`` (to be scaled by the
    incoming gradient)."""
    u = u.to(torch.float32)
    v = v.to(torch.float32)
    lo, hi = u.new_full((), eps), u.new_full((), 1.0 - eps)
    dclip = torch.where((u > lo) & (u < hi), 1.0,
                        torch.where((u == lo) | (u == hi), 0.5, 0.0))
    uc = _clip(u, eps)
    a = 1.0 - uc / gamma
    b = 1.0 - (1.0 - uc) / gamma
    ap, bp = a.clamp_min(1e-12), b.clamp_min(1e-12)
    w_pos = beta0 * torch.pow(ap, gamma)
    w_neg = beta1 * torch.pow(bp, gamma)
    dw_pos = -beta0 * torch.pow(ap, gamma - 1.0) * _dmax(a, 1e-12)
    dw_neg = beta1 * torch.pow(bp, gamma - 1.0) * _dmax(b, 1e-12)
    dl = (-dw_pos * v * torch.log(uc) - w_pos * v / uc
          - dw_neg * (1.0 - v) * torch.log(1.0 - uc)
          + w_neg * (1.0 - v) / (1.0 - uc))
    return dl * dclip


def evl_loss_and_grad_ref(u, v, beta0: float, beta1: float,
                          gamma: float = 2.0, eps: float = 1e-7,
                          reduce: str = "mean"):
    """The fused kernel's function on u, v [W, N]: the loss reduced over
    each row (``reduce_rows``) and ``du_unit``, its derivative in u,
    [W, N]: ``evl_grad_ref / N`` for mean, ``evl_grad_ref`` for sum and
    none. The incoming gradient is not part of it."""
    loss = reduce_rows(evl_loss_ref(u, v, beta0, beta1, gamma, eps), reduce)
    du = evl_grad_ref(u, v, beta0, beta1, gamma, eps)
    return loss, (du / u.shape[-1] if reduce == "mean" else du)
