"""Extreme Value Loss, paper eq. (6), and its unweighted ablation.

    EVL(u_t) = -beta0 * [1 - u_t/gamma]^gamma       * v_t     * log(u_t)
               -beta1 * [1 - (1-u_t)/gamma]^gamma   * (1-v_t) * log(1-u_t)

u_t in (0, 1) is the predicted extreme-event indicator, v_t in {0, 1}
the binary ground truth, beta0 the proportion of normal events, beta1
that of extreme events, gamma the extreme value index.

The port of ``repro.extreme.evl``. ``evl_loss`` goes through
``repro_torch.kernels.dispatch.evl_loss``: the hand-written CUDA kernel
on the card (forward and dL/du), the plain version on the CPU. Both
functions reduce over the LAST axis: for a 1-D u, the reference's use,
that is the reference's reduction; for u [W, N] it gives one loss per
row, as ``jax.vmap(evl_loss)`` over local-SGD workers does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch


def _f32(a, like=None):
    device = like.device if like is not None else None
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def evl_weights(u, v, beta0: float, beta1: float, gamma: float = 2.0):
    """The two GEV penalty weights of eq. (6) (before the log terms)."""
    u = _f32(u)
    floor = u.new_full((), 1e-12)
    w_pos = beta0 * torch.pow(torch.maximum(1.0 - u / gamma, floor), gamma)
    w_neg = beta1 * torch.pow(torch.maximum(1.0 - (1.0 - u) / gamma, floor),
                              gamma)
    return w_pos, w_neg


def evl_loss(u, v, beta0: float, beta1: float, gamma: float = 2.0,
             eps: float = 1e-7, reduce: str = "mean"):
    """eq. (6) over the last axis of u (probabilities) and v ({0, 1}
    labels): [..., N] -> [...] for mean and sum, [..., N] for none."""
    u = _f32(u)
    v = _f32(v, like=u)
    shape = u.shape
    rows = u.reshape(-1, shape[-1]).contiguous()
    out = dispatch.evl_loss(rows, v.reshape(-1, shape[-1]).contiguous(),
                            beta0, beta1, gamma, eps, reduce)
    return out.reshape(shape if reduce == "none" else shape[:-1])


def bce_loss(u, v, eps: float = 1e-7, reduce: str = "mean"):
    """Plain binary cross entropy, the unweighted ablation of EVL, over
    the last axis (plain PyTorch on every device: no TPU kernel
    computes it)."""
    u = _f32(u)
    u = torch.minimum(torch.maximum(u, u.new_full((), eps)),
                      u.new_full((), 1.0 - eps))
    v = _f32(v, like=u)
    loss = -v * torch.log(u) - (1.0 - v) * torch.log(1.0 - u)
    if reduce == "mean":
        return loss.mean(dim=-1)
    if reduce == "sum":
        return loss.sum(dim=-1)
    return loss
