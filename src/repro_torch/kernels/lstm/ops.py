"""The LSTM cell's wrapper: device routing, argument checks and the
autograd Function around the CUDA kernels.

A CUDA tensor goes to the hand-written kernels or raises; nothing on
the card falls back to the plain version, forward or backward. A CPU
tensor goes to the plain version (``ref.lstm_cell_ref``), which is what
the CPU tests run and what torch autograd differentiates there. The
TPU wrapper's padding of B and I to multiples of 8 has no counterpart:
the kernels mask their own edges.

The cell takes the unstacked form (x [B, I], wx [I, 4H], b [4H]: one
model, as serving calls it) or the worker-stacked form (x [W, B, I],
wx [W, I, 4H], b [W, 4H]: W local-SGD workers in one launch). On the
card, when autograd needs the cell's gradient, it runs as
``LSTMCellFunction``: the forward kernel saves the activated gates, and
the backward kernel turns them and dh', dc' into dgates, dc, dx and dh.
The weight gradients x^T dgates, h^T dgates and sum_B dgates reduce over
the batch, as XLA's autodiff does outside the TPU kernel, so they stay
``torch.bmm`` / ``sum`` here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.lstm import kernel
from repro_torch.kernels.lstm.ref import lstm_cell_ref

# the shared memory an H100 block may opt in to (227 KB)
_SMEM_LIMIT = 232448
_NAMES = ("x", "h", "c", "wx", "wh", "b")


def _check_shapes(x, h, c, wx, wh, b) -> None:
    if x.dim() not in (2, 3) or h.dim() != x.dim():
        raise ValueError(f"lstm_cell expects x [B, I] and h [B, H], or x "
                         f"[W, B, I] and h [W, B, H], got {tuple(x.shape)} "
                         f"and {tuple(h.shape)}")
    lead = tuple(x.shape[:-2])                 # () or (W,)
    B, I = x.shape[-2:]
    H = h.shape[-1]
    want = {"h": lead + (B, H), "c": lead + (B, H), "wx": lead + (I, 4 * H),
            "wh": lead + (H, 4 * H), "b": lead + (4 * H,)}
    got = {"h": h, "c": c, "wx": wx, "wh": wh, "b": b}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"lstm_cell: {name} must be {shape} for x "
                             f"{tuple(x.shape)} and h {tuple(h.shape)}, got "
                             f"{tuple(got[name].shape)}")


def _check_cuda(args) -> None:
    for name, t in zip(_NAMES, args):
        if t.dtype != torch.float32:
            raise TypeError(f"lstm_cell kernel takes float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell kernel takes contiguous tensors, "
                             f"{name} is not")
    I, H = args[0].shape[-1], args[1].shape[-1]
    if kernel.smem_bytes(I, H) > _SMEM_LIMIT:
        raise ValueError(f"lstm_cell kernel: I + H = {I + H} needs more "
                         f"shared memory than {_SMEM_LIMIT} bytes")


def _device(args) -> torch.device:
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"lstm_cell: all tensors must share one device, "
                         f"got {sorted(map(str, devices))}")
    device = args[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_cell runs on cuda or cpu, got {device}")
    return device


def lstm_cell(x, h, c, wx, wh, b):
    """One step, gates packed [i, f, g, o]: x [B, I]; h, c [B, H];
    wx [I, 4H]; wh [H, 4H]; b [4H], or each with a leading worker dim W.
    Returns (h', c')."""
    args = (x, h, c, wx, wh, b)
    _check_shapes(*args)
    if _device(args).type == "cpu":
        return lstm_cell_ref(*args)
    _check_cuda(args)
    if x.shape[-2] == 0:
        return torch.empty_like(h), torch.empty_like(c)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if x.dim() == 3:
            return LSTMCellFunction.apply(*args)
        h_new, c_new = LSTMCellFunction.apply(*(t.unsqueeze(0)
                                                for t in args))
        return h_new[0], c_new[0]
    return kernel.lstm_cell_cuda(*args)


def weight_grads(x, h, dgates, need):
    """The weight gradients from the backward kernel's dgates: x^T dgates,
    h^T dgates and sum_B dgates, each where ``need`` (wx, wh, b) asks
    for it, else None."""
    return (torch.bmm(x.transpose(1, 2), dgates) if need[0] else None,
            torch.bmm(h.transpose(1, 2), dgates) if need[1] else None,
            dgates.sum(dim=1) if need[2] else None)


class LSTMCellFunction(torch.autograd.Function):
    """The worker-stacked cell (all operands with a leading W, on the
    card) as an autograd Function: forward and backward are the kernels.
    Inputs must already be checked (``lstm_cell`` does)."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        h_new, c_new, gates = kernel.lstm_cell_cuda(x, h, c, wx, wh, b,
                                                    save_gates=True)
        ctx.save_for_backward(x, h, c, wx, wh, gates, c_new)
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh_new, dc_new):
        x, h, c, wx, wh, gates, c_new = ctx.saved_tensors
        need = ctx.needs_input_grad
        dgates, dc, dx, dh = kernel.lstm_cell_bwd_cuda(
            dh_new.contiguous(), dc_new.contiguous(), gates, c, c_new, wx,
            wh, need_dx=need[0])
        return ((dx if need[0] else None, dh if need[1] else None,
                 dc if need[2] else None) + weight_grads(x, h, dgates,
                                                         need[3:]))
