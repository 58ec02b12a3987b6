"""The LSTM wrappers: device routing, argument checks and the autograd
Function around the CUDA kernels.

A CUDA tensor goes to the hand-written kernels or raises; nothing on
the card falls back to the plain version, forward or backward. A CPU
tensor goes to the plain version (``ref.lstm_cell_ref``,
``ref.lstm_layer_ref``), which is what the CPU tests run and what torch
autograd differentiates there. The TPU wrapper's padding of B and I to
multiples of 8 has no counterpart: the kernels mask their own edges.

``lstm_layer`` runs T time steps from a given carry: on the card in one
launch of the layer kernel, which has no backward, so where autograd
needs a gradient it steps ``lstm_cell`` T times instead. ``lstm_cell``
is one step: on the card the same kernel at T = 1. Both take the
unstacked form (x [B, I] or xs [B, T, I], wx [I, 4H], b [4H]: one
model, as serving calls them) or the worker-stacked form (a leading W
on every operand: W local-SGD workers in one launch). On the card, when autograd needs the cell's gradient, it
runs as ``LSTMCellFunction``: the forward kernel saves the activated
gates, and the backward kernel turns them and dh', dc' into dgates, dc,
dx and dh.
The weight gradients x^T dgates, h^T dgates and sum_B dgates reduce over
the batch, as XLA's autodiff does outside the TPU kernel, so they stay
``torch.bmm`` / ``sum`` here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.lstm import kernel
from repro_torch.kernels.lstm.ref import lstm_cell_ref, lstm_layer_ref

_NAMES = ("x", "h", "c", "wx", "wh", "b")


def _check_shapes(x, h, c, wx, wh, b, op="lstm_cell") -> None:
    """x [..., B, I] (cell) or [..., B, T, I] (layer) against h, c
    [..., B, H] and the weights, with the same leading (W,) or none."""
    steps = op == "lstm_layer"
    if x.dim() - steps not in (2, 3) or h.dim() != x.dim() - steps:
        form = "[B, T, I]" if steps else "[B, I]"
        raise ValueError(f"{op} expects x {form} and h [B, H], or with a "
                         f"leading worker dim W each, got {tuple(x.shape)} "
                         f"and {tuple(h.shape)}")
    lead = tuple(h.shape[:-2])                 # () or (W,)
    B, I = h.shape[-2], x.shape[-1]
    H = h.shape[-1]
    if tuple(x.shape[:-1 - steps]) != lead + (B,):
        raise ValueError(f"{op}: x {tuple(x.shape)} does not match h "
                         f"{tuple(h.shape)} in its leading dims")
    want = {"h": lead + (B, H), "c": lead + (B, H), "wx": lead + (I, 4 * H),
            "wh": lead + (H, 4 * H), "b": lead + (4 * H,)}
    got = {"h": h, "c": c, "wx": wx, "wh": wh, "b": b}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{op}: {name} must be {shape} for x "
                             f"{tuple(x.shape)} and h {tuple(h.shape)}, got "
                             f"{tuple(got[name].shape)}")


def _check_cuda(args, op="lstm_cell") -> None:
    for name, t in zip(_NAMES, args):
        if t.dtype != torch.float32:
            raise TypeError(f"{op} kernel takes float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op} kernel takes contiguous tensors, "
                             f"{name} is not")


def _device(args, op="lstm_cell") -> torch.device:
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"{op}: all tensors must share one device, "
                         f"got {sorted(map(str, devices))}")
    device = args[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on cuda or cpu, got {device}")
    return device


def _needs_grad(args) -> bool:
    """Whether autograd wants a gradient through these operands."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in args)


def _cell_steps(xs, h0, c0, wx, wh, b):
    """The layer as T ``lstm_cell`` steps, each one launch at T = 1 whose
    autograd Function has the backward kernel. xs may be strided: its
    steps are copied out contiguous."""
    steps = xs.movedim(-2, 0).contiguous()        # [T, ..., I], rows contiguous
    h, c = h0, c0
    hs = []
    for x_t in steps:
        h, c = lstm_cell(x_t, h, c, wx, wh, b)
        hs.append(h)
    return torch.stack(hs, dim=-2), h, c


def lstm_layer(xs, h0, c0, wx, wh, b):
    """T steps from the carry (h0, c0), gates packed [i, f, g, o]:
    xs [B, T, I]; h0, c0 [B, H]; wx [I, 4H]; wh [H, 4H]; b [4H], or each
    with a leading worker dim W. Returns (hs [..., B, T, H], hT, cT
    [..., B, H]). On the card: one launch of the layer kernel, or, where
    autograd needs a gradient, T cell steps (the same kernel at T = 1)."""
    args = (xs, h0, c0, wx, wh, b)
    _check_shapes(*args, op="lstm_layer")
    on_card = _device(args, op="lstm_layer").type == "cuda"
    if on_card and _needs_grad(args) and xs.shape[-2] > 0:
        return _cell_steps(*args)                # each step checks its operands
    if on_card:
        _check_cuda(args, op="lstm_layer")
    if xs.shape[-3] == 0 or xs.shape[-2] == 0:   # no rows or no steps
        hs = xs.new_empty(tuple(xs.shape[:-1]) + (h0.shape[-1],))
        return hs, h0.clone(), c0.clone()
    if not on_card:
        return lstm_layer_ref(*args)
    return kernel.lstm_layer_cuda(*args)


def lstm_cell(x, h, c, wx, wh, b):
    """One step, gates packed [i, f, g, o]: x [B, I]; h, c [B, H];
    wx [I, 4H]; wh [H, 4H]; b [4H], or each with a leading worker dim W.
    Returns (h', c'). On the card: the layer kernel at T = 1."""
    args = (x, h, c, wx, wh, b)
    _check_shapes(*args)
    if _device(args).type == "cpu":
        return lstm_cell_ref(*args)
    _check_cuda(args)
    if x.shape[-2] == 0:
        return torch.empty_like(h), torch.empty_like(c)
    if _needs_grad(args):
        if x.dim() == 3:
            return LSTMCellFunction.apply(*args)
        h_new, c_new = LSTMCellFunction.apply(*(t.unsqueeze(0)
                                                for t in args))
        return h_new[0], c_new[0]
    _, h_new, c_new = kernel.lstm_layer_cuda(x.unsqueeze(-2), h, c, wx, wh,
                                             b, write_hs=False)
    return h_new, c_new


def weight_grads(x, h, dgates, need):
    """The weight gradients from the backward kernel's dgates: x^T dgates,
    h^T dgates and sum_B dgates, each where ``need`` (wx, wh, b) asks
    for it, else None."""
    return (torch.bmm(x.transpose(1, 2), dgates) if need[0] else None,
            torch.bmm(h.transpose(1, 2), dgates) if need[1] else None,
            dgates.sum(dim=1) if need[2] else None)


class LSTMCellFunction(torch.autograd.Function):
    """The worker-stacked cell (all operands with a leading W, on the
    card) as an autograd Function: the forward is the layer kernel at
    T = 1, saving the gates, and the backward its kernel.
    Inputs must already be checked (``lstm_cell`` does)."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        _, h_new, c_new, gates = kernel.lstm_layer_cuda(
            x.unsqueeze(-2), h, c, wx, wh, b, save_gates=True,
            write_hs=False)
        ctx.save_for_backward(x, h, c, wx, wh, gates.squeeze(-2), c_new)
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
