"""The LSTM wrappers: device routing, argument checks and the autograd
Function around the CUDA kernels.

A CUDA tensor goes to the hand-written kernels or raises; nothing on
the card falls back to the plain version, forward or backward. A CPU
tensor goes to the plain version (``ref.lstm_cell_ref``,
``ref.lstm_layer_ref``), which is what the CPU tests run and what torch
autograd differentiates there. The TPU wrapper's padding of B and I to
multiples of 8 has no counterpart: the kernels mask their own edges.

``lstm_layer`` runs T time steps from a given carry: on the card in one
launch of the layer kernel, and where autograd needs a gradient as
``LSTMLayerFunction``, whose forward is that launch saving the activated
gates and each step's c, and whose backward is one launch of the layer
backward kernel over the same T steps. ``lstm_cell`` is one step: on
the card the same kernel, or the same Function, at T = 1. Both take the
unstacked form (x [B, I] or xs [B, T, I], wx [I, 4H], b [4H]: one
model, as serving calls them) or the worker-stacked form (a leading W
on every operand: W local-SGD workers in one launch).
The weight gradients x^T dgates, h_prev^T dgates and the sum of dgates
reduce over the batch and the window, as XLA's autodiff does outside the
TPU kernel, so they stay one ``torch.bmm`` / ``sum`` each per window here
(``layer_grads``).
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


def lstm_layer(xs, h0, c0, wx, wh, b):
    """T steps from the carry (h0, c0), gates packed [i, f, g, o]:
    xs [B, T, I]; h0, c0 [B, H]; wx [I, 4H]; wh [H, 4H]; b [4H], or each
    with a leading worker dim W. Returns (hs [..., B, T, H], hT, cT
    [..., B, H]). On the card: one launch of the layer kernel, and where
    autograd needs a gradient one launch of the backward kernel behind
    it (``LSTMLayerFunction``)."""
    args = (xs, h0, c0, wx, wh, b)
    _check_shapes(*args, op="lstm_layer")
    on_card = _device(args, op="lstm_layer").type == "cuda"
    grad = _needs_grad(args)
    if on_card and grad:
        # a training batch may be a strided view: the Function launches
        # on, and saves, a contiguous copy that autograd differentiates
        args = (xs.contiguous(),) + args[1:]
    if on_card:
        _check_cuda(args, op="lstm_layer")
    if xs.shape[-3] == 0 or xs.shape[-2] == 0:   # no rows or no steps
        hs = xs.new_empty(tuple(xs.shape[:-1]) + (h0.shape[-1],))
        return hs, h0.clone(), c0.clone()
    if not on_card:
        return lstm_layer_ref(*args)
    if grad:
        return _layer_function(*args)
    return kernel.lstm_layer_cuda(*args)


def lstm_cell(x, h, c, wx, wh, b):
    """One step, gates packed [i, f, g, o]: x [B, I]; h, c [B, H];
    wx [I, 4H]; wh [H, 4H]; b [4H], or each with a leading worker dim W.
    Returns (h', c'). On the card: the layer kernel at T = 1, under
    autograd as ``LSTMLayerFunction`` at T = 1."""
    args = (x, h, c, wx, wh, b)
    _check_shapes(*args)
    if _device(args).type == "cpu":
        return lstm_cell_ref(*args)
    _check_cuda(args)
    if x.shape[-2] == 0:
        return torch.empty_like(h), torch.empty_like(c)
    if _needs_grad(args):
        _, h_new, c_new = _layer_function(x.unsqueeze(-2), h, c, wx, wh, b)
        return h_new, c_new
    _, h_new, c_new = kernel.lstm_layer_cuda(x.unsqueeze(-2), h, c, wx, wh,
                                             b, write_hs=False)
    return h_new, c_new


def _layer_function(xs, h0, c0, wx, wh, b):
    """``LSTMLayerFunction`` on checked operands, stacked or not."""
    if xs.dim() == 4:
        return LSTMLayerFunction.apply(xs, h0, c0, wx, wh, b)
    hs, hT, cT = LSTMLayerFunction.apply(*(t.unsqueeze(0) for t in
                                           (xs, h0, c0, wx, wh, b)))
    return hs[0], hT[0], cT[0]


def _dense(t):
    return None if t is None else t.contiguous()


def layer_grads(saved, dhs, dhT, dcT, need, backward):
    """The gradients of the worker-stacked layer's six inputs (xs, h0,
    c0, wx, wh, b), each None where ``need`` (autograd's
    ``needs_input_grad``) does not ask for it. ``saved`` is what the
    forward keeps: (xs, h0, c0, wx, wh, hs, gates, cs); dhs, dhT and dcT
    are the outputs' cotangents, None where autograd gave none.
    ``backward`` computes (dgates, dxs, dh0, dc0) from (dhs, dhT, dcT,
    gates, cs, c0, wx, wh, need_dx): the kernel's binding on the card,
    ``ref.lstm_layer_bwd_ref`` in the CPU tests. The weight gradients are
    one product each over the B x T rows of the window: x^T dgates,
    h_prev^T dgates with h_prev = [h0, hs[..., :-1, :]], and the sum of
    dgates."""
    xs, h0, c0, wx, wh, hs, gates, cs = saved
    dgates, dxs, dh0, dc0 = backward(_dense(dhs), _dense(dhT), _dense(dcT),
                                     gates, cs, c0, wx, wh,
                                     need_dx=need[0])
    W, B, T, G = dgates.shape
    rows = dgates.reshape(W, B * T, G)
    dwx = dwh = db = None
    if need[3]:
        dwx = torch.bmm(xs.reshape(W, B * T, -1).transpose(1, 2), rows)
    if need[4]:
        h_prev = torch.cat([h0.unsqueeze(2), hs[:, :, :-1]], dim=2)
        dwh = torch.bmm(h_prev.reshape(W, B * T, -1).transpose(1, 2), rows)
    if need[5]:
        db = rows.sum(dim=1)
    return (dxs if need[0] else None, dh0 if need[1] else None,
            dc0 if need[2] else None, dwx, dwh, db)


class LSTMLayerFunction(torch.autograd.Function):
    """The worker-stacked layer (all operands with a leading W, on the
    card, checked and contiguous) as an autograd Function: the forward
    is one launch of the layer kernel over the window, saving the gates
    and each step's c; the backward one launch of the backward kernel,
    then the weight gradients (``layer_grads``)."""

    @staticmethod
    def forward(ctx, xs, h0, c0, wx, wh, b):
        hs, hT, cT, gates, cs = kernel.lstm_layer_cuda(
            xs, h0, c0, wx, wh, b, save_gates=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xs, h0, c0, wx, wh, hs, gates, cs)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        return layer_grads(ctx.saved_tensors, dhs, dhT, dcT,
                           ctx.needs_input_grad, kernel.lstm_layer_bwd_cuda)
