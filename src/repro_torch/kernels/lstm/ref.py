"""Plain PyTorch versions of the LSTM kernels: the cell step, the same
math as ``repro.kernels.lstm.ref.lstm_cell_ref`` (gates packed
[i, f, g, o]); the layer, that step over T time steps from a given
carry (the layer kernel's function); and the function of the backward
kernel. Each takes the unstacked form (x [B, I] or xs [B, T, I],
wx [I, 4H], b [4H]) or the worker-stacked form (a leading W on every
operand). The CPU path runs ``lstm_cell_ref`` and ``lstm_layer_ref`` and
differentiates them with torch autograd; the card's kernels are held
against these."""

from __future__ import annotations

import torch


def _step(x, h, c, wx, wh, b):
    gates = x @ wx + h @ wh + b.unsqueeze(-2)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new, (i, f, g, o)


def lstm_cell_ref(x, h, c, wx, wh, b):
    """One step -> (h', c')."""
    h_new, c_new, _ = _step(x, h, c, wx, wh, b)
    return h_new, c_new


def lstm_layer_ref(xs, h0, c0, wx, wh, b):
    """T steps from (h0, c0): xs [..., B, T, I] -> (hs [..., B, T, H],
    hT, cT [..., B, H]). Each step's input is made contiguous first, so
    that it is the same matmul, bit for bit, as a step of its own."""
    steps = xs.movedim(-2, 0).contiguous()       # [T, ..., B, I]
    h, c = h0, c0
    hs = []
    for x_t in steps:
        h, c, _ = _step(x_t, h, c, wx, wh, b)
        hs.append(h)
    return torch.stack(hs, dim=-2), h, c


def lstm_cell_fwd_ref(x, h, c, wx, wh, b):
    """One step -> (h', c', activated gates [..., B, 4H]): what the
    forward kernel gives in training mode."""
    h_new, c_new, gates = _step(x, h, c, wx, wh, b)
    return h_new, c_new, torch.cat(gates, dim=-1)


def lstm_cell_bwd_ref(dh_new, dc_new, gates, c, c_new, wx, wh):
    """The backward kernel's function: from dh', dc', the saved
    activated gates, c and c' -> (dgates, dc, dx = dgates wx^T,
    dh = dgates wh^T)."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    tc = torch.tanh(c_new)
    dct = dc_new + dh_new * o * (1.0 - tc * tc)
    dgates = torch.cat([dct * g * i * (1.0 - i), dct * c * f * (1.0 - f),
                        dct * i * (1.0 - g * g),
                        dh_new * tc * o * (1.0 - o)], dim=-1)
    dc = dct * f
    return (dgates, dc, dgates @ wx.transpose(-1, -2),
            dgates @ wh.transpose(-1, -2))
