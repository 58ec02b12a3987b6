"""Plain PyTorch versions of the LSTM kernels: the cell step, the same
math as ``repro.kernels.lstm.ref.lstm_cell_ref`` (gates packed
[i, f, g, o]); the layer, that step over T time steps from a given
carry (the layer kernel's function, and with ``lstm_layer_fwd_ref`` what
it saves for the backward); and the layer's backward, the backward
kernel's function, one step of it being ``lstm_cell_bwd_ref``. Each
takes the unstacked form (x [B, I] or xs [B, T, I], wx [I, 4H], b [4H])
or the worker-stacked form (a leading W on every operand). The CPU path
runs ``lstm_cell_ref`` and ``lstm_layer_ref`` and differentiates them
with torch autograd; the card's kernels are held against these."""

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
    hT, cT [..., B, H])."""
    return lstm_layer_fwd_ref(xs, h0, c0, wx, wh, b)[:3]


def lstm_layer_fwd_ref(xs, h0, c0, wx, wh, b):
    """T steps from (h0, c0) -> (hs, hT, cT, the activated gates
    [..., B, T, 4H], each step's c [..., B, T, H]): what the forward
    kernel gives when it saves them for the backward. Each step's input
    is made contiguous first, so that it is the same matmul, bit for bit,
    as a step of its own."""
    steps = xs.movedim(-2, 0).contiguous()       # [T, ..., B, I]
    h, c = h0, c0
    hs, gates, cs = [], [], []
    for x_t in steps:
        h, c, g = _step(x_t, h, c, wx, wh, b)
        hs.append(h)
        gates.append(torch.cat(g, dim=-1))
        cs.append(c)
    return (torch.stack(hs, dim=-2), h, c, torch.stack(gates, dim=-2),
            torch.stack(cs, dim=-2))


def lstm_cell_bwd_ref(dh_new, dc_new, gates, c, c_new, wx, wh):
    """One step of the backward: from dh', dc', the saved activated
    gates, c and c' -> (dgates, dc, dx = dgates wx^T, dh = dgates wh^T)."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    tc = torch.tanh(c_new)
    dct = dc_new + dh_new * o * (1.0 - tc * tc)
    dgates = torch.cat([dct * g * i * (1.0 - i), dct * c * f * (1.0 - f),
                        dct * i * (1.0 - g * g),
                        dh_new * tc * o * (1.0 - o)], dim=-1)
    dc = dct * f
    return (dgates, dc, dgates @ wx.transpose(-1, -2),
            dgates @ wh.transpose(-1, -2))


def lstm_layer_bwd_ref(dhs, dhT, dcT, gates, cs, c0, wx, wh,
                       need_dx: bool = True):
    """The backward kernel's function: T steps of ``lstm_cell_bwd_ref``
    from t = T-1 down to 0, from (dh, dc) = (dhT, dcT), each step's dh'
    being dhs[t] + dh. dhs [..., B, T, H], dhT and dcT [..., B, H], each
    None where there is no gradient (read as 0); gates [..., B, T, 4H]
    and cs [..., B, T, H] as the forward saves them; c0 [..., B, H].
    Returns (dgates [..., B, T, 4H], dxs [..., B, T, I] or None without
    ``need_dx``, dh0, dc0)."""
    T = cs.shape[-2]
    dh = torch.zeros_like(c0) if dhT is None else dhT
    dc = torch.zeros_like(c0) if dcT is None else dcT
    dgates, dxs = [], []
    for t in reversed(range(T)):
        dh_t = dh if dhs is None else dhs[..., t, :] + dh
        c_prev = c0 if t == 0 else cs[..., t - 1, :]
        dg, dc, dx, dh = lstm_cell_bwd_ref(dh_t, dc, gates[..., t, :], c_prev,
                                           cs[..., t, :], wx, wh)
        dgates.append(dg)
        dxs.append(dx)
    return (torch.stack(dgates[::-1], dim=-2),
            torch.stack(dxs[::-1], dim=-2) if need_dx else None, dh, dc)
