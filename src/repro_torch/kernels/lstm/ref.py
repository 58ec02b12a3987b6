"""Plain PyTorch version of the fused LSTM cell: the same math as
``repro.kernels.lstm.ref.lstm_cell_ref`` (gates packed [i, f, g, o]).
The CPU path runs it, and the card's kernel is held against it."""

from __future__ import annotations

import torch


def lstm_cell_ref(x, h, c, wx, wh, b):
    gates = x @ wx + h @ wh + b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new
