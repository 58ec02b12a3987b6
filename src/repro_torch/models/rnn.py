"""The paper's model: Input -> 2 x LSTM -> 3 x FC (Table I footnote),
sliding window 20, plus an extreme-event indicator head (sigmoid) for
the EVL experiments.

Functional over a params dict with the JAX package's keys
(``lstm[i].wx/wh/b``, ``fc[j].w/b``, ``out``, ``evl``), so weights map
one to one (``repro_torch.checkpoint.convert``). A layer over a window
(``lstm_layer_apply``, the JAX package's ``lax.scan``) is one
``repro_torch.kernels.dispatch.lstm_layer`` call: on the card one launch
of the hand-written CUDA layer kernel, with the time loop inside it (or,
under autograd, which that kernel has no backward for, one cell step per
time step through the cell's autograd Function); on the CPU the plain
version. A streaming step (``rnn_step``) is one ``lstm_cell`` per
layer: on the card the same kernel at T = 1.

Training (``rnn_features``, ``rnn_head``, ``rnn_apply``) also takes
worker-stacked params, every leaf with a leading worker dim W, and x
[W, B, T, I]: the JAX package's ``jax.vmap`` over local-SGD workers
written out, so that one launch serves all W workers. Serving
(``rnn_step``, ``rnn_apply_padded``, the carries) stays unstacked.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.layers import dense_init

PyTree = Any


@dataclasses.dataclass(frozen=True)
class RNNConfig:
    input_dim: int = 5          # OHLCV
    hidden: int = 64
    num_layers: int = 2         # paper: 2 LSTM layers
    fc_dims: tuple = (32, 16)   # paper: 3 FC layers (2 hidden + output)
    window: int = 20            # paper Table I
    evl_head: bool = True       # extreme-event indicator head
    dtype: torch.dtype = torch.float32


def init_lstm_layer(generator, in_dim: int, hidden: int, dtype, device):
    # gates packed [i, f, g, o] along the last dim
    b = torch.zeros(4 * hidden, dtype=dtype, device=device)
    b[hidden:2 * hidden] = 1.0   # forget-gate bias 1.0
    return {"wx": dense_init(generator, (in_dim, 4 * hidden), dtype, device),
            "wh": dense_init(generator, (hidden, 4 * hidden), dtype, device),
            "b": b}


def init_rnn(generator: torch.Generator, cfg: RNNConfig,
             device="cuda") -> PyTree:
    """Random weights from ``generator`` (drawn on the CPU, then placed
    on ``device``). The numbers differ from ``repro.models.rnn.init_rnn``
    for the same seed; to run the JAX package's weights, convert them
    with ``repro_torch.checkpoint.convert.params_from_numpy``."""
    device = resolve_device(device)
    params: dict = {"lstm": [], "fc": []}
    in_dim = cfg.input_dim
    for _ in range(cfg.num_layers):
        params["lstm"].append(init_lstm_layer(generator, in_dim, cfg.hidden,
                                              cfg.dtype, device))
        in_dim = cfg.hidden
    dims = (cfg.hidden,) + tuple(cfg.fc_dims)
    for j in range(len(cfg.fc_dims)):
        params["fc"].append({
            "w": dense_init(generator, (dims[j], dims[j + 1]), cfg.dtype,
                            device),
            "b": torch.zeros(dims[j + 1], dtype=cfg.dtype, device=device)})
    params["out"] = {"w": dense_init(generator, (dims[-1], 1), cfg.dtype,
                                     device),
                     "b": torch.zeros(1, dtype=cfg.dtype, device=device)}
    if cfg.evl_head:
        params["evl"] = {"w": dense_init(generator, (dims[-1], 1), cfg.dtype,
                                         device),
                         "b": torch.zeros(1, dtype=cfg.dtype, device=device)}
    return params


def lstm_cell(p, x_t, h, c):
    """One LSTM step: x_t [B, I]; h, c [B, H] -> (h', c')."""
    return dispatch.lstm_cell(x_t, h, c, p["wx"], p["wh"], p["b"])


def lstm_layer_apply(p, xs, h0=None, c0=None):
    """xs [B, T, I] -> (hs [B, T, H], (hT, cT) [B, H]) from the carry
    (h0, c0) (zeros when not given); or, with worker-stacked p, xs
    [W, B, T, I] -> hs [W, B, T, H] and a [W, B, H] carry."""
    lead = tuple(xs.shape[:-2])                    # (B,) or (W, B)
    H = p["wh"].shape[-2]
    if h0 is None:
        h0 = torch.zeros(lead + (H,), dtype=xs.dtype, device=xs.device)
    if c0 is None:
        c0 = torch.zeros(lead + (H,), dtype=xs.dtype, device=xs.device)
    hs, hT, cT = dispatch.lstm_layer(xs, h0, c0, p["wx"], p["wh"], p["b"])
    return hs, (hT, cT)


def rnn_features(params: PyTree, x):
    """x [B, T, input_dim] -> last-layer hidden sequence [B, T, H] (or
    with a leading worker dim W on x, the params and the result)."""
    h = x
    for lp in params["lstm"]:
        h, _ = lstm_layer_apply(lp, h)
    return h


def rnn_head(params: PyTree, h, cfg: RNNConfig):
    """FC stack + output/EVL heads on a hidden state h [B, H] (or
    [W, B, H] with worker-stacked params)."""
    for fp in params["fc"]:
        h = torch.tanh(h @ fp["w"] + fp["b"].unsqueeze(-2))
    y = (h @ params["out"]["w"] + params["out"]["b"].unsqueeze(-2))[..., 0]
    u = None
    if cfg.evl_head and "evl" in params:
        u = torch.sigmoid(h @ params["evl"]["w"]
                          + params["evl"]["b"].unsqueeze(-2))[..., 0]
    return y, u


def rnn_apply(params: PyTree, x, cfg: RNNConfig):
    """x [B, window, input_dim] -> (y_pred [B], u_extreme [B] or None);
    worker-stacked: x [W, B, window, input_dim] -> [W, B] each."""
    h = rnn_features(params, x)[..., -1, :]   # last time step
    return rnn_head(params, h, cfg)


def rnn_apply_padded(params: PyTree, x, lengths, cfg: RNNConfig):
    """Length-bucketed apply: x [B, T, input_dim] right-padded to a bucket
    length T, lengths [B] giving each example's true length. The LSTM
    stack is causal, so the hidden state at position len-1 depends only
    on x[:len]: gathering there gives exactly the unpadded result."""
    hs = rnn_features(params, x)
    idx = torch.as_tensor(lengths, dtype=torch.long, device=hs.device) - 1
    h = hs[torch.arange(hs.shape[0], device=hs.device), idx]
    return rnn_head(params, h, cfg)


def init_rnn_carry(params: PyTree, batch: int, dtype=torch.float32):
    """Zero (h, c) carries for each LSTM layer, on the params' device:
    the per-session state the serving session cache keeps."""
    out = []
    for lp in params["lstm"]:
        H = lp["wh"].shape[0]
        dev = lp["wh"].device
        out.append((torch.zeros((batch, H), dtype=dtype, device=dev),
                    torch.zeros((batch, H), dtype=dtype, device=dev)))
    return tuple(out)


def stack_rnn_carries(carries, pad_to: int | None = None):
    """Stack per-session carries (each ``init_rnn_carry(params, 1)``
    shaped) into one batched carry: N x ([1, H], [1, H]) per layer ->
    ([N, H], [N, H]) per layer, zero rows appended up to ``pad_to``. The
    result is freshly allocated."""
    n = len(carries)
    pad = (pad_to - n) if pad_to is not None else 0
    if pad < 0:
        raise ValueError(f"cannot pad {n} carries to width {pad_to}")
    out = []
    for layer in range(len(carries[0])):
        parts_h = [c[layer][0] for c in carries]
        parts_c = [c[layer][1] for c in carries]
        if pad:
            z = parts_h[0].new_zeros((pad,) + tuple(parts_h[0].shape[1:]))
            parts_h = parts_h + [z]
            parts_c = parts_c + [z]
        out.append((torch.cat(parts_h, dim=0), torch.cat(parts_c, dim=0)))
    return tuple(out)


def split_rnn_carry(carry, n: int | None = None):
    """Inverse of ``stack_rnn_carries``: a batched carry -> list of
    batch-1 per-session carries (first ``n`` rows)."""
    batch = carry[0][0].shape[0]
    n = batch if n is None else n
    return [tuple((h[i:i + 1], c[i:i + 1]) for h, c in carry)
            for i in range(n)]


def rnn_step(params: PyTree, x_t, carries, cfg: RNNConfig):
    """One time step: x_t [B, input_dim], carries from ``init_rnn_carry``.
    Returns (y [B], u [B] or None, new_carries). Feeding a window one step
    at a time from zero carries reproduces ``rnn_apply`` on it."""
    new_carries = []
    h = x_t
    for lp, (hc, cc) in zip(params["lstm"], carries):
        hc, cc = lstm_cell(lp, h, hc, cc)
        new_carries.append((hc, cc))
        h = hc
    y, u = rnn_head(params, h, cfg)
    return y, u, tuple(new_carries)
