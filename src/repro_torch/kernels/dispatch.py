"""Kernel routing and dispatch accounting.

The JAX package resolves Pallas-vs-XLA from a per-(backend, shape) rule
table. The port has no such table and no kill switch: the route is the
device. A CUDA tensor always goes to the hand-written kernel and a CPU
tensor to its plain PyTorch version, so no rule can hide the kernel on
the card.

Accounting keeps the JAX package's semantics: ``record`` counts one
invocation of a serving-level op (``predict``, ``slots_generate``, ...)
at (batch, hidden) under ``(device type, op, impl, shape)``, and only
while a ``counting()`` collector is installed. ``impl`` is ``"cuda"``
for the kernel route and ``"torch"`` for the plain one. Kernel launches
themselves are counted by each kernel's binding
(``repro_torch.kernels.lstm.kernel.LAUNCHES`` and
``LAYER_BWD_LAUNCHES``,
``repro_torch.kernels.evl.kernel.EVL_LAUNCHES`` (the loss and its dL/du
in one launch), ``repro_torch.kernels.attention.kernel.FLASH_LAUNCHES``,
``repro_torch.kernels.ssd.kernel.SSD_LAUNCHES``, and
``SSD_CHUNK_LAUNCHES`` for the single-chunk entry's). ``ssd_chunk``
records each of its dispatches as the op ``"ssd_chunk"``.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels.attention.ops import \
    flash_attention as _flash_attention
from repro_torch.kernels.evl.ops import evl_loss as _evl_loss
from repro_torch.kernels.lstm.ops import lstm_cell as _lstm_cell
from repro_torch.kernels.lstm.ops import lstm_layer as _lstm_layer
from repro_torch.kernels.ssd.ops import ssd_chunk as _ssd_chunk
from repro_torch.kernels.ssd.ops import ssd_scan as _ssd_scan

_lock = threading.Lock()
_collectors: list["DispatchCounts"] = []


def impl_for(device) -> str:
    """The route a tensor on ``device`` takes: ``"cuda"`` or ``"torch"``."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


class DispatchCounts:
    """Per-(device type, op, impl, shape) invocation counts, collected
    while installed via ``counting()``."""

    def __init__(self):
        self.counts: dict[tuple, int] = {}

    def add(self, key: tuple, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def total(self, op: str | None = None) -> int:
        return sum(n for (bk, o, impl, shape), n in self.counts.items()
                   if op is None or o == op)

    def by_op(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for (bk, op, impl, shape), n in self.counts.items():
            out[op] = out.get(op, 0) + n
        return out

    def __getitem__(self, op: str) -> int:
        return self.total(op)

    def __repr__(self) -> str:
        return f"DispatchCounts({self.counts!r})"


def record(op: str, *, batch: int, hidden: int, device, n: int = 1) -> None:
    """Count one dispatch of ``op`` at (batch, hidden) on ``device``.
    With no collector installed this is one truthiness check."""
    if not _collectors:
        return
    dev = torch.device(device)
    key = (dev.type, op, impl_for(dev), (batch, hidden))
    with _lock:
        for c in _collectors:
            c.add(key, n)


class counting:
    """Collect dispatch counts inside a ``with`` block::

        with dispatch.counting() as counts:
            engine.submit_step(...)          # ... flush ...
        assert counts["slots_generate"] == 1   # one generate per flush

    Collectors nest (each sees every dispatch while installed)."""

    def __enter__(self) -> DispatchCounts:
        self._counts = DispatchCounts()
        with _lock:
            _collectors.append(self._counts)
        return self._counts

    def __exit__(self, *exc) -> None:
        with _lock:
            _collectors.remove(self._counts)


def lstm_cell(x, h, c, wx, wh, b):
    """The routed LSTM cell: x [B, I]; h, c [B, H]; gates packed
    [i, f, g, o]; or every operand with a leading worker dim W. CUDA
    tensors run the hand-written kernels (the layer kernel at T = 1, and
    the layer backward kernel at T = 1 under autograd), CPU tensors the
    plain version (``kernels.lstm.ops.lstm_cell``)."""
    return _lstm_cell(x, h, c, wx, wh, b)


def lstm_layer(xs, h0, c0, wx, wh, b):
    """The routed LSTM layer, T steps from the carry (h0, c0): xs
    [B, T, I]; h0, c0 [B, H]; or every operand with a leading worker dim
    W. Returns (hs [..., B, T, H], hT, cT). CUDA tensors run one launch
    of the hand-written layer kernel, and under autograd one launch of
    the layer backward kernel behind it, CPU tensors the plain version
    (``kernels.lstm.ops.lstm_layer``)."""
    return _lstm_layer(xs, h0, c0, wx, wh, b)


def evl_loss(u, v, beta0: float, beta1: float, gamma: float = 2.0,
             eps: float = 1e-7, reduce: str = "mean"):
    """The routed EVL loss (paper eq. 6) per row of u, v [W, N]. CUDA
    tensors run the hand-written kernels (forward, and dL/du under
    autograd), CPU tensors the plain version
    (``kernels.evl.ops.evl_loss``)."""
    return _evl_loss(u, v, beta0, beta1, gamma, eps, reduce)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0, kv_valid=None):
    """The routed flash attention: q [B, Sq, Hq, D]; k, v [B, Skv, Hkv,
    D]. CUDA tensors run the hand-written kernel, CPU tensors the plain
    version (``kernels.attention.ops.flash_attention``)."""
    return _flash_attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_valid=kv_valid)


def ssd_scan(xd, a, B_, C_, chunk: int = 128):
    """The routed SSD chunk scan from a zero state: xd [B, L, H, P];
    a [B, L, H] float32; B_, C_ [B, L, N]. CUDA tensors run the
    hand-written kernel, CPU tensors the plain version
    (``kernels.ssd.ops.ssd_scan``). Returns (y, final state)."""
    return _ssd_scan(xd, a, B_, C_, chunk)


def ssd_chunk(xd, a, B_, C_, state):
    """The routed SSD chunk from a given state, one (batch, head): xd
    [K, P]; a [K] float32; B_, C_ [K, N]; state [P, N] float32. CUDA
    tensors run the hand-written scan kernel at chunk K with the state
    folded in after it, CPU tensors the plain version
    (``kernels.ssd.ops.ssd_chunk``); each call is recorded as the op
    ``"ssd_chunk"`` at (1, P). Returns (y [K, P], new state [P, N])."""
    out = _ssd_chunk(xd, a, B_, C_, state)
    record("ssd_chunk", batch=1, hidden=xd.shape[1], device=xd.device)
    return out
