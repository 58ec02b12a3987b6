"""The LSTM cell's wrapper: device routing and argument checks around
the CUDA kernel.

A CUDA tensor goes to the hand-written kernel or raises; nothing on the
card falls back to the plain version. A CPU tensor goes to the plain
version (``ref.lstm_cell_ref``), which is what the CPU tests run. The
TPU wrapper's padding of B and I to multiples of 8 has no counterpart:
the kernel masks its own edges.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.lstm import kernel
from repro_torch.kernels.lstm.ref import lstm_cell_ref

# the shared memory an H100 block may opt in to (227 KB)
_SMEM_LIMIT = 232448


def _check_shapes(x, h, c, wx, wh, b) -> None:
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError(f"lstm_cell expects x [B, I] and h [B, H], got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    B, I = x.shape
    H = h.shape[1]
    want = {"h": (B, H), "c": (B, H), "wx": (I, 4 * H), "wh": (H, 4 * H),
            "b": (4 * H,)}
    got = {"h": h, "c": c, "wx": wx, "wh": wh, "b": b}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"lstm_cell: {name} must be {shape} for x "
                             f"{tuple(x.shape)} and h {tuple(h.shape)}, got "
                             f"{tuple(got[name].shape)}")


def lstm_cell(x, h, c, wx, wh, b):
    """x [B, I]; h, c [B, H]; wx [I, 4H]; wh [H, 4H]; b [4H]; gates packed
    [i, f, g, o]. Returns (h', c')."""
    _check_shapes(x, h, c, wx, wh, b)
    args = (x, h, c, wx, wh, b)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"lstm_cell: all tensors must share one device, "
                         f"got {sorted(map(str, devices))}")
    device = x.device
    if device.type == "cpu":
        return lstm_cell_ref(*args)
    if device.type != "cuda":
        raise ValueError(f"lstm_cell runs on cuda or cpu, got {device}")
    for name, t in zip(("x", "h", "c", "wx", "wh", "b"), args):
        if t.dtype != torch.float32:
            raise TypeError(f"lstm_cell kernel takes float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell kernel takes contiguous tensors, "
                             f"{name} is not")
    if x.shape[0] == 0:
        return torch.empty_like(h), torch.empty_like(c)
    if kernel.smem_bytes(x.shape[1], h.shape[1]) > _SMEM_LIMIT:
        raise ValueError(f"lstm_cell kernel: I + H = "
                         f"{x.shape[1] + h.shape[1]} needs more shared "
                         f"memory than {_SMEM_LIMIT} bytes")
    return kernel.lstm_cell_cuda(*args)
