"""Binding of the hand-written CUDA LSTM cell (``csrc/lstm_cell.cu``).

The source is built with ``nvcc`` for ``sm_90a`` at first use
(``repro_torch.kernels.build``) and called through ``ctypes``: device
pointers and the current stream go in as ``c_void_p``, and the C
function returns ``cudaGetLastError()`` after its launch, which is
raised here if it is not 0. The launch runs on the calling thread's
current stream and does not synchronise. ``LAUNCHES`` counts every
launch by (B, I, H), so a run can show that its path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCES = [Path(__file__).resolve().parent / "csrc" / "lstm_cell.cu"]


class LaunchCounter:
    """Launches of one kernel, by shape. Thread-safe: the serving flush
    worker and the caller's thread both launch."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_shape: dict[tuple, int] = {}

    def add(self, shape: tuple) -> None:
        with self._lock:
            self.by_shape[shape] = self.by_shape.get(shape, 0) + 1

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.by_shape.values())

    def reset(self) -> None:
        with self._lock:
            self.by_shape = {}


LAUNCHES = LaunchCounter()


def _library() -> ctypes.CDLL:
    lib = build.load("lstm_cell", SOURCES)
    fn = lib.lstm_cell_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.lstm_cell_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.lstm_cell_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(in_dim: int, hidden: int) -> int:
    """Shared memory one launch takes at (I, H)."""
    return _library().lstm_cell_smem_bytes(in_dim, hidden)


def lstm_cell_cuda(x, h, c, wx, wh, b):
    """Launch the kernel on validated CUDA tensors (see ``ops``):
    x [B, I]; h, c [B, H]; wx [I, 4H]; wh [H, 4H]; b [4H], fp32 and
    contiguous. Returns (h', c'), freshly allocated."""
    lib = _library()
    B, I = x.shape
    H = h.shape[1]
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.lstm_cell_forward(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
        wh.data_ptr(), b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        B, I, H, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed at B={B} I={I} "
                           f"H={H}: cudaError {rc}")
    LAUNCHES.add((B, I, H))
    return h_out, c_out
