"""Binding of the hand-written CUDA LSTM kernels: the layer forward, T
time steps in one launch (``csrc/lstm_layer.cu``; one cell step is the
same launch at T = 1), and the cell's backward (``csrc/lstm_cell_bwd.cu``).

Each source is built with ``nvcc`` for ``sm_90a`` at first use
(``repro_torch.kernels.build``) into a library of its own and called
through ``ctypes``: device pointers and the current stream go in as
``c_void_p``, and the C function returns ``cudaGetLastError()`` after
its launch, which is raised here if it is not 0 (and nothing is
counted). A launch runs on the calling thread's current stream and does
not synchronise. Operands carry the leading worker dim W (the forward
also takes them without it, as W = 1). ``LAUNCHES`` counts every forward
launch by (W, B, T, I, H) and ``BWD_LAUNCHES`` every backward launch by
(W, B, I, H), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LaunchCounter

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [_CSRC / "lstm_layer.cu"]
BWD_SOURCES = [_CSRC / "lstm_cell_bwd.cu"]
# every library of this package, for build.build_all
LIBRARIES = {"lstm_layer": SOURCES, "lstm_cell_bwd": BWD_SOURCES}

LAUNCHES = LaunchCounter()
BWD_LAUNCHES = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = build.load("lstm_layer", SOURCES)
    fn = lib.lstm_layer_forward
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 5 + [_P]
        fn.restype = _I
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = build.load("lstm_cell_bwd", BWD_SOURCES)
    fn = lib.lstm_cell_backward
    if fn.argtypes is None:
        fn.argtypes = [_P] * 11 + [_I] * 4 + [_P]
        fn.restype = _I
        lib.lstm_cell_bwd_smem_bytes.argtypes = [_I]
        lib.lstm_cell_bwd_smem_bytes.restype = _I
    return lib


def bwd_smem_bytes(hidden: int) -> int:
    """Shared memory one backward launch takes at H."""
    return _bwd_library().lstm_cell_bwd_smem_bytes(hidden)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def lstm_layer_cuda(xs, h0, c0, wx, wh, b, save_gates: bool = False,
                    write_hs: bool = True):
    """Launch the forward on validated CUDA tensors (see ``ops``):
    xs [W, B, T, I]; h0, c0 [W, B, H]; wx [W, I, 4H]; wh [W, H, 4H];
    b [W, 4H], fp32 and contiguous, or each without the leading W (one
    model: the same launch at W = 1, no reshape on the host); T >= 1.
    Returns (hs [..., B, T, H] or None without ``write_hs``, hT, cT
    [..., B, H]), and the activated gates [..., B, T, 4H] after them with
    ``save_gates``, all freshly allocated."""
    lib = _library()
    W = xs.shape[0] if xs.dim() == 4 else 1
    B, T, I = xs.shape[-3:]
    H = h0.shape[-1]
    lead = tuple(xs.shape[:-1])                        # (..., B, T)
    hs = h0.new_empty(lead + (H,)) if write_hs else None
    hT = torch.empty_like(h0)
    cT = torch.empty_like(c0)
    gates = h0.new_empty(lead + (4 * H,)) if save_gates else None
    rc = lib.lstm_layer_forward(
        xs.data_ptr(), h0.data_ptr(), c0.data_ptr(), wx.data_ptr(),
        wh.data_ptr(), b.data_ptr(), hs.data_ptr() if write_hs else None,
        hT.data_ptr(), cT.data_ptr(),
        gates.data_ptr() if save_gates else None, W, B, T, I, H,
        _stream(xs))
    if rc != 0:
        raise RuntimeError(f"lstm_layer kernel launch failed at W={W} B={B} "
                           f"T={T} I={I} H={H}: cudaError {rc}")
    LAUNCHES.add((W, B, T, I, H))
    return (hs, hT, cT, gates) if save_gates else (hs, hT, cT)


def lstm_cell_bwd_cuda(dh_new, dc_new, gates, c, c_new, wx, wh,
                       need_dx: bool = True):
    """Launch the backward on validated CUDA tensors: dh_new, dc_new, c,
    c_new [W, B, H]; gates [W, B, 4H] (saved by the forward); wx
    [W, I, 4H]; wh [W, H, 4H]; fp32 and contiguous. Returns (dgates
    [W, B, 4H], dc [W, B, H], dx [W, B, I] or None, dh [W, B, H])."""
    lib = _bwd_library()
    W, B, H = dh_new.shape
    I = wx.shape[1]
    dgates = torch.empty_like(gates)
    dc = torch.empty_like(c)
    dh = torch.empty_like(c)
    dx = dh_new.new_empty((W, B, I)) if need_dx else None
    rc = lib.lstm_cell_backward(
        dh_new.data_ptr(), dc_new.data_ptr(), gates.data_ptr(),
        c.data_ptr(), c_new.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        dgates.data_ptr(), dc.data_ptr(),
        dx.data_ptr() if need_dx else None, dh.data_ptr(), W, B, I, H,
        _stream(dh_new))
    if rc != 0:
        raise RuntimeError(f"lstm_cell backward kernel launch failed at "
                           f"W={W} B={B} I={I} H={H}: cudaError {rc}")
    BWD_LAUNCHES.add((W, B, I, H))
    return dgates, dc, dx, dh
