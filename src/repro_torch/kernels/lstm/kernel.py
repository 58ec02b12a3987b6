"""Binding of the hand-written CUDA LSTM kernels: the layer forward, T
time steps in one launch (``csrc/lstm_layer.cu``; one cell step is the
same launch at T = 1), and the layer backward, the same T steps in
reverse in one launch (``csrc/lstm_layer_bwd.cu``).

Each source is built with ``nvcc`` for ``sm_90a`` at first use
(``repro_torch.kernels.build``) into a library of its own and called
through ``ctypes``: device pointers and the current stream go in as
``c_void_p``, and the C function returns ``cudaGetLastError()`` after
its launch, which is raised here if it is not 0 (and nothing is
counted). A launch runs on the calling thread's current stream and does
not synchronise. Operands carry the leading worker dim W (the forward
also takes them without it, as W = 1). ``LAUNCHES`` counts every forward
launch and ``LAYER_BWD_LAUNCHES`` every backward launch, each by
(W, B, T, I, H), so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LaunchCounter

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [_CSRC / "lstm_layer.cu"]
BWD_SOURCES = [_CSRC / "lstm_layer_bwd.cu"]
# every library of this package, for build.build_all
LIBRARIES = {"lstm_layer": SOURCES, "lstm_layer_bwd": BWD_SOURCES}

LAUNCHES = LaunchCounter()
LAYER_BWD_LAUNCHES = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = build.load("lstm_layer", SOURCES)
    fn = lib.lstm_layer_forward
    if fn.argtypes is None:
        fn.argtypes = [_P] * 11 + [_I] * 5 + [_P]
        fn.restype = _I
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = build.load("lstm_layer_bwd", BWD_SOURCES)
    fn = lib.lstm_layer_backward
    if fn.argtypes is None:
        fn.argtypes = [_P] * 12 + [_I] * 5 + [_P]
        fn.restype = _I
    return lib


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    """A tensor's device pointer, or None (null) for no tensor."""
    return None if t is None else t.data_ptr()


def lstm_layer_cuda(xs, h0, c0, wx, wh, b, save_gates: bool = False,
                    write_hs: bool = True):
    """Launch the forward on validated CUDA tensors (see ``ops``):
    xs [W, B, T, I]; h0, c0 [W, B, H]; wx [W, I, 4H]; wh [W, H, 4H];
    b [W, 4H], fp32 and contiguous, or each without the leading W (one
    model: the same launch at W = 1, no reshape on the host); T >= 1.
    Returns (hs [..., B, T, H] or None without ``write_hs``, hT, cT
    [..., B, H]), and with ``save_gates`` after them what the backward
    reads: the activated gates [..., B, T, 4H] and each step's c
    [..., B, T, H]; all freshly allocated."""
    lib = _library()
    W = xs.shape[0] if xs.dim() == 4 else 1
    B, T, I = xs.shape[-3:]
    H = h0.shape[-1]
    lead = tuple(xs.shape[:-1])                        # (..., B, T)
    hs = h0.new_empty(lead + (H,)) if write_hs else None
    hT = torch.empty_like(h0)
    cT = torch.empty_like(c0)
    gates = h0.new_empty(lead + (4 * H,)) if save_gates else None
    cs = h0.new_empty(lead + (H,)) if save_gates else None
    rc = lib.lstm_layer_forward(
        xs.data_ptr(), h0.data_ptr(), c0.data_ptr(), wx.data_ptr(),
        wh.data_ptr(), b.data_ptr(), _ptr(hs), hT.data_ptr(), cT.data_ptr(),
        _ptr(gates), _ptr(cs), W, B, T, I, H, _stream(xs))
    if rc != 0:
        raise RuntimeError(f"lstm_layer kernel launch failed at W={W} B={B} "
                           f"T={T} I={I} H={H}: cudaError {rc}")
    LAUNCHES.add((W, B, T, I, H))
    return (hs, hT, cT, gates, cs) if save_gates else (hs, hT, cT)


def lstm_layer_bwd_cuda(dhs, dhT, dcT, gates, cs, c0, wx, wh,
                        need_dx: bool = True):
    """Launch the backward on validated CUDA tensors, fp32 and contiguous
    (see ``ops``): dhs [W, B, T, H] or None; dhT, dcT [W, B, H] or None
    (no gradient there: read as 0); gates [W, B, T, 4H] and cs
    [W, B, T, H] (saved by the forward); c0 [W, B, H]; wx [W, I, 4H] and
    wh [W, H, 4H], 16-byte aligned (the kernel refuses others); T >= 1.
    Returns (dgates [W, B, T, 4H], dxs
    [W, B, T, I] or None without ``need_dx``, dh0, dc0 [W, B, H]), all
    freshly allocated."""
    lib = _bwd_library()
    W, B, T, G = gates.shape
    H, I = G // 4, wx.shape[1]
    dgates = torch.empty_like(gates)
    dxs = gates.new_empty((W, B, T, I)) if need_dx else None
    dh0 = torch.empty_like(c0)
    dc0 = torch.empty_like(c0)
    rc = lib.lstm_layer_backward(
        _ptr(dhs), _ptr(dhT), _ptr(dcT), gates.data_ptr(), cs.data_ptr(),
        c0.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        dgates.data_ptr(), _ptr(dxs), dh0.data_ptr(), dc0.data_ptr(), W, B,
        T, I, H, _stream(gates))
    if rc != 0:
        raise RuntimeError(f"lstm_layer backward kernel launch failed at "
                           f"W={W} B={B} T={T} I={I} H={H}: cudaError {rc}")
    LAYER_BWD_LAUNCHES.add((W, B, T, I, H))
    return dgates, dxs, dh0, dc0
