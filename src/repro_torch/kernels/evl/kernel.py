"""Binding of the hand-written CUDA EVL loss (``csrc/evl.cu``): the
forward with its per-row mean/sum fused in, and the closed-form dL/du.

Built with ``nvcc`` for ``sm_90a`` at first use
(``repro_torch.kernels.build``) and called through ``ctypes``, as the
LSTM cell is; the C functions return ``cudaGetLastError()``, raised here
if it is not 0. ``EVL_LAUNCHES`` and ``EVL_BWD_LAUNCHES`` count the
forward and backward launches by (W, N).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LaunchCounter

SOURCES = [Path(__file__).resolve().parent / "csrc" / "evl.cu"]
LIBRARIES = {"evl": SOURCES}
REDUCE = {"none": 0, "sum": 1, "mean": 2}

EVL_LAUNCHES = LaunchCounter()
EVL_BWD_LAUNCHES = LaunchCounter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _library() -> ctypes.CDLL:
    lib = build.load("evl", SOURCES)
    if lib.evl_forward.argtypes is None:
        lib.evl_forward.argtypes = [_P] * 3 + [_I] * 2 + [_F] * 5 + [_I, _P]
        lib.evl_forward.restype = _I
        lib.evl_backward.argtypes = [_P] * 4 + [_I] * 2 + [_F] * 5 + [_I, _P]
        lib.evl_backward.restype = _I
    return lib


def _scalars(beta0, beta1, gamma, eps):
    # the clip bounds as fp32 values, as the reference's jnp.clip sees
    # eps and 1.0 - eps (computed in float64, then cast)
    return (beta0, beta1, gamma, float(np.float32(eps)),
            float(np.float32(1.0 - eps)))


def evl_forward_cuda(u, v, beta0, beta1, gamma, eps, reduce):
    """Launch the loss on validated CUDA tensors u, v [W, N] (fp32,
    contiguous). Returns [W] for mean and sum, [W, N] for none."""
    W, N = u.shape
    out = u.new_empty((W, N) if reduce == "none" else (W,))
    rc = _library().evl_forward(
        u.data_ptr(), v.data_ptr(), out.data_ptr(), W, N,
        *_scalars(beta0, beta1, gamma, eps), REDUCE[reduce],
        torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"evl kernel launch failed at W={W} N={N}: "
                           f"cudaError {rc}")
    EVL_LAUNCHES.add((W, N))
    return out


def evl_backward_cuda(u, v, g, beta0, beta1, gamma, eps, reduce):
    """Launch dL/du on validated CUDA tensors: u, v [W, N]; g the
    incoming gradient, [W] for mean and sum, [W, N] for none (fp32,
    contiguous). Returns du [W, N]."""
    W, N = u.shape
    du = torch.empty_like(u)
    rc = _library().evl_backward(
        u.data_ptr(), v.data_ptr(), g.data_ptr(), du.data_ptr(), W, N,
        *_scalars(beta0, beta1, gamma, eps), REDUCE[reduce],
        torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"evl backward kernel launch failed at W={W} "
                           f"N={N}: cudaError {rc}")
    EVL_BWD_LAUNCHES.add((W, N))
    return du
