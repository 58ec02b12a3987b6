"""Binding of the hand-written CUDA EVL kernel (``csrc/evl.cu``): the
loss with its per-row mean/sum fused in and, in the same launch, its
closed-form derivative in u.

Built with ``nvcc`` for ``sm_90a`` at first use
(``repro_torch.kernels.build``) and called through ``ctypes``, as the
LSTM layer is; the C function returns ``cudaGetLastError()``, raised
here if it is not 0. ``EVL_LAUNCHES`` counts the launches by (W, N).
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

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# evl_fused(u, v, out, du_or_null, W, N, beta0, beta1, gamma, lo, hi,
#           reduce, stream)
ARGTYPES = [_P] * 4 + [_I] * 2 + [_F] * 5 + [_I, _P]


def _library() -> ctypes.CDLL:
    lib = build.load("evl", SOURCES)
    if lib.evl_fused.argtypes is None:
        lib.evl_fused.argtypes = ARGTYPES
        lib.evl_fused.restype = _I
    return lib


def scalars(beta0, beta1, gamma, eps):
    """The kernel's float arguments: the betas, gamma and the clip
    bounds as fp32 values, as the reference's jnp.clip sees eps and
    1.0 - eps (computed in float64, then cast)."""
    return (beta0, beta1, gamma, float(np.float32(eps)),
            float(np.float32(1.0 - eps)))


def evl_cuda(u, v, beta0, beta1, gamma, eps, reduce, with_grad):
    """One launch on validated CUDA tensors u, v [W, N] (fp32,
    contiguous). Returns (the loss, [W] for mean and sum or [W, N] for
    none; ``du_unit`` [W, N], the loss's derivative in u, or None
    without ``with_grad``)."""
    W, N = u.shape
    out = u.new_empty((W, N) if reduce == "none" else (W,))
    du = torch.empty_like(u) if with_grad else None
    rc = _library().evl_fused(
        u.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if du is None else du.data_ptr(), W, N,
        *scalars(beta0, beta1, gamma, eps), REDUCE[reduce],
        torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"evl kernel launch failed at W={W} N={N}: "
                           f"cudaError {rc}")
    EVL_LAUNCHES.add((W, N))
    return out, du
