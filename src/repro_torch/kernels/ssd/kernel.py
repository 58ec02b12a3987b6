"""Binding of the hand-written CUDA SSD chunk scan (``csrc/ssd_scan.cu``).

Built with ``nvcc`` for ``sm_90a`` at first use
(``repro_torch.kernels.build``) and called through ``ctypes``, as the
other kernels are: pointers, the sizes, the chunk and the current
stream go in; the C function returns ``cudaGetLastError()``, raised here
if it is not 0. ``SSD_LAUNCHES`` counts the launches by
(B, L, H, P, N, chunk).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LaunchCounter

SOURCES = [Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"]
LIBRARIES = {"ssd_scan": SOURCES}
# dynamic shared memory one block may take on an H100 (227 KB)
SMEM_LIMIT = 232_448
_ROW_BLOCK = 32

SSD_LAUNCHES = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int


def smem_bytes(chunk: int, head_dim: int, state: int) -> int:
    """Shared memory of one block: xd [K][P], B^T [N][K + 1], C [K][N],
    the state [N][P], 32 rows of masked scores [32][K] and cum [K], all
    fp32: a copy of ``smem_bytes`` in the source, so that the wrapper
    refuses a shape past ``SMEM_LIMIT`` before it launches."""
    K, P, N = chunk, head_dim, state
    return 4 * (K * P + N * (K + 1) + K * N + N * P + min(K, _ROW_BLOCK) * K
                + K)


def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan", SOURCES)
    fn = lib.ssd_scan_forward
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 7 + [_P]
        fn.restype = _I
    return lib


def ssd_scan_cuda(xd, a, B_, C_, chunk: int):
    """Launch on validated CUDA tensors (see ``ops``): xd [B, L, H, P];
    a [B, L, H] fp32; B_, C_ [B, L, N] in xd's dtype (fp32 or bf16); all
    contiguous. Returns fresh (y [B, L, H, P] in xd's dtype, final state
    [B, H, P, N] fp32)."""
    Bsz, L, H, P = xd.shape
    N = B_.shape[-1]
    y = torch.empty_like(xd)
    if y.numel() == 0:                    # nothing to scan: a zero state
        return y, torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                              device=xd.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32,
                        device=xd.device)   # the kernel writes all of it
    rc = _library().ssd_scan_forward(
        xd.data_ptr(), a.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        y.data_ptr(), state.data_ptr(), Bsz, L, H, P, N, chunk,
        int(xd.dtype == torch.bfloat16),
        torch.cuda.current_stream(xd.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed at B={Bsz} L={L} "
                           f"H={H} P={P} N={N} chunk={chunk} {xd.dtype}: "
                           f"cudaError {rc}")
    SSD_LAUNCHES.add((Bsz, L, H, P, N, chunk))
    return y, state
