"""Binding of the hand-written CUDA SSD chunk scan: one library of
``csrc/ssd_scan.cu`` (the entry point, and the fp32 kernel on the CUDA
cores) and ``csrc/ssd_scan_wgmma.cu`` (the bf16 kernel: wgmma on the
tensor cores, fed by TMA), the entry point choosing by dtype.

Built with ``nvcc`` for ``sm_90a`` at first use
(``repro_torch.kernels.build``) and called through ``ctypes``, as the
other kernels are: pointers, the sizes, the chunk and the current
stream go in; the C function returns ``cudaGetLastError()``, raised here
if it is not 0, or one of ``TMA_REFUSED``'s codes, raised as a
``ValueError``. ``SSD_LAUNCHES`` counts the launches by
(B, L, H, P, N, chunk); ``SSD_CHUNK_LAUNCHES`` counts, by (K, P, N),
those that ``ops.ssd_chunk`` makes (one chunk of one (batch, head)
from a given state), which ``SSD_LAUNCHES`` counts too.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LaunchCounter

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [_CSRC / "ssd_scan.cu", _CSRC / "ssd_scan_wgmma.cu"]
LIBRARIES = {"ssd_scan": SOURCES}
# dynamic shared memory one block may take on an H100 (227 KB)
SMEM_LIMIT = 232_448
_ROW_BLOCK = 32
# the bf16 kernel's shapes: the chunks it is instantiated for, and P and
# N up to one and two 64-column slabs
BF16_CHUNKS = (16, 32, 64, 128)
BF16_MAX_HEAD_DIM, BF16_MAX_STATE = 64, 128
# the entry point's returns when the CUDA driver refuses to encode a bf16
# operand's tensor map (TMA reads only 16-byte aligned tensors whose
# strides are 16-byte multiples), before anything is launched; cudaError
# values are positive
TMA_REFUSED = {-1: "xd", -2: "B_", -3: "C_"}

SSD_LAUNCHES = LaunchCounter()
SSD_CHUNK_LAUNCHES = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int


def smem_bytes(chunk: int, head_dim: int, state: int) -> int:
    """Shared memory of one block of the fp32 kernel: xd [K][P], B^T
    [N][K + 1], C [K][N], the state [N][P], 32 rows of masked scores
    [32][K] and cum [K], all fp32: a copy of ``smem_bytes`` in
    ssd_scan.cu, so that the wrapper refuses a shape past ``SMEM_LIMIT``
    before it launches. The bf16 kernel's shared memory is fixed by the
    shapes it is built for (``ops`` refuses any other), and its source
    asserts at compile time that each fits."""
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


def raise_for(rc: int, xd, B_, C_, chunk: int) -> None:
    """Raise for the entry point's return ``rc`` on xd, B_, C_: a
    ``ValueError`` naming the operand TMA cannot read, a ``RuntimeError``
    for a CUDA error; nothing for 0."""
    if rc == 0:
        return
    if rc in TMA_REFUSED:
        name = TMA_REFUSED[rc]
        t = dict(xd=xd, B_=B_, C_=C_)[name]
        raise ValueError(
            f"ssd_scan kernel (bf16, TMA) cannot read {name}: TMA takes "
            f"16-byte aligned tensors whose strides are 16-byte multiples; "
            f"{name} starts {t.data_ptr() % 16} bytes past a 16-byte "
            f"boundary, its strides are "
            f"{[s * t.element_size() for s in t.stride()[:-1]]} bytes at "
            f"shape {tuple(t.shape)}")
    Bsz, L, H, P = xd.shape
    raise RuntimeError(f"ssd_scan kernel launch failed at B={Bsz} L={L} "
                       f"H={H} P={P} N={B_.shape[-1]} chunk={chunk} "
                       f"{xd.dtype}: cudaError {rc}")


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
    raise_for(rc, xd, B_, C_, chunk)
    SSD_LAUNCHES.add((Bsz, L, H, P, N, chunk))
    return y, state
