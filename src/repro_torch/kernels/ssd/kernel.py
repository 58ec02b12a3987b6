"""Binding of the hand-written CUDA SSD chunk scan and its gradient: one
library of ``csrc/ssd_scan.cu`` (the entry point, and the fp32 kernel
on the CUDA cores) and ``csrc/ssd_scan_wgmma.cu`` (the bf16 kernel:
wgmma on the tensor cores, fed by TMA), the entry point choosing by
dtype; and one of ``csrc/ssd_scan_bwd.cu`` (the backward's entry point,
and its fp32 kernels on the CUDA cores) and ``csrc/ssd_scan_bwd_wgmma.cu``
(the bf16 backward: wgmma fed by TMA), again choosing by dtype, each
route deterministic: dxd, da, dB and dC from the cotangents of y and of
the final state. The two libraries are built apart so that they build
at once; the bf16 sources include ``kernels/csrc/hopper.cuh``.

Built with ``nvcc`` for ``sm_90a`` at first use
(``repro_torch.kernels.build``) and called through ``ctypes``, as the
other kernels are: pointers, the sizes, the chunk and the current stream
go in; the C function returns ``cudaGetLastError()``, raised here if it
is not 0, or one of ``TMA_REFUSED``'s codes (the backward's
``BWD_REFUSED`` and ``BWD_TMA_REFUSED``), raised as a ``ValueError``.
``SSD_LAUNCHES`` counts the forward's launches by (B, L, H, P, N,
chunk); ``SSD_BWD_LAUNCHES`` the backward's by the same key, one a call
of its entry point (which runs its four kernels); ``SSD_CHUNK_LAUNCHES``
counts, by (K, P, N), those that ``ops.ssd_chunk`` makes (one chunk of
one (batch, head) from a given state), which ``SSD_LAUNCHES`` counts
too.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LaunchCounter

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [_CSRC / "ssd_scan.cu", _CSRC / "ssd_scan_wgmma.cu"]
BWD_SOURCES = [_CSRC / "ssd_scan_bwd.cu", _CSRC / "ssd_scan_bwd_wgmma.cu"]
LIBRARIES = {"ssd_scan": SOURCES, "ssd_scan_bwd": BWD_SOURCES}
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
# the fp32 backward: the largest state it takes (its register
# accumulators), the rows of the [K, K] matrices and of a state it holds
# at once, and its entry point's return for a shape it refuses (either
# route's), before any launch
BWD_MAX_STATE = 128
BWD_ROW_BLOCK = BWD_STATE_TILE = 16
BWD_REFUSED = {-1: "shape"}
# the bf16 backward: the entry point's returns when the CUDA driver
# refuses an operand's tensor map, before anything is launched; the heads
# one of its chunk blocks walks, summing dB or dC over them (the
# scratch's groups)
BWD_TMA_REFUSED = {-2: "xd", -3: "B_", -4: "C_", -5: "dy"}
BWD_HEADS = 8

SSD_LAUNCHES = LaunchCounter()
SSD_BWD_LAUNCHES = LaunchCounter()
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


def bwd_smem_bytes(chunk: int, head_dim: int, state: int) -> int:
    """Shared memory of the backward's larger block, all fp32: the
    states kernel's xd or dy [K][P], B or C [K][N], the state [P][N], cum
    and a weight [K]; the chunk kernel's xd^T, dy^T [P][K + 1], B^T, C^T
    [N][K + 1], two blocks of 16 rows of [K, K] matrices [16][K + 1],
    16 rows of a state [16][N] (then a row's terms), six [K] arrays and
    32 floats. A copy of ``states_smem_bytes`` and ``chunk_smem_bytes``
    in ssd_scan_bwd.cu, so that the wrapper refuses a shape past
    ``SMEM_LIMIT`` before it launches the forward (the scores kernel's,
    B^T and C^T, is less than the chunk kernel's)."""
    K, P, N = chunk, head_dim, state
    KP, RB = K + 1, min(K, BWD_ROW_BLOCK)
    states = K * P + K * N + P * N + 2 * K
    chunk_block = ((2 * P + 2 * N) * KP + 2 * RB * KP + BWD_STATE_TILE * N
                   + 6 * K + 32)
    return 4 * max(states, chunk_block)


def bwd_scratch_floats(Bsz: int, L: int, H: int, P: int, N: int,
                       chunk: int, bf16: bool = False) -> int:
    """The backward's fp32 scratch. fp32: the state entering and the
    cotangent of the state leaving each chunk, [B, n_chunks, H, P, N]
    each; the heads' partials of dB and dC, [B, H, L, N] each; and each
    chunk's C B^T and its transpose, [B, n_chunks, chunk, chunk] each.
    bf16 (a copy of ``scratch_floats`` in ssd_scan_bwd_wgmma.cu): the two
    states transposed and padded to 64-column slabs, [B, n_chunks, H, 64
    ceil(N / 64), 64] each; the head groups' dB and dC, [ceil(H /
    BWD_HEADS), B, L, N] each; three [B, L, H] rows of da's terms and
    [B, n_chunks, H] of the state's decay term."""
    nc = -(-L // chunk)
    if bf16:
        st = Bsz * nc * H * 64 * -(-N // 64) * 64
        pt = -(-H // BWD_HEADS) * Bsz * L * N
        return 2 * st + 2 * pt + 3 * Bsz * L * H + Bsz * nc * H
    return (2 * Bsz * nc * H * P * N + 2 * Bsz * H * L * N
            + 2 * Bsz * nc * chunk * chunk)


def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan", SOURCES)
    fn = lib.ssd_scan_forward
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 7 + [_P]
        fn.restype = _I
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = build.load("ssd_scan_bwd", BWD_SOURCES)
    fn = lib.ssd_scan_backward
    if fn.argtypes is None:
        fn.argtypes = [_P] * 11 + [_I] * 7 + [_P]
        fn.restype = _I
    return lib


def raise_for(rc: int, xd, B_, C_, chunk: int, dy=None) -> None:
    """Raise for the entry point's return ``rc`` on xd, B_, C_ (and dy:
    the backward's, whose shape refusal its caller raises): a
    ``ValueError`` naming the operand TMA cannot read, a ``RuntimeError``
    for a CUDA error; nothing for 0."""
    if rc == 0:
        return
    codes = TMA_REFUSED if dy is None else BWD_TMA_REFUSED
    what = "ssd_scan" if dy is None else "ssd_scan backward"
    if rc in codes:
        name = codes[rc]
        t = dict(xd=xd, B_=B_, C_=C_, dy=dy)[name]
        raise ValueError(
            f"{what} kernel (bf16, TMA) cannot read {name}: TMA takes "
            f"16-byte aligned tensors whose strides are 16-byte multiples; "
            f"{name} starts {t.data_ptr() % 16} bytes past a 16-byte "
            f"boundary, its strides are "
            f"{[s * t.element_size() for s in t.stride()[:-1]]} bytes at "
            f"shape {tuple(t.shape)}")
    Bsz, L, H, P = xd.shape
    raise RuntimeError(f"{what} kernel launch failed at B={Bsz} L={L} "
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


def ssd_scan_bwd_cuda(xd, a, B_, C_, chunk: int, dy, dstate=None):
    """The backward's launch on the CUDA tensors the autograd Function
    checked: xd and dy [B, L, H, P], B_ and C_ [B, L, N], one dtype (fp32
    or bf16); a [B, L, H] fp32; dstate [B, H, P, N] fp32 or None (a zero
    cotangent); all contiguous. Returns fresh (dxd, da, dB, dC), each in
    its input's dtype. bf16 takes chunk 16, 32, 64 or 128, head dims up
    to 64 and states up to 128, and operands TMA can read; anything else
    raises a ``ValueError`` before a launch."""
    Bsz, L, H, P = xd.shape
    N = B_.shape[-1]
    if xd.numel() == 0:
        return tuple(torch.zeros_like(t) for t in (xd, a, B_, C_))
    grads = tuple(torch.empty_like(t) for t in (xd, a, B_, C_))
    bf16 = xd.dtype == torch.bfloat16
    scratch = torch.empty(bwd_scratch_floats(Bsz, L, H, P, N, chunk, bf16),
                          dtype=torch.float32, device=xd.device)
    rc = _bwd_library().ssd_scan_backward(
        xd.data_ptr(), a.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
        scratch.data_ptr(), *(g.data_ptr() for g in grads), Bsz, L, H, P,
        N, chunk, int(bf16), torch.cuda.current_stream(xd.device).cuda_stream)
    if rc in BWD_REFUSED:
        if bf16:
            raise ValueError(f"ssd_scan backward kernel (bf16) refuses chunk "
                             f"{chunk}, head dim {P}, state {N}: it takes "
                             f"chunk {BF16_CHUNKS}, head dim <= "
                             f"{BF16_MAX_HEAD_DIM}, state <= "
                             f"{BF16_MAX_STATE}")
        raise ValueError(f"ssd_scan backward kernel refuses chunk {chunk}, "
                         f"head dim {P}, state {N}: state <= "
                         f"{BWD_MAX_STATE} and {bwd_smem_bytes(chunk, P, N)}"
                         f" bytes of shared memory <= {SMEM_LIMIT}")
    raise_for(rc, xd, B_, C_, chunk, dy)
    SSD_BWD_LAUNCHES.add((Bsz, L, H, P, N, chunk))
    return grads
