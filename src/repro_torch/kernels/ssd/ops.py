"""The SSD chunk scan's wrapper: argument checks and the device route.

``ssd_scan(xd, a, B_, C_, chunk)`` is the scan of
``repro.kernels.ssd.ops.ssd_scan_fused`` (and of
``repro.models.ssm.ssd_chunked`` with no initial state): xd [B, L, H, P];
a [B, L, H] float32; B_, C_ [B, L, N]; xd, B_ and C_ all float32 or all
bfloat16; every tensor contiguous. A CUDA tensor goes to the
hand-written kernel (``kernel.ssd_scan_cuda``) or raises; a CPU tensor
goes to the plain version (``ref.ssd_scan_ref``). On the card bf16 runs
on the tensor-core kernel, which takes chunk 16, 32, 64 or 128, head
dims up to 64 and states up to 128 and reads xd, B_ and C_ by TMA: the
CUDA driver refuses a tensor that is not 16-byte aligned or whose
strides are not 16-byte multiples when the kernel's entry point encodes
its tensor maps, and the binding raises a ``ValueError`` before anything
is launched. fp32 runs on the CUDA-core kernel. The TPU wrapper's
padding of L to a multiple of the chunk has no counterpart on the card:
the kernel masks the ragged last chunk itself. The kernel has no
backward, so on the card an input that requires grad, while grad is
enabled, is refused; the CPU route differentiates.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel
from repro_torch.kernels.ssd.ref import ssd_scan_ref

_DTYPES = (torch.float32, torch.bfloat16)


def _check(xd, a, B_, C_, chunk) -> None:
    if xd.dim() != 4 or a.dim() != 3 or B_.dim() != 3 or C_.dim() != 3:
        raise ValueError(f"ssd_scan expects xd [B, L, H, P], a [B, L, H] and "
                         f"B_, C_ [B, L, N], got {tuple(xd.shape)}, "
                         f"{tuple(a.shape)}, {tuple(B_.shape)}, "
                         f"{tuple(C_.shape)}")
    Bsz, L, H, P = xd.shape
    if tuple(a.shape) != (Bsz, L, H) or tuple(C_.shape) != tuple(B_.shape) \
            or tuple(B_.shape[:2]) != (Bsz, L):
        raise ValueError(f"ssd_scan: a must be [B, L, H] and B_, C_ [B, L, N] "
                         f"for xd {tuple(xd.shape)}, got {tuple(a.shape)}, "
                         f"{tuple(B_.shape)}, {tuple(C_.shape)}")
    if min(H, P, B_.shape[2]) < 1:
        raise ValueError(f"ssd_scan: H, P and N must be >= 1, got H={H} "
                         f"P={P} N={B_.shape[2]}")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be an int >= 1, got {chunk!r}")
    if xd.dtype not in _DTYPES or B_.dtype != xd.dtype \
            or C_.dtype != xd.dtype:
        raise TypeError(f"ssd_scan takes xd, B_, C_ all float32 or all "
                        f"bfloat16, got {xd.dtype}, {B_.dtype}, {C_.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes a in float32, got {a.dtype}")
    for name, t in (("xd", xd), ("a", a), ("B_", B_), ("C_", C_)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan takes contiguous tensors, {name} "
                             f"is not")
    devices = {t.device for t in (xd, a, B_, C_)}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan: xd, a, B_, C_ must share one device, "
                         f"got {sorted(map(str, devices))}")
    if xd.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, got {xd.device}")


def ssd_scan(xd, a, B_, C_, chunk: int = 128):
    """The chunked SSD scan from a zero state. Returns (y [B, L, H, P] in
    xd's dtype, final state [B, H, P, N] float32)."""
    _check(xd, a, B_, C_, chunk)
    if xd.device.type == "cpu":
        return ssd_scan_ref(xd, a, B_, C_, chunk)
    P, N = xd.shape[3], B_.shape[2]
    if xd.dtype == torch.bfloat16:
        if chunk not in kernel.BF16_CHUNKS or P > kernel.BF16_MAX_HEAD_DIM \
                or N > kernel.BF16_MAX_STATE:
            raise ValueError(f"ssd_scan bf16 kernel takes chunk "
                             f"{kernel.BF16_CHUNKS}, head dim <= "
                             f"{kernel.BF16_MAX_HEAD_DIM} and state <= "
                             f"{kernel.BF16_MAX_STATE}, got chunk {chunk}, "
                             f"head dim {P}, state {N}")
    elif kernel.smem_bytes(chunk, P, N) > kernel.SMEM_LIMIT:
        raise ValueError(f"ssd_scan kernel: chunk {chunk}, head dim {P} and "
                         f"state {N} need {kernel.smem_bytes(chunk, P, N)} "
                         f"bytes of shared memory, over {kernel.SMEM_LIMIT}")
    # the kernel writes its outputs through ctypes, outside autograd: a
    # gradient through it would be lost without a word, so refuse it
    # until the kernel has a backward
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xd, a, B_, C_)):
        raise RuntimeError("ssd_scan kernel has no backward yet: call it on "
                           "the card under torch.no_grad(), or differentiate "
                           "on the CPU")
    return kernel.ssd_scan_cuda(xd, a, B_, C_, chunk)
