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
backward (ROADMAP: ``BACKWARD_ITEM``), so on the card an input that
requires grad, while grad is enabled, is refused with a
``NotImplementedError`` naming that item; the CPU route
differentiates.

``ssd_chunk(xd, a, B_, C_, state)`` is the counterpart of
``repro.kernels.ssd.ops.ssd_chunk_fused``: one chunk of one (batch,
head) from a given state, xd [K, P]; a [K] float32; B_, C_ [K, N];
state [P, N] float32. On the card it runs the same scan kernel at
chunk K from zero and folds the state in after it
(``ref.fold_state``), as the TPU entry does; on the CPU it runs
``ref.ssd_chunk_ref``. It takes the same checks and the same refusal
of gradients on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel
from repro_torch.kernels.ssd.ref import fold_state, ssd_chunk_ref, \
    ssd_scan_ref

_DTYPES = (torch.float32, torch.bfloat16)
# the ROADMAP item that ports the scan's backward kernel
BACKWARD_ITEM = "The SSD scan's backward"


def _no_backward(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} kernel has no backward yet (ROADMAP, Next: "
        f"{BACKWARD_ITEM}): call it on the card under torch.no_grad(), or "
        f"differentiate on the CPU")


def _check(xd, a, B_, C_, chunk, name="ssd_scan") -> None:
    if xd.dim() != 4 or a.dim() != 3 or B_.dim() != 3 or C_.dim() != 3:
        raise ValueError(f"{name} expects xd [B, L, H, P], a [B, L, H] and "
                         f"B_, C_ [B, L, N], got {tuple(xd.shape)}, "
                         f"{tuple(a.shape)}, {tuple(B_.shape)}, "
                         f"{tuple(C_.shape)}")
    Bsz, L, H, P = xd.shape
    if tuple(a.shape) != (Bsz, L, H) or tuple(C_.shape) != tuple(B_.shape) \
            or tuple(B_.shape[:2]) != (Bsz, L):
        raise ValueError(f"{name}: a must be [B, L, H] and B_, C_ [B, L, N] "
                         f"for xd {tuple(xd.shape)}, got {tuple(a.shape)}, "
                         f"{tuple(B_.shape)}, {tuple(C_.shape)}")
    if min(H, P, B_.shape[2]) < 1:
        raise ValueError(f"{name}: H, P and N must be >= 1, got H={H} "
                         f"P={P} N={B_.shape[2]}")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"{name}: chunk must be an int >= 1, got {chunk!r}")
    if xd.dtype not in _DTYPES or B_.dtype != xd.dtype \
            or C_.dtype != xd.dtype:
        raise TypeError(f"{name} takes xd, B_, C_ all float32 or all "
                        f"bfloat16, got {xd.dtype}, {B_.dtype}, {C_.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"{name} takes a in float32, got {a.dtype}")
    for arg, t in (("xd", xd), ("a", a), ("B_", B_), ("C_", C_)):
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors, {arg} "
                             f"is not")
    devices = {t.device for t in (xd, a, B_, C_)}
    if len(devices) != 1:
        raise ValueError(f"{name}: xd, a, B_, C_ must share one device, "
                         f"got {sorted(map(str, devices))}")
    if xd.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, got {xd.device}")


def _check_card(xd, a, B_, C_, chunk, name="ssd_scan") -> None:
    """What the kernels take on the card, checked before a launch."""
    P, N = xd.shape[3], B_.shape[2]
    if xd.dtype == torch.bfloat16:
        if chunk not in kernel.BF16_CHUNKS or P > kernel.BF16_MAX_HEAD_DIM \
                or N > kernel.BF16_MAX_STATE:
            raise ValueError(f"{name} bf16 kernel takes chunk "
                             f"{kernel.BF16_CHUNKS}, head dim <= "
                             f"{kernel.BF16_MAX_HEAD_DIM} and state <= "
                             f"{kernel.BF16_MAX_STATE}, got chunk {chunk}, "
                             f"head dim {P}, state {N}")
    elif kernel.smem_bytes(chunk, P, N) > kernel.SMEM_LIMIT:
        raise ValueError(f"{name} kernel: chunk {chunk}, head dim {P} and "
                         f"state {N} need {kernel.smem_bytes(chunk, P, N)} "
                         f"bytes of shared memory, over {kernel.SMEM_LIMIT}")
    # the kernel writes its outputs through ctypes, outside autograd: a
    # gradient through it would be lost without a word, so refuse it
    # until the kernel has a backward
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xd, a, B_, C_)):
        raise _no_backward(name)


def ssd_scan(xd, a, B_, C_, chunk: int = 128):
    """The chunked SSD scan from a zero state. Returns (y [B, L, H, P] in
    xd's dtype, final state [B, H, P, N] float32)."""
    _check(xd, a, B_, C_, chunk)
    if xd.device.type == "cpu":
        return ssd_scan_ref(xd, a, B_, C_, chunk)
    _check_card(xd, a, B_, C_, chunk)
    return kernel.ssd_scan_cuda(xd, a, B_, C_, chunk)


def ssd_chunk(xd, a, B_, C_, state):
    """One chunk of one (batch, head) from ``state``: xd [K, P]; a [K]
    float32; B_, C_ [K, N] in xd's dtype; state [P, N] float32. Returns
    (y [K, P] in xd's dtype, new state [P, N] float32)."""
    if xd.dim() != 2 or a.dim() != 1 or B_.dim() != 2 or state.dim() != 2:
        raise ValueError(f"ssd_chunk expects xd [K, P], a [K], B_, C_ "
                         f"[K, N] and state [P, N], got {tuple(xd.shape)}, "
                         f"{tuple(a.shape)}, {tuple(B_.shape)}, "
                         f"{tuple(state.shape)}")
    K, P = xd.shape
    args = (xd[None, :, None, :], a[None, :, None], B_[None], C_[None])
    _check(*args, K, "ssd_chunk")
    if tuple(state.shape) != (P, B_.shape[1]) \
            or state.dtype != torch.float32 or state.device != xd.device:
        raise ValueError(f"ssd_chunk: state must be [P, N] = "
                         f"{(P, B_.shape[1])} float32 on {xd.device}, got "
                         f"{tuple(state.shape)} {state.dtype} on "
                         f"{state.device}")
    if xd.device.type == "cpu":
        f32 = torch.float32
        y, new_state = ssd_chunk_ref(xd.to(f32), a, B_.to(f32), C_.to(f32),
                                     state)
        return y.to(xd.dtype), new_state
    _check_card(*args, K, "ssd_chunk")
    if torch.is_grad_enabled() and state.requires_grad:
        raise _no_backward("ssd_chunk")
    y, new_state = kernel.ssd_scan_cuda(*args, K)
    kernel.SSD_CHUNK_LAUNCHES.add((K, P, B_.shape[1]))
    y, new_state = fold_state(y, new_state, args[1], args[3],
                              state[None, None])
    return y[0, :, 0], new_state[0, 0]
