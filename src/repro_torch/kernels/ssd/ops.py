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
the kernel masks the ragged last chunk itself.

Gradients. On the card an input that requires grad, while grad is
enabled, goes through ``SSDScanFunction``: its forward launches the scan
kernel and saves xd, a, B_ and C_; its backward launches the backward's
entry point (``kernel.ssd_scan_bwd_cuda``: dxd, da, dB and dC from the
cotangents of y and of the final state; bf16 on wgmma fed by TMA,
``csrc/ssd_scan_bwd_wgmma.cu``, which takes the forward's bf16 shapes;
fp32 on the CUDA cores of ``csrc/ssd_scan_bwd.cu``, which takes states
up to 128 and what fits its shared memory); any other shape raises
before anything is launched. On the CPU the gradient is autograd's of
the plain version, the one CPU route.

``ssd_chunk(xd, a, B_, C_, state)`` is the counterpart of
``repro.kernels.ssd.ops.ssd_chunk_fused``: one chunk of one (batch,
head) from a given state, xd [K, P]; a [K] float32; B_, C_ [K, N];
state [P, N] float32. On the card it runs the same scan (through
``SSDScanFunction`` when a gradient is asked) at chunk K from zero and
folds the state in after it (``ref.fold_state``, plain differentiable
torch), as the TPU entry does; on the CPU it runs ``ref.ssd_chunk_ref``.
It takes the same checks.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.ssd import kernel
from repro_torch.kernels.ssd.ref import fold_state, ssd_chunk_ref, \
    ssd_scan_ref

_DTYPES = (torch.float32, torch.bfloat16)


def _on_card(t) -> bool:
    """The route of a checked tensor: the card's kernels (True) or, on
    the CPU, the plain versions."""
    return t.device.type == "cuda"


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


def _check_grad(xd, B_, chunk, name="ssd_scan") -> None:
    """What the backward kernel takes, checked before the forward's
    launch. The bf16 backward takes the shapes the bf16 forward takes
    (``_check_card``)."""
    if xd.dtype == torch.bfloat16:
        return
    P, N = xd.shape[3], B_.shape[2]
    need = kernel.bwd_smem_bytes(chunk, P, N)
    if N > kernel.BWD_MAX_STATE or need > kernel.SMEM_LIMIT:
        raise ValueError(f"{name} backward kernel takes states <= "
                         f"{kernel.BWD_MAX_STATE} and at most "
                         f"{kernel.SMEM_LIMIT} bytes of shared memory, got "
                         f"chunk {chunk}, head dim {P}, state {N} ({need} "
                         f"bytes)")


class SSDScanFunction(torch.autograd.Function):
    """The SSD scan on the card with its gradient: the scan kernel, then
    the backward kernel, from the cotangents of y and of the final state
    (None where the caller dropped it). Takes checked CUDA tensors
    (``ssd_scan``)."""

    @staticmethod
    def forward(ctx, xd, a, B_, C_, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xd, a, B_, C_)
        ctx.chunk = chunk
        return kernel.ssd_scan_cuda(xd, a, B_, C_, chunk)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dstate):
        xd, a, B_, C_ = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xd)
        grads = kernel.ssd_scan_bwd_cuda(
            xd, a, B_, C_, ctx.chunk, dy.to(xd.dtype).contiguous(),
            None if dstate is None else dstate.float().contiguous())
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def _scan_card(xd, a, B_, C_, chunk, name="ssd_scan"):
    """The card's scan on checked tensors: through ``SSDScanFunction``
    where autograd records an input, else the kernel alone."""
    _check_card(xd, a, B_, C_, chunk, name)
    # the kernel writes its outputs through ctypes, outside autograd: a
    # gradient goes through the Function, whose backward is a kernel too
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xd, a, B_, C_)):
        _check_grad(xd, B_, chunk, name)
        return SSDScanFunction.apply(xd, a, B_, C_, chunk)
    return kernel.ssd_scan_cuda(xd, a, B_, C_, chunk)


def ssd_scan(xd, a, B_, C_, chunk: int = 128):
    """The chunked SSD scan from a zero state. Returns (y [B, L, H, P] in
    xd's dtype, final state [B, H, P, N] float32)."""
    _check(xd, a, B_, C_, chunk)
    if not _on_card(xd):
        return ssd_scan_ref(xd, a, B_, C_, chunk)
    return _scan_card(xd, a, B_, C_, chunk)


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
    if not _on_card(xd):
        f32 = torch.float32
        y, new_state = ssd_chunk_ref(xd.to(f32), a, B_.to(f32), C_.to(f32),
                                     state)
        return y.to(xd.dtype), new_state
    y, new_state = _scan_card(*args, K, "ssd_chunk")
    kernel.SSD_CHUNK_LAUNCHES.add((K, P, B_.shape[1]))
    y, new_state = fold_state(y, new_state, args[1], args[3],
                              state[None, None])
    return y[0, :, 0], new_state[0, 0]
