"""Flash attention's wrapper: argument checks and the device route.

q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D], Hq a multiple of Hkv (GQA),
the layout of ``repro.kernels.attention.ops.flash_attention``. A CUDA
tensor goes to the hand-written kernel (``kernel.flash_attention_cuda``)
or raises; a CPU tensor goes to the plain version
(``ref.attention_ref``). On the card bf16 runs on the tensor-core
kernel, which reads q, k and v by TMA, so it also needs 16-byte aligned
tensors whose strides are 16-byte multiples: the CUDA driver refuses
any other when the kernel's entry point encodes its tensor maps, and the
binding raises a ``ValueError`` before anything is launched. fp32 runs
on the CUDA-core kernel, which takes any stride. The TPU wrapper's
padding of S to its blocks and folding of heads into the batch have no
counterpart: the kernels read the [B, S, H, D] tensors through their
strides and mask their own ragged edges.

Gradients. On the card an input that requires grad, while grad is
enabled, goes through ``FlashAttentionFunction``: its forward launches
the kernel with the logsumexp output and saves q, k, v, the output and
the logsumexp; its backward launches the backward's entry point (dq, dk
and dv in the inputs' dtype): bf16 on the tensor-core kernels of
``csrc/flash_attention_bwd_wgmma.cu``, which read q, k, v and dout by
TMA (the same 16-byte rules, a ``ValueError`` naming the operand), fp32
on the CUDA-core kernels of ``csrc/flash_attention_bwd.cu``. That
backward takes what a training forward launches, causal with an
optional window or no mask at all, at q_offset 0 with every key valid;
any other argument raises before anything is launched. On the CPU the
gradient is autograd's of the plain version, the one CPU route.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.attention import kernel
from repro_torch.kernels.attention.ref import attention_ref

_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, window, q_offset, kv_valid) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention expects q [B, Sq, Hq, D] and k, v "
                         f"[B, Skv, Hkv, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B \
            or k.shape[3] != D or k.shape[2] == 0 or Hq % k.shape[2]:
        raise ValueError(f"flash_attention: k and v must be [B, Skv, Hkv, D] "
                         f"with Hq % Hkv == 0 for q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be None or >= 1, "
                         f"got {window}")
    # a query row that sees no key has no softmax: the TPU kernel and the
    # plain version then average garbage in different ways, so neither
    # an empty key range nor a query before position 0 is taken
    if kv_valid is not None and not 1 <= kv_valid <= k.shape[1]:
        raise ValueError(f"flash_attention: kv_valid must be in [1, "
                         f"{k.shape[1]}], got {kv_valid}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    # with a window, the last query row sees the keys in (pos - window,
    # kv_end): empty once the window has slid past the last valid key
    kv_end = k.shape[1] if kv_valid is None else kv_valid
    if window is not None and q.shape[1] \
            and q_offset + q.shape[1] - window >= kv_end:
        raise ValueError(f"flash_attention: window {window} leaves query "
                         f"position {q_offset + q.shape[1] - 1} no key "
                         f"below {kv_end}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: q, k, v must share one device, "
                         f"got {sorted(map(str, devices))}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")


def _check_cuda(q, k, v) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q, k, v all float32 "
                        f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.shape[3] not in kernel.HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{kernel.HEAD_DIMS}, got {q.shape[3]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention kernel takes a contiguous "
                             f"last dim, {name} has stride {t.stride(3)}")


def _check_grad(q, k, causal, window, q_offset, kv_valid) -> None:
    """What the backward kernel takes: training's launches only."""
    if q_offset != 0 or kv_valid not in (None, k.shape[1]) \
            or (window is not None and not causal):
        raise ValueError(f"flash_attention backward kernel takes q_offset "
                         f"0, every key valid and a window only with the "
                         f"causal mask, got q_offset {q_offset}, kv_valid "
                         f"{kv_valid} of {k.shape[1]}, causal {causal}, "
                         f"window {window}")


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention on the card with its gradient: the forward kernel
    (writing each row's logsumexp), then the backward kernel. Takes
    checked CUDA tensors (``flash_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        B, Sq, Hq, _ = q.shape
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        out = kernel.flash_attention_cuda(q, k, v, causal, window, 0,
                                          k.shape[1], lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attention_bwd_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), out,
            dout.contiguous(), lse, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0, kv_valid=None):
    """Attention of q over the keys ``[0, kv_valid)`` (all of them by
    default), query row i at position ``q_offset + i``; causal and a
    sliding ``window`` (keys in ``(pos - window, pos]``) as asked.
    Returns [B, Sq, Hq, D] in q's dtype."""
    _check(q, k, v, window, q_offset, kv_valid)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_valid=kv_valid)
    _check_cuda(q, k, v)
    # the kernel writes its output through ctypes, outside autograd: a
    # gradient goes through the Function, whose backward is a kernel too
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check_grad(q, k, causal, window, q_offset, kv_valid)
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    return kernel.flash_attention_cuda(
        q, k, v, causal, window, q_offset,
        k.shape[1] if kv_valid is None else kv_valid)
