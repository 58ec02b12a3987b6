"""Binding of the hand-written CUDA flash attention: one library of
``csrc/flash_attention.cu`` (the entry point, and the fp32 kernel on the
CUDA cores) and ``csrc/flash_attention_wgmma.cu`` (the bf16 kernel:
wgmma on the tensor cores, fed by TMA), the entry point choosing by
dtype; and one of ``csrc/flash_attention_bwd.cu`` (the backward's entry
point, and its fp32 kernels on the CUDA cores) and
``csrc/flash_attention_bwd_wgmma.cu`` (its bf16 kernels: wgmma fed by
TMA), the backward's entry choosing by dtype in the same way (dq, dk and
dv from the forward's output and logsumexp), built apart so that the
two build at once.

Built with ``nvcc`` for ``sm_90a`` at first use
(``repro_torch.kernels.build``) and called through ``ctypes``, as the
LSTM and EVL kernels are: pointers, the (batch, seq, head) strides of
q, k, v and the output, and the current stream go in; the C function
returns ``cudaGetLastError()``, raised here if it is not 0, or one of
``TMA_REFUSED``'s codes (the backward's ``BWD_TMA_REFUSED``), raised as
a ``ValueError``.
``FLASH_LAUNCHES`` counts the launches by ``launch_key``: (B, Sq, Skv,
Hq, Hkv, D) for a causal launch, with ``NON_CAUSAL`` appended for one
without the causal mask (the encoder's and cross-attention's).
``FLASH_BWD_LAUNCHES`` counts the backward's by the same keys, one a
call of its entry point (which runs its three kernels).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LaunchCounter

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [_CSRC / "flash_attention.cu", _CSRC / "flash_attention_wgmma.cu"]
BWD_SOURCES = [_CSRC / "flash_attention_bwd.cu",
               _CSRC / "flash_attention_bwd_wgmma.cu"]
LIBRARIES = {"flash_attention": SOURCES, "flash_attention_bwd": BWD_SOURCES}
# the head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 80, 128)
# the entry point's returns when the CUDA driver refuses to encode a
# bf16 operand's tensor map (TMA reads only 16-byte aligned tensors whose
# strides are 16-byte multiples), before anything is launched; cudaError
# values are positive. The backward's are the same, and one for dout.
TMA_REFUSED = {-1: "q", -2: "k", -3: "v"}
BWD_TMA_REFUSED = {**TMA_REFUSED, -4: "dout"}
# the backward's fp32 scratch holds lse in log2 units and Delta for each
# query row, the rows padded to a multiple of this (its bf16 kernels'
# query block)
BWD_ROW_PAD = 128

FLASH_LAUNCHES = LaunchCounter()
FLASH_BWD_LAUNCHES = LaunchCounter()
# the mask's mark in a launch key
NON_CAUSAL = "non-causal"

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention", SOURCES)
    fn = lib.flash_attention_forward
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 5 + [_L] * 12 + [_I] * 11
                       + [ctypes.c_float, _P])
        fn.restype = _I
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd", BWD_SOURCES)
    fn = lib.flash_attention_backward
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 9 + [ctypes.c_float, _P]
        fn.restype = _I
    return lib


def launch_key(B, Sq, Skv, Hq, Hkv, D, causal: bool = True) -> tuple:
    """A launch's key in ``FLASH_LAUNCHES``: its shape, and the mark
    ``NON_CAUSAL`` when it runs without the causal mask."""
    return (B, Sq, Skv, Hq, Hkv, D) + (() if causal else (NON_CAUSAL,))


def raise_for(rc: int, q, k, v, dout=None, what: str = "") -> None:
    """Raise for an entry point's return ``rc`` on q, k, v (and the
    backward's dout): a ``ValueError`` naming the operand TMA cannot
    read, a ``RuntimeError`` for a CUDA error; nothing for 0."""
    if rc == 0:
        return
    codes = TMA_REFUSED if dout is None else BWD_TMA_REFUSED
    if rc in codes:
        name = codes[rc]
        t = dict(q=q, k=k, v=v, dout=dout)[name]
        raise ValueError(
            f"flash_attention kernel (bf16, TMA) cannot read {name}: TMA "
            f"takes 16-byte aligned tensors whose (batch, seq, head) "
            f"strides are 16-byte multiples; {name} starts "
            f"{t.data_ptr() % 16} bytes past a 16-byte boundary, its "
            f"strides are {[s * t.element_size() for s in t.stride()[:3]]} "
            f"bytes at shape {tuple(t.shape)}")
    B, Sq, Hq, D = q.shape
    raise RuntimeError(f"flash_attention {what}kernel launch failed at "
                       f"B={B} Sq={Sq} Skv={k.shape[1]} Hq={Hq} "
                       f"Hkv={k.shape[2]} D={D} {q.dtype}: cudaError {rc}")


def flash_attention_cuda(q, k, v, causal: bool, window, q_offset: int,
                         kv_valid: int, lse=None):
    """Launch on validated CUDA tensors (see ``ops``): q [B, Sq, Hq, D];
    k, v [B, Skv, Hkv, D]; one dtype, fp32 or bf16; last dim contiguous.
    ``lse``, when given, a contiguous fp32 [B, Hq, Sq] that takes each
    query row's logsumexp. Returns a fresh [B, Sq, Hq, D] output in q's
    dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = q.new_empty((B, Sq, Hq, D))
    if out.numel() == 0:
        return out
    lib = _library()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), *strides,
        B, Sq, Skv, Hq, Hkv, D, int(q.dtype == torch.bfloat16), int(causal),
        0 if window is None else int(window), int(q_offset), int(kv_valid),
        D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    raise_for(rc, q, k, v)
    FLASH_LAUNCHES.add(launch_key(B, Sq, Skv, Hq, Hkv, D, causal))
    return out


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal: bool, window):
    """The backward's launch on CUDA tensors the autograd Function
    checked: q, out, dout [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D],
    contiguous, one dtype (fp32 or bf16); lse the forward's contiguous
    fp32 [B, Hq, Sq]; q_offset 0 and every key valid. Returns fresh
    (dq, dk, dv) in q's dtype. bf16 reads q, k, v and dout by TMA, so a
    tensor TMA cannot read raises a ``ValueError`` before any launch."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    rows = -(-Sq // BWD_ROW_PAD) * BWD_ROW_PAD
    delta = torch.empty((2, B, Hq, rows), dtype=torch.float32,
                        device=q.device)
    rc = _bwd_library().flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, Hq, Hkv, D,
        int(q.dtype == torch.bfloat16), int(causal),
        0 if window is None else int(window), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_for(rc, q, k, v, dout, what="backward ")
    FLASH_BWD_LAUNCHES.add(launch_key(B, Sq, Skv, Hq, Hkv, D, causal))
    return dq, dk, dv
