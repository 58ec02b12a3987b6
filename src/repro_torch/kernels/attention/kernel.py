"""Binding of the hand-written CUDA flash attention: one library of
``csrc/flash_attention.cu`` (the entry point, and the fp32 kernel on the
CUDA cores) and ``csrc/flash_attention_wgmma.cu`` (the bf16 kernel:
wgmma on the tensor cores, fed by TMA), the entry point choosing by
dtype.

Built with ``nvcc`` for ``sm_90a`` at first use
(``repro_torch.kernels.build``) and called through ``ctypes``, as the
LSTM and EVL kernels are: pointers, the (batch, seq, head) strides of
q, k, v and the output, and the current stream go in; the C function
returns ``cudaGetLastError()``, raised here if it is not 0, or one of
``TMA_REFUSED``'s codes, raised as a ``ValueError``.
``FLASH_LAUNCHES`` counts the launches by ``launch_key``: (B, Sq, Skv,
Hq, Hkv, D) for a causal launch, with ``NON_CAUSAL`` appended for one
without the causal mask (the encoder's and cross-attention's).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LaunchCounter

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [_CSRC / "flash_attention.cu", _CSRC / "flash_attention_wgmma.cu"]
LIBRARIES = {"flash_attention": SOURCES}
# the head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 80, 128)
# the entry point's returns when the CUDA driver refuses to encode a
# bf16 operand's tensor map (TMA reads only 16-byte aligned tensors whose
# strides are 16-byte multiples), before anything is launched; cudaError
# values are positive
TMA_REFUSED = {-1: "q", -2: "k", -3: "v"}

FLASH_LAUNCHES = LaunchCounter()
# the mask's mark in a launch key
NON_CAUSAL = "non-causal"

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention", SOURCES)
    fn = lib.flash_attention_forward
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 4 + [_L] * 12 + [_I] * 11
                       + [ctypes.c_float, _P])
        fn.restype = _I
    return lib


def launch_key(B, Sq, Skv, Hq, Hkv, D, causal: bool = True) -> tuple:
    """A launch's key in ``FLASH_LAUNCHES``: its shape, and the mark
    ``NON_CAUSAL`` when it runs without the causal mask."""
    return (B, Sq, Skv, Hq, Hkv, D) + (() if causal else (NON_CAUSAL,))


def raise_for(rc: int, q, k, v) -> None:
    """Raise for the entry point's return ``rc`` on q, k, v: a
    ``ValueError`` naming the operand TMA cannot read, a
    ``RuntimeError`` for a CUDA error; nothing for 0."""
    if rc == 0:
        return
    if rc in TMA_REFUSED:
        name = TMA_REFUSED[rc]
        t = dict(q=q, k=k, v=v)[name]
        raise ValueError(
            f"flash_attention kernel (bf16, TMA) cannot read {name}: TMA "
            f"takes 16-byte aligned tensors whose (batch, seq, head) "
            f"strides are 16-byte multiples; {name} starts "
            f"{t.data_ptr() % 16} bytes past a 16-byte boundary, its "
            f"strides are {[s * t.element_size() for s in t.stride()[:3]]} "
            f"bytes at shape {tuple(t.shape)}")
    B, Sq, Hq, D = q.shape
    raise RuntimeError(f"flash_attention kernel launch failed at "
                       f"B={B} Sq={Sq} Skv={k.shape[1]} Hq={Hq} "
                       f"Hkv={k.shape[2]} D={D} {q.dtype}: cudaError {rc}")


def flash_attention_cuda(q, k, v, causal: bool, window, q_offset: int,
                         kv_valid: int):
    """Launch on validated CUDA tensors (see ``ops``): q [B, Sq, Hq, D];
    k, v [B, Skv, Hkv, D]; one dtype, fp32 or bf16; last dim contiguous.
    Returns a fresh [B, Sq, Hq, D] output in q's dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = q.new_empty((B, Sq, Hq, D))
    if out.numel() == 0:
        return out
    lib = _library()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        B, Sq, Skv, Hq, Hkv, D, int(q.dtype == torch.bfloat16), int(causal),
        0 if window is None else int(window), int(q_offset), int(kv_valid),
        D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    raise_for(rc, q, k, v)
    FLASH_LAUNCHES.add(launch_key(B, Sq, Skv, Hq, Hkv, D, causal))
    return out
