"""Why the bf16 flash backward feeds P and dS to the tensor cores in one
bf16 piece each (``kernels/attention/csrc/flash_attention_bwd_wgmma.cu``).

A bf16 wgmma takes its register operand in bf16, while the plain version
(``attention_bwd_ref``) keeps P and dS in fp32; the card holds the
kernel's dq, dk and dv within 1e-2 of each one's max |grad| of the plain
version (``chip_smoke.py``'s ``FLASH_BWD_BF16_REL``). This file emulates
the kernel's arithmetic in plain torch on the CPU, from bf16-exact q, k,
v and dout: scores in fp32, P = exp(s - lse) from the forward's lse, Delta
from the bf16 output, P^T and dS^T (dS from the fp32 P) rounded once to
bf16 before their products, the products summed in fp32 over the
kernel's tiles in its order (dK and dV over tiles of 64 queries, dQ over
tiles of 64 keys), the gradients stored in bf16. At causal 512 and 2048
tokens (D 128) and without a mask at 1500 x 1500 and 448 x 1500 (D 64)
one bf16 piece stays within the bound (2.8e-3 to 4.7e-3 of max |grad|
on these inputs); P and dS through fp8 (e4m3) instead do not (3.0e-2 at
causal 512, 0.19 at 448 x 1500)."""

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                               attention_ref, logsumexp_ref)

REL = 1e-2          # the card's bound: of each gradient's max |grad|
TILE = 64           # the kernel's queries (dK, dV) and keys (dQ) a stage

# (Sq, Skv, heads, D, causal): the train path's and Whisper's shapes
CASES = [(512, 512, 4, 128, True), (2048, 2048, 2, 128, True),
         (1500, 1500, 2, 64, False), (448, 1500, 2, 64, False)]
_IDS = ["causal-512", "causal-2048", "full-1500", "full-448x1500"]


def _inputs(Sq, Skv, H, D, causal, seed):
    """bf16-exact q, k, v, dout [1, S, H, D], and the forward's bf16 output
    and fp32 lse, as the training forward hands them over."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((1, s, H, D))
                                      .astype(np.float32))
                     .to(torch.bfloat16)
                     for s in (Sq, Skv, Skv, Sq))
    out = attention_ref(q, k, v, causal=causal)
    lse = logsumexp_ref(q.float(), k.float(), causal=causal)
    return q, k, v, out, dout, lse


def _emulated_kernel(q, k, v, out, dout, lse, causal, piece):
    """dq, dk, dv the kernel's way, P and dS rounded once to ``piece``
    before their products."""
    _, Sq, H, D = q.shape
    Skv = k.shape[1]
    qf, kf, vf, of, dof = (t[0].float().transpose(0, 1)   # [H, S, D]
                           for t in (q, k, v, out, dout))
    lse = lse[0].float()                                   # [H, Sq]
    delta = (dof * of).sum(-1)                             # [H, Sq]
    keep = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        keep = torch.arange(Skv)[None, :] <= torch.arange(Sq)[:, None]

    def tile(qs, ks):
        """P and dS (fp32) of queries qs and keys ks, [H, |qs|, |ks|]."""
        s = qf[:, qs] @ kf[:, ks].transpose(1, 2) * D ** -0.5
        p = torch.where(keep[qs][:, ks], torch.exp(s - lse[:, qs, None]),
                        0.0)
        dp = dof[:, qs] @ vf[:, ks].transpose(1, 2)
        return p, p * (dp - delta[:, qs, None])

    def rounded(x):
        return x.to(piece).float()

    every_q, every_k = slice(0, Sq), slice(0, Skv)
    dk = torch.zeros(H, Skv, D)
    dv = torch.zeros(H, Skv, D)
    for q0 in range(0, Sq, TILE):
        qs = slice(q0, q0 + TILE)
        p, ds = tile(qs, every_k)
        dv += rounded(p).transpose(1, 2) @ dof[:, qs]
        dk += rounded(ds).transpose(1, 2) @ qf[:, qs]
    dq = torch.zeros(H, Sq, D)
    for k0 in range(0, Skv, TILE):
        ks = slice(k0, k0 + TILE)
        _, ds = tile(every_q, ks)
        dq += rounded(ds) @ kf[:, ks]
    return [(g * c).transpose(0, 1)[None].to(torch.bfloat16)
            for g, c in ((dq, D ** -0.5), (dk, D ** -0.5), (dv, 1.0))]


def _worst(got, want):
    """The largest |got - want| over max |want| of dq, dk and dv."""
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max()) for g, w in zip(got, want))


@functools.lru_cache(maxsize=None)
def _reference(Sq, Skv, H, D, causal):
    """A case's inputs and ``attention_bwd_ref``'s gradients, made once
    for both roundings."""
    args = _inputs(Sq, Skv, H, D, causal, seed=Sq + Skv + D)
    return args, attention_bwd_ref(*(t.float() for t in args[:5]), args[5],
                                   causal=causal)


def _case(Sq, Skv, H, D, causal, piece):
    args, want = _reference(Sq, Skv, H, D, causal)
    return _worst(_emulated_kernel(*args, causal, piece), want)


@pytest.mark.parametrize("case", CASES, ids=_IDS)
def test_p_and_ds_in_one_bf16_piece_hold_the_card_bound(case):
    worst = _case(*case, torch.bfloat16)
    assert worst <= REL, worst


@pytest.mark.parametrize("case", [CASES[0], CASES[3]],
                         ids=[_IDS[0], _IDS[3]])
def test_p_and_ds_through_fp8_break_the_card_bound(case):
    worst = _case(*case, torch.float8_e4m3fn)
    assert worst > REL, worst
