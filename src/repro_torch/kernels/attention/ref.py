"""The flash kernels' plain PyTorch versions: naive O(S^2) attention in
fp32 with GQA and the causal, sliding-window, ``q_offset`` and
``kv_valid`` masks, the same math as
``repro.kernels.attention.ref.attention_ref`` (which has no
``kv_valid``: keys at or past it are masked like padding, as the TPU
kernel masks its wrapper's padding); each query row's logsumexp, which
the training forward writes beside its output; and the backward,
``attention_bwd_ref``, the gradient the backward kernel computes,
written out step by step from that logsumexp."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q, k, causal, window, q_offset, kv_valid):
    """The scaled fp32 scores [B, Sq, Hkv, G, Skv], NEG_INF where a mask
    removes the pair."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    Skv = k.shape[1]
    qh = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qh.to(torch.float32),
                     k.to(torch.float32)) * (D ** -0.5)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    if kv_valid is not None:
        mask &= (kpos < kv_valid)[None, :]
    return torch.where(mask[None, :, None, None, :], s, NEG_INF)


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  q_offset: int = 0, kv_valid=None):
    """q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D] -> [B, Sq, Hq, D] in
    q's dtype."""
    B, Sq, Hq, D = q.shape
    s = _scores(q, k, causal, window, q_offset, kv_valid)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def logsumexp_ref(q, k, *, causal: bool = True, window=None):
    """Each query row's logsumexp of its scaled, masked scores: fp32
    [B, Hq, Sq], what the training forward writes beside its output."""
    B, Sq, Hq, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal, window, 0, None), dim=-1)
    return lse.reshape(B, Sq, Hq).permute(0, 2, 1).contiguous()


def attention_bwd_ref(q, k, v, out, dout, lse, *, causal: bool = True,
                      window=None):
    """The backward kernel's plain version, in fp32, for training's
    launches (q_offset 0, every key valid): q, out, dout [B, Sq, Hq, D];
    k, v [B, Skv, Hkv, D]; lse the forward's [B, Hq, Sq]. Returns (dq,
    dk, dv) in q's dtype, the sums over a GQA group's query heads in
    dk and dv.

        P     = exp(s - lse)                (0 where the mask removes)
        dV    = P^T dout
        dP    = dout V^T
        Delta = rowsum(dout * out)
        dS    = P (dP - Delta)
        dQ    = dS K D^-0.5,   dK = dS^T Q D^-0.5
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    f32 = torch.float32
    scale = D ** -0.5
    s = _scores(q, k, causal, window, 0, None)        # [B, Sq, Hkv, G, Skv]
    lse5 = lse.to(f32).permute(0, 2, 1).reshape(B, Sq, Hkv, G)
    p = torch.exp(s - lse5[..., None])
    do5 = dout.to(f32).reshape(B, Sq, Hkv, G, D)
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p, do5)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", do5, v.to(f32))
    delta = (do5 * out.to(f32).reshape(B, Sq, Hkv, G, D)).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, k.to(f32)) * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds,
                      q.to(f32).reshape(B, Sq, Hkv, G, D)) * scale
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))
