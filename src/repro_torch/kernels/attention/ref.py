"""The flash kernel's plain PyTorch version: naive O(S^2) attention in
fp32 with GQA and the causal, sliding-window, ``q_offset`` and
``kv_valid`` masks, the same math as
``repro.kernels.attention.ref.attention_ref`` (which has no
``kv_valid``: keys at or past it are masked like padding, as the TPU
kernel masks its wrapper's padding)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  q_offset: int = 0, kv_valid=None):
    """q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D] -> [B, Sq, Hq, D] in
    q's dtype."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    Skv = k.shape[1]
    qh = q.reshape(B, Sq, Hkv, G, D)
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
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
