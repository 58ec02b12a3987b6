"""GQA attention of the model zoo (``repro.models.attention``).

``blocked_attention`` is the attention every zoo forward runs. In the
JAX package it is a pure-JAX online-softmax twin of the Pallas kernel;
here it is the routed flash attention itself
(``kernels.dispatch.flash_attention``): on the card the hand-written
CUDA kernel, on the CPU its plain version. Two differences by design:
the kernel chooses its own tiles, so the JAX function's ``q_block`` /
``kv_block`` have no counterpart; and the kernel multiplies the
probabilities with v in fp32, where ``blocked_attention`` first rounds
them to v's dtype (bf16 on the card's path), as the TPU kernel does not.

The naive oracle of the JAX package (``reference_attention``) is the
kernel's plain version here, ``kernels.attention.ref.attention_ref``.

``decode_attention`` is one token's attention over a KV cache. The JAX
package computes it in XLA, outside any Pallas kernel, and the port in
plain torch: a decode step launches no kernel of the port's own.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

NEG_INF = -1e30

# q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D], Hq % Hkv == 0 (GQA); causal,
# a sliding ``window`` (keys in [pos - window + 1, pos]) and ``q_offset``
# (the absolute position of q[0]) as in the JAX function; [B, Sq, Hq, D]
# in q's dtype
blocked_attention = dispatch.flash_attention


def _bmm_f32(a, b):
    """a [N, M, K] @ b [N, K, J] in one storage dtype, accumulated and
    returned in float32 (XLA's ``preferred_element_type=float32``): on
    the card a bf16 product with a float32 result, on the CPU the same
    products of the widened operands (bf16 x bf16 is exact in float32)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def decode_attention(q, sources):
    """Single-token decode attention over one or more KV sources under
    one shared max and one denominator, so that differently placed
    buffers (the read-only main cache, the recent slots) are never
    concatenated.

    q: [B, 1, Hq, D] (RoPE applied); sources: (k, v, valid_len) with k,
    v [B, Sk, Hkv, D] and valid_len an int (or 0-d integer tensor):
    entries [0, valid_len) attend. k and v stay in their storage dtype,
    products accumulate in float32 and the probabilities are rounded to
    k's dtype before P.V, as in the JAX function. Returns [B, 1, Hq, D]
    in q's dtype."""
    B, _, Hq, D = q.shape
    Hkv = sources[0][0].shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    kdt = sources[0][0].dtype
    qh = q[:, 0].reshape(B * Hkv, G, D).to(kdt)

    scores = []
    for k, v, valid_len in sources:
        Sk = k.shape[1]
        kt = k.permute(0, 2, 3, 1).reshape(B * Hkv, D, Sk)
        s = _bmm_f32(qh, kt).reshape(B, Hkv, G, Sk) * scale
        valid = torch.arange(Sk, device=k.device) < valid_len
        scores.append(torch.where(valid, s, NEG_INF))

    m = scores[0].amax(dim=-1)
    for s in scores[1:]:
        m = torch.maximum(m, s.amax(dim=-1))
    denom = torch.zeros_like(m)
    out = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for s, (k, v, _) in zip(scores, sources):
        p = torch.exp(s - m[..., None])
        denom = denom + p.sum(dim=-1)
        vh = v.permute(0, 2, 1, 3).reshape(B * Hkv, v.shape[1], D)
        out = out + _bmm_f32(p.to(kdt).reshape(B * Hkv, G, -1),
                             vh).reshape(B, Hkv, G, D)
    out = out / torch.clamp(denom[..., None], min=1e-30)
    return out.reshape(B, 1, Hq, D).to(q.dtype)
