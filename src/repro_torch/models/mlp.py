"""The dense MLP, gated or not, and the Mixture-of-Experts layer with
GShard-style capacity-grouped dispatch (``repro.models.mlp``).

MoE: tokens are flattened batch-major into groups of ``group_size``
(the last one zero-padded); in each group every token picks its top-k
experts by an fp32 router, and each expert takes at most ``capacity``
(token, k) pairs, in the order token-major then k; a pair past capacity
is dropped, and its token keeps only what the other pairs give it (the
residual path around the layer). The function is the JAX package's,
leaf for leaf; its [G, s, E, C] one-hot dispatch and combine einsums
become gathers by index, which give the same values: for each (token,
expert) at most one k is non-zero, so each einsum sums one product with
zeros. The experts run as batched products over [E, groups x C, D], a
chunk of groups at a time, so that the buffers a chunk holds stay under
``_CHUNK_ELEMENTS`` whatever the batch. Every shape is static: no host
sync, no data-dependent size.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import ACTIVATIONS

# the most elements that one chunk of groups may hold in any of its
# [E, slots, max(D, F)] expert activations or its [tokens, k, D]
# combine rows (2**28: 512 MiB in bf16)
_CHUNK_ELEMENTS = 1 << 28


def mlp_apply(p, x, activation: str, gated: bool):
    """x [..., D] -> [..., D]; p holds w1 [D, F], w2 [F, D], w3 [D, F]
    when gated, and optional biases b1 [F], b2 [D]."""
    act = ACTIVATIONS[activation]
    h = x @ p["w1"]
    if "b1" in p:
        h = h + p["b1"]
    h = act(h)
    if gated:
        h = h * (x @ p["w3"])
    out = h @ p["w2"]
    if "b2" in p:
        out = out + p["b2"]
    return out


def moe_route(router, x, *, top_k: int, group_size: int = 512):
    """``moe_apply``'s routing: x [B, S, D] flattened batch-major into
    groups of s = min(group_size, B * S) tokens, the last zero-padded.
    Returns (the tokens [g * s + 1, D], the padding and one more zero
    row after the B * S of x; probs [g, s, E], the fp32 router's
    softmax; the top_k largest probs [g, s, k] and their experts, in
    ``lax.top_k``'s order: descending, the lower index first among equal
    values, as the padding's all-equal router logits need)."""
    B, S, D = x.shape
    tokens = x.reshape(B * S, D)
    n = tokens.shape[0]
    s = min(group_size, n)
    pad = (-n) % s
    tokens = torch.cat([tokens, tokens.new_zeros(pad + 1, D)])
    g = (n + pad) // s
    logits = tokens[:-1].reshape(g, s, D).float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return tokens, probs, vals[..., :top_k], idx[..., :top_k]


def moe_apply(p, x, *, top_k: int, activation: str, gated: bool,
              group_size: int = 512, capacity_factor: float = 1.25):
    """x [B, S, D] -> (out [B, S, D] in x's dtype, aux: the Switch
    load-balance loss, a float32 scalar on x's device, over every token
    of every group, the padding included).

    p: router [D, E] (float32 in a bf16 model), w1/w3 [E, D, F], w2
    [E, F, D]."""
    B, S, D = x.shape
    E = p["router"].shape[1]
    F = p["w1"].shape[2]
    act = ACTIVATIONS[activation]
    dev = x.device
    tokens, probs, gate_vals, gate_idx = moe_route(
        p["router"], x, top_k=top_k, group_size=group_size)
    g, s = probs.shape[:2]
    n, pad = B * S, g * s - B * S
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    capacity = max(1, int(s * top_k * capacity_factor / E))

    # each (token, k) pair's place in its expert's buffer: the group's
    # pairs up to it, token-major then over k, that chose that expert
    onehot = gate_idx[..., None] == torch.arange(E, device=dev)  # [g,s,k,E]
    pos = torch.cumsum(onehot.reshape(g, s * top_k, E).to(torch.int32),
                       dim=1, dtype=torch.int32)
    pos = torch.gather(pos, 2, gate_idx.reshape(g, s * top_k, 1)).reshape(
        g, s, top_k) - 1
    keep = pos < capacity
    pos = torch.clamp_max(pos, capacity - 1)

    # the token in each slot of [g, E, C] (the zero row where none): a
    # kept pair writes its token's index, a dropped one the spare last
    # element
    slots = E * capacity
    gi = torch.arange(g, device=dev)[:, None, None]
    dest = torch.where(keep, gi * slots + gate_idx * capacity + pos,
                       g * slots)
    src = (gi * s + torch.arange(s, device=dev)[None, :, None]).expand(
        g, s, top_k)
    token_of_slot = torch.full((g * slots + 1,), n + pad, dtype=torch.long,
                               device=dev)
    token_of_slot.scatter_(0, dest.reshape(-1), src.reshape(-1))
    token_of_slot = token_of_slot[:-1].reshape(g, E, capacity)
    # combine weights rounded to x's dtype, as ``combine.astype(dtype)``
    weight = torch.where(keep, gate_vals.to(x.dtype),
                         torch.zeros((), dtype=x.dtype, device=dev)).float()

    per_group = max(slots * max(D, F), s * top_k * D)
    chunk = max(1, _CHUNK_ELEMENTS // per_group)
    outs = []
    for g0 in range(0, g, chunk):
        gc = min(chunk, g - g0)
        idx = token_of_slot[g0:g0 + gc].permute(1, 0, 2).reshape(-1)
        expert_in = tokens.index_select(0, idx).reshape(E, gc * capacity, D)
        h = act(torch.bmm(expert_in, p["w1"]))
        if gated:
            h = h * torch.bmm(expert_in, p["w3"])
        del expert_in
        expert_out = torch.bmm(h, p["w2"]).reshape(E * gc * capacity, D)
        del h
        # each pair's row of this chunk's [E, gc, C] outputs
        row = (gate_idx[g0:g0 + gc] * (gc * capacity)
               + torch.arange(gc, device=dev)[:, None, None] * capacity
               + pos[g0:g0 + gc])
        picked = expert_out.index_select(0, row.reshape(-1)).reshape(
            gc * s, top_k, D)
        del expert_out
        w = weight[g0:g0 + gc].reshape(gc * s, top_k, 1)
        outs.append((picked.float() * w).sum(dim=1).to(x.dtype))
        del picked
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    out = out[:n].reshape(B, S, D)

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    frac_tokens = onehot.sum(dim=2).float().mean(dim=(0, 1)) / top_k
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * mean_prob)
    return out, aux
