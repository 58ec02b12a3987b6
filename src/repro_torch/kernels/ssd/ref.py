"""The SSD kernel's plain PyTorch versions: one chunk of the Mamba2
state-space-duality recurrence (``ssd_chunk_ref``, the same math as
``repro.kernels.ssd.ref.ssd_chunk_ref``) and the whole scan over the
chunks (``ssd_scan_ref``, the same math, padding and casts as
``repro.models.ssm.ssd_chunked`` with no initial state); and
``fold_state``, which folds a given initial state into a scan run from
zero, on both devices, as the TPU kernel's single-chunk entry
(``repro.kernels.ssd.ops.ssd_chunk_fused``) does."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def segsum(a):
    """[..., K] -> [..., K, K] lower-triangular segment sums:
    out[..., q, k] = sum_{i in (k, q]} a[..., i] for q >= k, else -inf."""
    K = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    d = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((K, K), dtype=torch.bool, device=a.device))
    return torch.where(mask, d, float("-inf"))


def ssd_chunk_ref(xd, a, B_, C_, state):
    """One chunk of one (batch, head): xd [K, P] (dt-scaled inputs); a [K]
    (dt * A, negative); B_, C_ [K, N]; state [P, N]. Returns (y [K, P],
    new_state [P, N]), all float32."""
    K = xd.shape[0]
    cum = torch.cumsum(a, dim=0)
    d = cum[:, None] - cum[None, :]
    mask = torch.tril(torch.ones((K, K), dtype=torch.bool, device=a.device))
    L = torch.where(mask, torch.exp(d), 0.0)

    scores = C_ @ B_.T
    y = (scores * L) @ xd                               # intra-chunk
    y = y + (C_ @ state.T) * torch.exp(cum)[:, None]    # carried state

    total = cum[-1]
    decay_k = torch.exp(total - cum)
    new_state = state * torch.exp(total) + xd.T @ (B_ * decay_k[:, None])
    return y, new_state


def ssd_scan_ref(xd, a, B_, C_, chunk: int = 128):
    """The chunked scan from a zero state: xd [B, L, H, P]; a [B, L, H]
    (float32); B_, C_ [B, L, N]. L is padded to a multiple of ``chunk``
    with a = 0 and xd = B_ = C_ = 0 (inert steps). Every chunk works in
    float32 (in float64 when xd is float64: a reference against which
    to read the float32 versions' own error); y is cast to xd's dtype
    chunk by chunk. Returns (y [B, L, H, P] in xd's dtype, final state
    [B, H, P, N] in the working dtype)."""
    Bsz, L, H, P = xd.shape
    N = B_.shape[-1]
    pad = (-L) % chunk
    if pad:
        xd = F.pad(xd, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    nc = (L + pad) // chunk
    xc = xd.reshape(Bsz, nc, chunk, H, P)
    ac = a.reshape(Bsz, nc, chunk, H)
    Bc = B_.reshape(Bsz, nc, chunk, N)
    Cc = C_.reshape(Bsz, nc, chunk, N)

    work = torch.float64 if xd.dtype == torch.float64 else torch.float32
    state = torch.zeros((Bsz, H, P, N), dtype=work, device=xd.device)
    ys = []
    for c in range(nc):
        x32 = xc[:, c].to(work)                         # [B, K, H, P]
        a_hk = ac[:, c].to(work).transpose(1, 2)        # [B, H, K]
        B32 = Bc[:, c].to(work)                         # [B, K, N]
        C32 = Cc[:, c].to(work)
        cum = torch.cumsum(a_hk, dim=-1)
        Lmat = torch.exp(segsum(a_hk))                  # [B, H, K, K]

        # intra-chunk (the dual, attention-like form)
        scores = torch.einsum("bqn,bkn->bqk", C32, B32)
        Y = torch.einsum("bqk,bhqk,bkhp->bqhp", scores, Lmat, x32)
        # the carried state
        decay_q = torch.exp(cum).transpose(1, 2)        # [B, K, H]
        Y = Y + torch.einsum("bqn,bqh,bhpn->bqhp", C32, decay_q, state)
        # state update
        total = cum[..., -1]                            # [B, H]
        decay_k = torch.exp(total[..., None] - cum)     # [B, H, K]
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bkn,bhk,bkhp->bhpn", B32, decay_k, x32)
        ys.append(Y.to(xd.dtype))
    y = torch.cat(ys, dim=1) if ys else xd.new_zeros((Bsz, 0, H, P))
    return y[:, :L], state


def fold_state(y, state, a, C_, state0):
    """A scan from ``state0`` out of the same scan from zero: y [B, L, H,
    P] and state [B, H, P, N] from zero; a [B, L, H] (float32); C_
    [B, L, N]; state0 [B, H, P, N]. The given state reaches step t
    decayed by exp(cum_t), cum the cumsum of a over the whole sequence,
    so that one fold over many chunks is exact algebra:

        y_t   += (C_t . state0^T) * exp(cum_t)
        state += state0 * exp(cum_{L-1})

    Works in float32 (float64 when the state is float64) and returns y
    in its own dtype and the state in the working dtype."""
    work = torch.float64 if state.dtype == torch.float64 else torch.float32
    s0 = state0.to(work)
    if a.shape[1] == 0:
        return y, state.to(work) + s0
    cum = torch.cumsum(a.to(work), dim=1)                       # [B, L, H]
    carried = torch.einsum("bln,bhpn->blhp", C_.to(work), s0) \
        * torch.exp(cum)[..., None]
    y = (y.to(work) + carried).to(y.dtype)
    return y, state.to(work) + s0 * torch.exp(cum[:, -1])[..., None, None]
