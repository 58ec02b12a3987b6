"""The SSD kernel's plain PyTorch versions: one chunk of the Mamba2
state-space-duality recurrence (``ssd_chunk_ref``, the same math as
``repro.kernels.ssd.ref.ssd_chunk_ref``) and the whole scan over the
chunks (``ssd_scan_ref``, the same math, padding and casts as
``repro.models.ssm.ssd_chunked`` with no initial state); the scan's
gradient written out chunk by chunk (``ssd_scan_bwd_ref``, what the
JAX package takes as XLA's autodiff of ``ssd_chunked``); and
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


def _pad_chunks(t, pad: int, nc: int, chunk: int):
    """[B, L, ...] -> [B, nc, chunk, ...], L padded with zeros."""
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], nc, chunk, *t.shape[2:])


def ssd_scan_bwd_ref(xd, a, B_, C_, chunk, dy, dstate=None):
    """The gradient of ``ssd_scan_ref`` written out, chunk by chunk: the
    cotangents dy [B, L, H, P] of y and ``dstate`` [B, H, P, N] of the
    final state (None: zero) give (dxd, da, dB, dC), each in its input's
    dtype. Works in float32 (float64 when xd is float64); L is padded to
    a multiple of ``chunk`` as ``ssd_scan_ref`` pads it.

    For a chunk, cum the cumsum of a over it, S the state that enters it
    and dS the cotangent of the state that leaves it, Lmat = exp(cum_q -
    cum_k) on and below the diagonal (0 above), scores = C B^T, M =
    scores o Lmat, dM = dy xd^T, D = dM o Lmat, decay_k = exp(cum_K -
    cum_k) and cum_K the chunk's last cum:

        dxd = M^T dy + (B o decay) dS^T
        dC  = D B + exp(cum) o (dy S)
        dB  = D^T C + decay o (xd dS)
        dS_in = exp(cum_K) dS + sum_q exp(cum_q) dy_q^T C_q

    and dcum gathers the segment sums' term (D o scores: its row sums
    with a plus sign, its column sums with a minus sign), the carried
    state's (exp(cum_q) C_q . (dy S)_q), the state update's decay
    (minus decay_k B_k . (xd dS)_k at row k, their sum at the last row)
    and the carried state's decay (exp(cum_K) <S, dS> at the last row);
    da is dcum's reverse cumsum within the chunk. B_ and C_ are shared
    by the heads, so dB and dC sum over them."""
    Bsz, L, H, P = xd.shape
    N = B_.shape[-1]
    work = torch.float64 if xd.dtype == torch.float64 else torch.float32
    pad = (-L) % chunk
    nc = (L + pad) // chunk
    xc, dyc = (_pad_chunks(t.to(work), pad, nc, chunk) for t in (xd, dy))
    ac = _pad_chunks(a.to(work), pad, nc, chunk)
    Bc, Cc = (_pad_chunks(t.to(work), pad, nc, chunk) for t in (B_, C_))

    states = [torch.zeros((Bsz, H, P, N), dtype=work, device=xd.device)]
    for c in range(nc - 1):                 # the state entering each chunk
        cum = torch.cumsum(ac[:, c].transpose(1, 2), dim=-1)    # [B, H, K]
        decay = torch.exp(cum[..., -1:] - cum)
        states.append(states[-1] * torch.exp(cum[..., -1])[..., None, None]
                      + torch.einsum("bkn,bhk,bkhp->bhpn", Bc[:, c], decay,
                                     xc[:, c]))
    dS = (torch.zeros_like(states[0]) if dstate is None
          else dstate.to(work))
    dxs, das, dBs, dCs = [], [], [], []
    for c in reversed(range(nc)):
        x, g, Bk, Ck, S = xc[:, c], dyc[:, c], Bc[:, c], Cc[:, c], states[c]
        a_hk = ac[:, c].transpose(1, 2)                         # [B, H, K]
        cum = torch.cumsum(a_hk, dim=-1)
        Lmat = torch.exp(segsum(a_hk))                      # [B, H, K, K]
        ecum = torch.exp(cum)
        total = cum[..., -1]
        decay = torch.exp(total[..., None] - cum)
        scores = torch.einsum("bqn,bkn->bqk", Ck, Bk)
        D = torch.einsum("bqhp,bkhp->bhqk", g, x) * Lmat
        dyS = torch.einsum("bqhp,bhpn->bhqn", g, S)
        xdS = torch.einsum("bkhp,bhpn->bhkn", x, dS)
        dxs.append(torch.einsum("bqk,bhqk,bqhp->bkhp", scores, Lmat, g)
                   + torch.einsum("bkn,bhk,bhpn->bkhp", Bk, decay, dS))
        dCs.append(torch.einsum("bhqk,bkn->bqn", D, Bk)
                   + torch.einsum("bhq,bhqn->bqn", ecum, dyS))
        dBs.append(torch.einsum("bhqk,bqn->bkn", D, Ck)
                   + torch.einsum("bhk,bhkn->bkn", decay, xdS))
        E = D * scores[:, None]
        carried = ecum * torch.einsum("bhqn,bqn->bhq", dyS, Ck)
        G = decay * torch.einsum("bhkn,bkn->bhk", xdS, Bk)
        dcum = E.sum(-1) - E.sum(-2) + carried - G
        dcum[..., -1] += G.sum(-1) + torch.exp(total) * (S * dS).sum((-2, -1))
        da = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
        das.append(da.transpose(1, 2))                          # [B, K, H]
        dS = dS * torch.exp(total)[..., None, None] + torch.einsum(
            "bhq,bqhp,bqn->bhpn", ecum, g, Ck)
    dxd, da, dB, dC = (torch.cat(t[::-1], dim=1)[:, :L]
                       for t in (dxs, das, dBs, dCs))
    return (dxd.to(xd.dtype), da.to(a.dtype), dB.to(B_.dtype),
            dC.to(C_.dtype))


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
