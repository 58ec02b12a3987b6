"""Why the bf16 SSD kernel splits M and the state into two bf16 pieces and
B o decay into three (``kernels/ssd/csrc/ssd_scan_wgmma.cu``).

A bf16 wgmma takes its operands in bf16. xd, B_ and C_ come in bf16 and
are exact; three operands are fp32 and must be rounded: M = (C B^T) o
exp(cum_i - cum_j), the state carried from chunk to chunk (the B operand
of C state^T) and B o exp(total - cum_k) (the A operand of the state
update). This file emulates the kernel's arithmetic in plain torch on
the CPU: chunks of 128, cum summed in double and rounded once, each fp32
operand split into bf16 pieces (the first the rounding of the value,
each next one the rounding of what the earlier ones leave), each product
summed in fp32, the state update summed apart and then added in fp32, y
rounded to bf16 once. (The kernel takes M's exp by the MUFU unit, good
to about 2^-21, below what two bf16 pieces of M keep, 2^-17; here it is
torch's.) The card holds the kernel against the plain version
``ssd_scan_ref`` at y in bf16 rtol 1e-2 / atol 1e-4 and the fp32 state
at 1e-4 / 1e-5, and, after a step clipped mid-chunk, against a float64
run of the plain version within three times the plain version's own
error (plus 1e-7). Here the emulation is held to the same bounds at the
serving path's long prompt (2048 tokens, heads of 64, state 128, chunk
128; one batch row and four heads) under the slow decay, where 16 chunks
of state are carried, and after a clip mid-chunk. The kernel's split
meets every bound. One piece fewer of M or of the state breaks y's
bound; two pieces of B o decay put the state past three times the plain
version's float64 error after the clip, and one piece breaks the state's
bound outright."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd.ref import ssd_scan_ref

RTOL, ATOL = 1e-2, 1e-4              # the card's bound on y in bf16
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5  # and on the fp32 state
F64_FACTOR, F64_FLOOR = 3.0, 1e-7    # after a clip: kernel vs float64
CHUNK = 128
SHAPE = (1, 2048, 4, 64, 128)        # B, L, H, P, N: the long prompt
KERNEL = {"M": 2, "state": 2, "B o decay": 3}   # the kernel's pieces


def _inputs(seed, clip=None):
    """bf16 xd [B, L, H, P], B_, C_ [B, L, N] and fp32 a [B, L, H] under the
    slow decay -U(1e-4, 1e-2); ``clip`` rows get dt's clip, a = -100."""
    B, L, H, P, N = SHAPE
    rng = np.random.default_rng(seed)
    xd = 0.1 * rng.standard_normal((B, L, H, P))
    a = -rng.uniform(1e-4, 1e-2, (B, L, H))
    if clip is not None:
        a[:, clip] = -100.0
    B_ = 0.3 * rng.standard_normal((B, L, N))
    C_ = 0.3 * rng.standard_normal((B, L, N))
    bf = [torch.from_numpy(t.astype(np.float32)).to(torch.bfloat16)
          for t in (xd, B_, C_)]
    return bf[0], torch.from_numpy(a.astype(np.float32)), bf[1], bf[2]


def _pieces(x, n):
    """x (fp32) as n bf16 pieces, returned in fp32: their sum is x to
    about 2^(-9 n)."""
    out = []
    for _ in range(n):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def _emulated_kernel(xd, a, B_, C_, pieces):
    """The scan the kernel's way on bf16 xd, B_, C_: per (batch, head),
    chunk by chunk, with ``pieces`` bf16 pieces of each fp32 operand.
    Returns (y in bf16, the final state in fp32)."""
    Bsz, L, H, P = xd.shape
    N = B_.shape[-1]
    K = CHUNK
    y = torch.empty(Bsz, L, H, P, dtype=torch.bfloat16)
    final = torch.empty(Bsz, H, P, N)
    below = torch.tril(torch.ones(K, K, dtype=torch.bool))
    for b in range(Bsz):
        for h in range(H):
            state_t = torch.zeros(N, P)            # the state, transposed
            for t0 in range(0, L, K):
                r = min(K, L - t0)                 # rows past L are zeros
                x = torch.zeros(K, P)
                Bt, Ct = torch.zeros(K, N), torch.zeros(K, N)
                x[:r] = xd[b, t0:t0 + r, h].float()
                Bt[:r] = B_[b, t0:t0 + r].float()
                Ct[:r] = C_[b, t0:t0 + r].float()
                ad = torch.zeros(K, dtype=torch.float64)
                ad[:r] = a[b, t0:t0 + r, h].double()
                cum = torch.cumsum(ad, 0).float()  # in double, rounded once
                d = torch.where(below, cum[:, None] - cum[None, :], 0.0)
                M = torch.where(below, (Ct @ Bt.T) * torch.exp(d), 0.0)
                carried = sum(Ct @ s for s in _pieces(state_t,
                                                      pieces["state"]))
                yc = carried * torch.exp(cum)[:, None] + sum(
                    m @ x for m in _pieces(M, pieces["M"]))
                y[b, t0:t0 + r, h] = yc[:r].to(torch.bfloat16)
                total = cum[-1]
                bd = Bt * torch.exp(total - cum)[:, None]
                update = sum(p.T @ x for p in _pieces(bd,
                                                       pieces["B o decay"]))
                state_t = state_t * torch.exp(total) + update
            final[b, h] = state_t.T
    return y, final


def _share_of_the_bound(got, want, rtol, atol):
    """max |got - want| over the bound atol + rtol |want|."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _float64_shares(args, pieces):
    """The emulation's max |x - float64| over the card's bound after a
    clip (F64_FACTOR times the plain fp32 version's own, plus F64_FLOOR),
    for y and for the state."""
    got = _emulated_kernel(*args, pieces)
    plain = ssd_scan_ref(*args, CHUNK)
    exact = ssd_scan_ref(*(t.double() for t in args), CHUNK)
    shares = []
    for g, p, e in zip(got, plain, exact):
        kern = float((g.double() - e).abs().max())
        ref = float((p.double() - e).abs().max())
        shares.append(kern / (F64_FACTOR * ref + F64_FLOOR))
    return shares


@pytest.mark.parametrize("seed", [0, 1])
def test_the_kernels_split_holds_the_card_bounds_at_the_long_prompt(seed):
    args = _inputs(seed)
    want_y, want_s = ssd_scan_ref(*args, CHUNK)
    y, s = _emulated_kernel(*args, KERNEL)
    assert _share_of_the_bound(y, want_y, RTOL, ATOL) <= 1.0
    assert _share_of_the_bound(s, want_s, STATE_RTOL, STATE_ATOL) <= 1.0
    torch.testing.assert_close(y.float(), want_y.float(), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(s, want_s, rtol=STATE_RTOL,
                               atol=STATE_ATOL)


@pytest.mark.parametrize("operand", ["M", "state"])
def test_one_piece_fewer_of_m_or_the_state_breaks_y(operand):
    args = _inputs(0)
    want_y, _ = ssd_scan_ref(*args, CHUNK)
    y, _ = _emulated_kernel(*args, {**KERNEL, operand: KERNEL[operand] - 1})
    assert _share_of_the_bound(y, want_y, RTOL, ATOL) > 10.0
    assert not torch.allclose(y.float(), want_y.float(), rtol=RTOL,
                              atol=ATOL)


def test_one_piece_of_b_decay_breaks_the_state():
    args = _inputs(0)
    _, want_s = ssd_scan_ref(*args, CHUNK)
    _, s = _emulated_kernel(*args, {**KERNEL, "B o decay": 1})
    assert _share_of_the_bound(s, want_s, STATE_RTOL, STATE_ATOL) > 10.0


# a clip at row 60 of the first chunk alone, after which 15 chunks carry
# the state; and one at a row of every chunk, as chip_smoke.py draws it
CLIPS = {"first chunk": 60, "every chunk": slice(37, None, CHUNK)}


@pytest.mark.parametrize("where", list(CLIPS))
def test_the_kernels_split_holds_the_float64_bound_after_a_clip(where):
    args = _inputs(2, clip=CLIPS[where])
    y_share, state_share = _float64_shares(args, KERNEL)
    assert y_share <= 1.0 and state_share <= 1.0, (y_share, state_share)
    want_y, want_s = ssd_scan_ref(*args, CHUNK)
    y, s = _emulated_kernel(*args, KERNEL)
    assert _share_of_the_bound(y, want_y, RTOL, ATOL) <= 1.0
    assert _share_of_the_bound(s, want_s, STATE_RTOL, STATE_ATOL) <= 1.0


def test_two_pieces_of_b_decay_break_the_float64_bound_after_a_clip():
    """After the clip the plain version's state is good to fp32's
    rounding; two pieces of B o decay leave each term's 2^-17 and the
    state drifts past three times the plain version's error."""
    args = _inputs(2, clip=CLIPS["first chunk"])
    _, state_share = _float64_shares(args, {**KERNEL, "B o decay": 2})
    assert state_share > 1.5, state_share
