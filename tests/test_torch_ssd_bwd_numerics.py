"""Why the bf16 SSD backward (``kernels/ssd/csrc/ssd_scan_bwd_wgmma.cu``)
splits its fp32 operands into the bf16 pieces it does.

A bf16 wgmma takes its operands in bf16. xd, dy, B_ and C_ come in bf16
and are exact; these fp32 operands must be rounded:

- "update": B o decay and C o exp(cum), the A operands of the states'
  walk (the state entering each chunk, and the cotangent of the state
  leaving it, each carried in fp32 registers from chunk to chunk);
- "state": those two states as the main kernel reads them (the B
  operand of dy S and xd dS), split from the fp32 states the walk
  writes; <S, dS> is summed by the walk in fp32, unsplit;
- "dxd state": dS again, as the B operand of B dS^T, dxd's state term;
- "D": D = (dy xd^T) o Lmat and its transpose (the A operands of D B
  and D^T C);
- "M": (C B^T o Lmat)^T, the A operand of the intra-chunk part of dxd.

This file emulates the kernel's arithmetic in plain torch on the CPU:
chunks of 128, cum summed in double and rounded once, each fp32 operand
split into bf16 pieces (the first the rounding of the value, each next
one the rounding of what the earlier ones leave), each product summed
in fp32, the decays applied in fp32 to the products' sums, the heads'
dB and dC summed in fp32 in head order, da's reverse cumsum in double,
and dxd, dB and dC rounded to bf16 once. (The kernel takes Lmat's exp by
the MUFU unit, good to about 2^-21; here it is torch's.) The card holds
the kernel against the plain version ``ssd_scan_bwd_ref`` within 1e-2
of each gradient's max |grad| (chip_smoke.py SSD_BWD_BF16_REL), and,
after a step clipped mid-chunk, against a float64 run of the plain
version within three times the plain version's own distance from it
plus 1e-6 of max |grad| (SSD_F64_FACTOR). Here the emulation is held to
both at Mamba2-370M's instantiation (head dim 64, state 128) and
Zamba2-2.7B's (state 64), cut to one batch row, two or four heads and a
ragged L of 300, with a final-state cotangent, under a slow decay (where
the states carry from chunk to chunk), a clip at each chunk's last row,
and a clip mid-chunk. The kernel's pieces (``KERNEL``) meet both bounds;
one piece fewer of any of them breaks one of them: no piece of D, of M
or of dS in dxd drops its product; one piece of the states' updates puts
da 25-200x past three times the plain version's float64 error after the
mid-chunk clip at four heads (the card's check saw 316x), and two pieces
of the states 1.3x past it at Zamba2's with two heads (three pieces
0.14x). The gradients' own bf16 rounding takes most of the 1e-2: one
piece of D and of M leaves them at 0.3-0.7 of it, and dS's one piece in
dxd's state term moves nothing there that two pieces would not."""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.ref import ssd_scan_bwd_ref

REL = 1e-2                          # the card's bound, of max |grad|
F64_FACTOR, F64_FLOOR = 3.0, 1e-6   # after a mid-chunk clip, vs float64
CHUNK = 128
SHAPES = {"mamba2": (1, 300, 2, 64, 128), "zamba2": (1, 300, 2, 64, 64),
          "mamba2-h4": (1, 300, 4, 64, 128), "zamba2-h4": (1, 300, 4, 64, 64)}
# the kernel's pieces, and their constants' names in its source
KERNEL = {"update": 2, "state": 3, "dxd state": 1, "D": 1, "M": 1}
SOURCE_NAMES = {"update": "UPDATE_PIECES", "state": "STATE_PIECES",
                "dxd state": "DXD_STATE_PIECES", "D": "D_PIECES",
                "M": "M_PIECES"}
NAMES = ("dxd", "da", "dB", "dC")


def _inputs(shape, kind, seed):
    """bf16 xd, dy [B, L, H, P], B_, C_ [B, L, N]; fp32 a [B, L, H] and
    dstate [B, H, P, N], drawn as tests/test_torch_ssd_bwd.py draws them:
    a slow decay -U(1e-4, 1e-2), clipped (a = -100) at each chunk's last
    row ("clip") or at one random row a chunk ("clip-mid")."""
    B, L, H, P, N = shape
    rng = np.random.default_rng(seed)
    xd = 0.1 * rng.standard_normal((B, L, H, P))
    a = -rng.uniform(1e-4, 1e-2, (B, L, H))
    if kind == "clip":
        a[:, CHUNK - 1::CHUNK] = -100.0
        a[:, L - 1] = -100.0
    if kind == "clip-mid":
        a[:, int(rng.integers(0, CHUNK))::CHUNK] = -100.0
    B_ = 0.3 * rng.standard_normal((B, L, N))
    C_ = 0.3 * rng.standard_normal((B, L, N))
    dy = rng.standard_normal((B, L, H, P))
    dstate = rng.standard_normal((B, H, P, N))
    f = [torch.from_numpy(t.astype(np.float32)) for t in
         (xd, a, B_, C_, dy, dstate)]
    bf = torch.bfloat16
    return f[0].to(bf), f[1], f[2].to(bf), f[3].to(bf), f[4].to(bf), f[5]


def _pieces(x, n):
    """x (fp32) as n bf16 pieces, returned in fp32: their sum is x to
    about 2^(-9 n)."""
    out = []
    for _ in range(n):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def _split_product(spec, x, y, n):
    """einsum(spec, x, y) with x in n bf16 pieces, each product in fp32."""
    out = 0.0
    for piece in _pieces(x, n):
        out = out + torch.einsum(spec, piece, y)
    return out


def _emulated_kernel(xd, a, B_, C_, dy, dstate, pieces):
    """The backward the kernel's way on bf16 xd, dy, B_, C_: the states'
    walk per (batch, head), then each chunk's products per head, with
    ``pieces`` bf16 pieces of each fp32 operand. Returns (dxd, da, dB,
    dC) in the inputs' dtypes."""
    Bsz, L, H, P = xd.shape
    N = B_.shape[-1]
    K = CHUNK
    nc = -(-L // K)
    below = torch.tril(torch.ones(K, K, dtype=torch.bool))
    dxd = torch.empty(Bsz, L, H, P, dtype=torch.bfloat16)
    da = torch.empty(Bsz, L, H)
    dB = torch.empty(Bsz, L, N, dtype=torch.bfloat16)
    dC = torch.empty(Bsz, L, N, dtype=torch.bfloat16)
    for b in range(Bsz):
        chunks = []
        for c in range(nc):
            t0 = c * K
            r = min(K, L - t0)                 # rows past L are zeros
            x, g = torch.zeros(H, K, P), torch.zeros(H, K, P)
            Bk, Ck = torch.zeros(K, N), torch.zeros(K, N)
            x[:, :r] = xd[b, t0:t0 + r].float().transpose(0, 1)
            g[:, :r] = dy[b, t0:t0 + r].float().transpose(0, 1)
            Bk[:r] = B_[b, t0:t0 + r].float()
            Ck[:r] = C_[b, t0:t0 + r].float()
            ad = torch.zeros(H, K, dtype=torch.float64)
            ad[:, :r] = a[b, t0:t0 + r].double().T
            cum = torch.cumsum(ad, 1).float()   # in double, rounded once
            total = cum[:, -1]
            chunks.append(dict(t0=t0, r=r, x=x, g=g, B=Bk, C=Ck, cum=cum,
                               ecum=torch.exp(cum), etot=torch.exp(total),
                               decay=torch.exp(total[:, None] - cum)))
        # the states' walk, each state transposed [H, N, P] in fp32
        S, dS = [None] * nc, [None] * nc
        sdot = [None] * nc
        st = torch.zeros(H, N, P)
        for c, ch in enumerate(chunks):
            S[c] = st
            bd = ch["B"][None] * ch["decay"][..., None]        # [H, K, N]
            st = st * ch["etot"][:, None, None] + _split_product(
                "hkn,hkp->hnp", bd, ch["x"], pieces["update"])
        st = dstate[b].transpose(1, 2).clone()
        for c in reversed(range(nc)):
            ch = chunks[c]
            dS[c] = st
            sdot[c] = (S[c] * st).sum((1, 2))      # in fp32, unsplit
            ce = ch["C"][None] * ch["ecum"][..., None]
            st = st * ch["etot"][:, None, None] + _split_product(
                "hqn,hqp->hnp", ce, ch["g"], pieces["update"])
        # each chunk's products, per head
        for c, ch in enumerate(chunks):
            t0, r, x, g = ch["t0"], ch["r"], ch["x"], ch["g"]
            Bk, Ck, cum = ch["B"], ch["C"], ch["cum"]
            ecum, decay = ch["ecum"], ch["decay"]
            d = cum[:, :, None] - cum[:, None, :]
            lmat = torch.where(below, torch.exp(torch.where(below, d, 0.0)),
                               0.0)                        # [H, q, k]
            sc = Ck @ Bk.T                                  # [q, k]
            D = torch.einsum("hqp,hkp->hqk", g, x) * lmat
            DT = D.transpose(1, 2).contiguous()
            MT = (sc[None] * lmat).transpose(1, 2).contiguous()
            E = D * sc[None]
            dyS = _split_product("hnp,hqp->hqn", S[c], g, pieces["state"])
            xdS = _split_product("hnp,hkp->hkn", dS[c], x, pieces["state"])
            carried = ecum * (dyS * Ck[None]).sum(-1)
            G = decay * (xdS * Bk[None]).sum(-1)
            dC_h = ecum[..., None] * dyS + _split_product(
                "hqk,kn->hqn", D, Bk, pieces["D"])
            dB_h = decay[..., None] * xdS + _split_product(
                "hkq,qn->hkn", DT, Ck, pieces["D"])
            dx = decay[..., None] * _split_product(
                "hnp,kn->hkp", dS[c], Bk, pieces["dxd state"]) \
                + _split_product("hkq,hqp->hkp", MT, g, pieces["M"])
            u = E.sum(2) + carried - E.sum(1) - G           # [H, K]
            run = (G.sum(1) + ch["etot"] * sdot[c]).double()
            rc = torch.flip(torch.cumsum(torch.flip(u.double(), [1]), 1),
                            [1]) + run[:, None]
            acc_B, acc_C = torch.zeros(K, N), torch.zeros(K, N)
            for h in range(H):                              # head order
                acc_B = acc_B + dB_h[h]
                acc_C = acc_C + dC_h[h]
            dxd[b, t0:t0 + r] = dx[:, :r].transpose(0, 1).to(torch.bfloat16)
            da[b, t0:t0 + r] = rc[:, :r].T.float()
            dB[b, t0:t0 + r] = acc_B[:r].to(torch.bfloat16)
            dC[b, t0:t0 + r] = acc_C[:r].to(torch.bfloat16)
    return dxd, da, dB, dC


def _shares(args, pieces, kind):
    """Each gradient's error over the card's bound: against the plain
    version (REL of max |grad|), and for "clip-mid" also against float64
    (F64_FACTOR x the plain version's own distance + F64_FLOOR of max
    |grad|). A share above 1 breaks the bound."""
    got = _emulated_kernel(*args, pieces)
    plain = ssd_scan_bwd_ref(*args[:4], CHUNK, *args[4:])
    shares = {}
    for name, g, p in zip(NAMES, got, plain):
        top = float(p.float().abs().max())
        shares[name] = float((g.float() - p.float()).abs().max()) / (REL
                                                                     * top)
    if kind == "clip-mid":
        exact = ssd_scan_bwd_ref(*(t.double() for t in args[:4]), CHUNK,
                                 args[4].double(), args[5].double())
        for name, g, p, e in zip(NAMES, got, plain, exact):
            kern = float((g.double() - e).abs().max())
            ref = float((p.double() - e).abs().max())
            top = float(e.abs().max())
            shares[name + " f64"] = kern / (F64_FACTOR * ref
                                            + F64_FLOOR * top)
    return shares


CASES = [(arch, kind) for arch in SHAPES for kind in ("slow", "clip",
                                                       "clip-mid")]


@pytest.mark.parametrize("arch,kind", CASES, ids=[f"{a}-{k}" for a, k in
                                                  CASES])
def test_the_kernels_pieces_meet_the_cards_bounds(arch, kind):
    args = _inputs(SHAPES[arch], kind, seed=5)
    shares = _shares(args, KERNEL, kind)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("operand", sorted(KERNEL))
def test_one_piece_fewer_breaks_a_bound(operand):
    """One piece fewer of ``operand`` (none at all where the kernel takes
    one: the product dropped) breaks a bound at one of the two
    instantiations under some draw."""
    fewer = dict(KERNEL, **{operand: KERNEL[operand] - 1})
    worst = 0.0
    for arch in SHAPES:
        for kind in ("clip-mid", "slow"):
            args = _inputs(SHAPES[arch], kind, seed=5)
            worst = max(worst, max(_shares(args, fewer, kind).values()))
            if worst > 1.0:
                return
    assert worst > 1.0, (operand, worst)


def test_the_kernel_source_takes_these_pieces():
    """The CUDA source's piece counts (read from its text: it builds on a
    card only) are the ones emulated here."""
    src = ssd_kernel.BWD_SOURCES[1].read_text()
    consts = dict(re.findall(r"constexpr int (\w+_PIECES) = (\d+);", src))
    assert {k: int(consts[v]) for k, v in SOURCE_NAMES.items()} == KERNEL
