"""Why the bf16 flash kernel pays for two P.V products on the tensor
cores (``kernels/attention/csrc/flash_attention_wgmma.cu``).

A bf16 wgmma takes P in bf16, while the TPU kernel and the plain version
keep P in fp32, and the card holds the kernel against the plain version
at one bf16 step of the output (rtol 1e-2, atol 1e-4). This file
emulates the kernel's numerics in plain torch on the CPU: key tiles of
128, a running max, P = exp(s - m) in fp32, and P.V from P rounded to
bf16, either once (P_hi) or split in two (P_hi + P_lo, P_lo = bf16(P -
P_hi)), each product summed in fp32 as the tensor cores sum it. At the
serving path's long prompt (2048 tokens, head dim 128, causal) the split
stays within the card's bound of ``attention_ref`` and the single
rounding does not."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.attention.ref import NEG_INF, attention_ref

RTOL, ATOL = 1e-2, 1e-4    # the card's bf16 bound, kernel vs plain
BK = 128                   # the kernel's keys per K/V stage


def _bf16_inputs(S, H, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, S, H, D))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]


def _emulated_kernel(q, k, v, split: bool):
    """Causal attention the kernel's way, on bf16 q, k, v: scores in fp32,
    the online softmax over tiles of BK keys, P rounded to bf16 before
    each product with v (and its remainder too when ``split``), the
    output rounded to bf16 once."""
    _, S, H, D = q.shape
    qf, kf, vf = (t[0].float().transpose(0, 1) for t in (q, k, v))  # [H, S, D]
    pos = torch.arange(S)
    m = torch.full((H, S, 1), NEG_INF)
    l = torch.zeros(H, S, 1)
    acc = torch.zeros(H, S, D)
    for k0 in range(0, S, BK):
        s = qf @ kf[:, k0:k0 + BK].transpose(1, 2) * D ** -0.5
        keep = pos[k0:k0 + BK][None, :] <= pos[:, None]
        s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vf[:, k0:k0 + BK]
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + lo @ vf[:, k0:k0 + BK]
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.transpose(0, 1)[None].to(torch.bfloat16)


def _share_of_the_bound(got, want):
    """|got - want| over the bound atol + rtol |want|, elementwise."""
    got, want = got.float(), want.float()
    return (got - want).abs() / (ATOL + RTOL * want.abs())


@pytest.mark.parametrize("heads", [2, 4])
def test_p_split_in_two_bf16_halves_holds_the_card_bound(heads):
    q, k, v = _bf16_inputs(2048, heads, 128, seed=heads)
    want = attention_ref(q, k, v, causal=True)
    got = _emulated_kernel(q, k, v, split=True)
    share = _share_of_the_bound(got, want)
    assert float(share.max()) <= 1.0, float(share.max())
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("heads", [2, 4])
def test_p_rounded_once_to_bf16_breaks_the_card_bound(heads):
    q, k, v = _bf16_inputs(2048, heads, 128, seed=heads)
    want = attention_ref(q, k, v, causal=True)
    got = _emulated_kernel(q, k, v, split=False)
    share = _share_of_the_bound(got, want)
    assert float(share.max()) > 2.0, float(share.max())
    assert int((share > 1.0).sum()) > 1000
    assert not torch.allclose(got.float(), want.float(), rtol=RTOL,
                              atol=ATOL)
