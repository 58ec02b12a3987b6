"""The backward of the port's flash attention.

On the CPU: the backward kernel's plain version, ``attention_bwd_ref``
(P recomputed from the forward's logsumexp, then dV, dP, Delta, dS, dQ,
dK), and autograd of the forward's plain version ``attention_ref``
(what the CPU route differentiates), each against ``jax.grad`` of the
JAX package's ``attention_ref`` on the same numpy-seeded inputs and
cotangent; ``logsumexp_ref`` against float64 numpy. Cases: causal,
windowed (7, and 40 over 96 keys), no mask at Sq < Skv and Sq > Skv;
MHA 4/4, GQA 4/2 and MQA 4/1; head dims 32, 64, 80 and 128. Tolerances
are the JAX kernel tests' fp32 ones, rtol 2e-4 / atol 2e-5 (the same
products summed in another order). The wrapper's refusal of what the
backward kernel does not take is checked here too.

On a card (``cuda``, skipped without one): the backward kernels against
``attention_bwd_ref`` on the same inputs and cotangent, fp32 at 2e-4 /
2e-5 and bf16 within 1e-2 of max |grad| (the gradients are stored in
bf16, one rounding of 2^-9 of an element, after fp32 sums in another
order; the bf16 kernels also round P and dS once, see
``tests/test_torch_flash_bwd_numerics.py``); edges that fall inside the
bf16 kernels' tiles (128 keys or queries a block, 64 a stage): lengths
that are no multiple of 64, a window edge inside a 64-query tile, no
mask at Sq > Skv and Sq < Skv, 64 tokens (one box); GQA groups of 4 and
16 (MQA 16/1) over several key tiles, where a sum over the group that
lost a head would miss by a quarter of the gradient or more; two runs
bitwise equal, and the rows of a B = 1 launch bitwise the B = 8
launch's; the forward's output bitwise the same with and without its
logsumexp. The JAX package is imported inside the parity tests only:
``python -m pytest -q -m cuda tests/test_torch_attention_bwd.py`` runs
on a card without jax."""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import kernel as flash_kernel
from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                               attention_ref, logsumexp_ref)

RTOL, ATOL = 2e-4, 2e-5          # tests/test_kernels.py, fp32
CARD_BF16_REL = 1e-2             # kernel vs plain, bf16, of max |grad|

# (B, Sq, Skv, mask): the masks training launches
MASKS = [(2, 24, 24, dict(causal=True)),
         (2, 24, 24, dict(causal=True, window=7)),
         (1, 96, 96, dict(causal=True, window=40)),
         (2, 13, 40, dict(causal=False)),
         (2, 40, 17, dict(causal=False))]
_MASK_IDS = ["causal", "window7", "window40", "full-Sq<Skv", "full-Sq>Skv"]
HEADS = [(4, 4), (4, 2), (4, 1)]
HEAD_DIMS = [32, 64, 80, 128]


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed=0):
    """q, k, v and a cotangent, float32 numpy."""
    rng = np.random.default_rng(seed + 7 * Sq + 11 * Skv + 13 * Hkv + D)
    f = np.float32
    return (rng.standard_normal((B, Sq, Hq, D)).astype(f),
            rng.standard_normal((B, Skv, Hkv, D)).astype(f),
            rng.standard_normal((B, Skv, Hkv, D)).astype(f),
            rng.standard_normal((B, Sq, Hq, D)).astype(f))


def _jax_grads(q, k, v, dout, mask):
    import jax
    import jax.numpy as jnp
    from repro.kernels.attention.ref import attention_ref as jref

    def f(a, b, c):
        return jnp.sum(jref(a, b, c, **mask) * dout)

    return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))]


def _lse64(q, k, causal, window):
    """Each row's logsumexp in float64, [B, Hq, Sq]."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), Hq // Hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * D ** -0.5
    qp, kp = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= kp <= qp
    if window is not None:
        keep &= kp > qp - window
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"{h[0]}-{h[1]}")
@pytest.mark.parametrize("case", MASKS, ids=_MASK_IDS)
def test_plain_backward_matches_jax_grad(case, heads, D):
    """``attention_bwd_ref`` from the forward's output and logsumexp,
    and autograd of ``attention_ref``, against ``jax.grad``."""
    B, Sq, Skv, mask = case
    q, k, v, dout = _inputs(B, Sq, Skv, *heads, D)
    want = _jax_grads(q, k, v, dout, mask)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = attention_ref(tq, tk, tv, **mask)
    lse = logsumexp_ref(tq, tk, **mask)
    got = attention_bwd_ref(tq, tk, tv, out, tdo, lse, **mask)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    (attention_ref(*leaves, **mask) * tdo).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", MASKS, ids=_MASK_IDS)
def test_logsumexp_matches_float64(case):
    B, Sq, Skv, mask = case
    q, k, _, _ = _inputs(B, Sq, Skv, 4, 2, 64, seed=3)
    got = logsumexp_ref(torch.from_numpy(q), torch.from_numpy(k), **mask)
    assert got.shape == (B, 4, Sq) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), _lse64(q, k, mask["causal"], mask.get("window")),
        rtol=1e-5, atol=1e-5)


def test_bf16_plain_backward_returns_the_inputs_dtype():
    """bf16 in, bf16 out, computed in fp32: each gradient is the fp32
    one rounded once."""
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(
        1, 20, 20, 4, 2, 64, seed=5))
    args = [t.to(torch.bfloat16) for t in (q, k, v)]
    out = attention_ref(*args)
    lse = logsumexp_ref(*args[:2])
    got = attention_bwd_ref(*args, out, dout.to(torch.bfloat16), lse)
    wide = attention_bwd_ref(*(t.float() for t in args), out.float(),
                             dout.to(torch.bfloat16).float(), lse)
    for g, w in zip(got, wide):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


@pytest.mark.parametrize("kwargs", [
    dict(causal=True, q_offset=3),
    dict(causal=True, kv_valid=10),
    dict(causal=False, window=5)], ids=["q_offset", "kv_valid",
                                        "window-without-causal"])
def test_backward_refuses_what_training_never_launches(kwargs):
    """The backward kernel takes training's launches only: q_offset 0,
    every key valid, a window only with the causal mask. The wrapper's
    check raises on anything else before a launch (on the card it runs
    before the autograd Function)."""
    q, k, _, _ = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 4, 2, 32))
    args = dict(causal=True, window=None, q_offset=0, kv_valid=None)
    args.update(kwargs)
    with pytest.raises(ValueError, match="backward kernel takes"):
        flash_ops._check_grad(q, k, args["causal"], args["window"],
                              args["q_offset"], args["kv_valid"])
    for ok in (dict(causal=True, window=None, q_offset=0, kv_valid=None),
               dict(causal=True, window=4, q_offset=0, kv_valid=16),
               dict(causal=False, window=None, q_offset=0, kv_valid=None)):
        flash_ops._check_grad(q, k, ok["causal"], ok["window"],
                              ok["q_offset"], ok["kv_valid"])


# ------------------------------------------------------------ on a card --

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _card_grads(q, k, v, dout, mask):
    """dq, dk, dv through ``flash_attention`` on the card (the autograd
    Function: the forward with its logsumexp, then the backward
    kernel)."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, **mask)
    out.backward(dout)
    return out.detach(), [t.grad for t in leaves]


def _hold(got, want, dtype, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, (what, name)
        if dtype == torch.float32:
            torch.testing.assert_close(g, w.float(), rtol=RTOL, atol=ATOL,
                                       msg=f"{what} {name}")
        else:
            err = float((g.float() - w.float()).abs().max())
            bound = CARD_BF16_REL * float(w.float().abs().max())
            assert err <= bound, (what, name, err, bound)


# (B, Sq, Skv, mask) whose edges fall inside the bf16 kernels' tiles
EDGES = [(2, 200, 200, dict(causal=True)),
         (1, 77, 300, dict(causal=False)),
         (1, 333, 333, dict(causal=True)),
         (2, 190, 190, dict(causal=True, window=50)),
         (1, 300, 130, dict(causal=False)),
         (1, 130, 300, dict(causal=False)),
         (2, 64, 64, dict(causal=True))]
_EDGE_IDS = ["causal-200", "full-77x300", "causal-333", "window50-190",
             "full-300x130", "full-130x300", "causal-64"]


def test_backward_refusal_codes_match_its_entry_point():
    """The backward's refusal codes are the ones its CUDA source returns
    (read from the text: the source builds on a card only): the
    forward's for q, k, v, and one for dout."""
    src = flash_kernel.BWD_SOURCES[1].read_text()
    found = re.search(r"constexpr int kTmaRefusedQ = (-\d+), "
                      r"kTmaRefusedK = (-\d+), kTmaRefusedV = (-\d+),\s+"
                      r"kTmaRefusedDout = (-\d+);", src)
    assert found is not None
    assert dict(zip(map(int, found.groups()), ("q", "k", "v", "dout"))) \
        == flash_kernel.BWD_TMA_REFUSED
    assert {k: v for k, v in flash_kernel.BWD_TMA_REFUSED.items()
            if v != "dout"} == flash_kernel.TMA_REFUSED
    assert all(f"return kTmaRefused{n};" in src
               for n in ("Q", "K", "V", "Dout"))


def test_backward_scratch_pad_matches_its_source():
    """The binding sizes the bf16 backward's scratch (lse and Delta a
    query row, rows padded to whole query blocks) by the padding its CUDA
    source reads them with."""
    src = flash_kernel.BWD_SOURCES[1].read_text()
    found = re.search(r"constexpr int PAD = (\d+);", src)
    assert found is not None
    assert int(found.group(1)) == flash_kernel.BWD_ROW_PAD
    assert f"constexpr int BQ = {flash_kernel.BWD_ROW_PAD};" in src


def test_backward_raises_a_refused_dout_by_name():
    """A dout TMA cannot read raises a ValueError naming it; the
    forward's codes raise as before, a CUDA error a RuntimeError naming
    the backward."""
    q, k, v, dout = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in _inputs(1, 16, 16, 4, 2, 32))
    base = torch.zeros(dout.numel() + 8, dtype=torch.bfloat16)
    shifted = base[1:1 + dout.numel()].view(dout.shape)
    flash_kernel.raise_for(0, q, k, v, dout)
    with pytest.raises(ValueError, match="cannot read dout: .* starts 2 "
                                         "bytes past a 16-byte boundary"):
        flash_kernel.raise_for(-4, q, k, v, shifted, what="backward ")
    with pytest.raises(ValueError, match="cannot read k"):
        flash_kernel.raise_for(-2, q, k, v, dout, what="backward ")
    with pytest.raises(RuntimeError, match="backward kernel launch failed"):
        flash_kernel.raise_for(700, q, k, v, dout, what="backward ")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"{h[0]}-{h[1]}")
@pytest.mark.parametrize("case", MASKS + EDGES, ids=_MASK_IDS + _EDGE_IDS)
def test_cuda_backward_kernel_matches_plain_version(case, heads, D, dtype):
    _card()
    B, Sq, Skv, mask = case
    dt = getattr(torch, dtype)
    q, k, v, dout = (torch.from_numpy(a).cuda().to(dt)
                     for a in _inputs(B, Sq, Skv, *heads, D, seed=21))
    before = flash_kernel.FLASH_BWD_LAUNCHES.total
    out, got = _card_grads(q, k, v, dout, mask)
    torch.cuda.synchronize()
    assert flash_kernel.FLASH_BWD_LAUNCHES.total == before + 1
    f32 = [t.float() for t in (q, k, v, out, dout)]
    lse = logsumexp_ref(f32[0], f32[1], **mask)
    want = attention_bwd_ref(*f32, lse, **mask)
    _hold(got, want, dt, f"{case} {heads} D{D}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    (2, 300, 300, 16, 4, 128, dict(causal=True)),
    (1, 333, 333, 16, 1, 128, dict(causal=True)),
    (2, 190, 190, 16, 1, 64, dict(causal=True, window=50)),
    (1, 300, 130, 16, 4, 80, dict(causal=False))],
    ids=["gqa16-4-300", "mqa16-1-333", "mqa16-1-window50",
         "gqa16-4-full-300x130"])
def test_cuda_backward_sums_a_gqa_group_over_key_tiles(case, dtype):
    """GQA 16/4 and MQA 16/1 over several key tiles (64-key tiles of the
    fp32 dk/dv blocks, 128 of the bf16 ones, a ragged last one), causal,
    windowed or unmasked: every kv head's dk and dv sum its query heads;
    two runs give the same bits."""
    _card()
    B, Sq, Skv, Hq, Hkv, D, mask = case
    dt = getattr(torch, dtype)
    q, k, v, dout = (torch.from_numpy(a).cuda().to(dt)
                     for a in _inputs(B, Sq, Skv, Hq, Hkv, D, seed=22))
    out, got = _card_grads(q, k, v, dout, mask)
    _, again = _card_grads(q, k, v, dout, mask)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    f32 = [t.float() for t in (q, k, v, out, dout)]
    want = attention_bwd_ref(*f32, logsumexp_ref(f32[0], f32[1], **mask),
                             **mask)
    _hold(got, want, dt, f"GQA {Hq}/{Hkv} {Sq} x {Skv} {mask}")


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [dict(causal=True),
                                  dict(causal=True, window=50),
                                  dict(causal=False)],
                         ids=["causal", "window50", "full"])
def test_cuda_bf16_backward_bits_repeat_and_do_not_depend_on_batch(mask):
    """The bf16 kernels' sums run in a fixed order with one writer an
    element: two launches give the same bits, and the rows of a B = 1
    launch are the B = 8 launch's, bit for bit (a ragged 333 tokens,
    GQA 8/2, D 128)."""
    _card()
    q, k, v, dout = (torch.from_numpy(a).cuda().to(torch.bfloat16)
                     for a in _inputs(8, 333, 333, 8, 2, 128, seed=24))
    lse = torch.empty((8, 8, 333), dtype=torch.float32, device="cuda")
    out = flash_kernel.flash_attention_cuda(q, k, v, mask["causal"],
                                            mask.get("window"), 0, 333,
                                            lse=lse)
    args = (mask["causal"], mask.get("window"))
    got = flash_kernel.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                *args)
    again = flash_kernel.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                  *args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i in (0, 5):
        one = flash_kernel.flash_attention_bwd_cuda(
            *(t[i:i + 1].contiguous() for t in (q, k, v, out, dout, lse)),
            *args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b[i:i + 1]) for a, b in zip(one, got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_forward_with_logsumexp_keeps_its_bits(dtype):
    """The training forward (with the logsumexp output) stores the same
    output bits as the serving forward, and a logsumexp within 1e-4 of
    the plain one's."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v, _ = (torch.from_numpy(a).cuda().to(dt)
                  for a in _inputs(2, 300, 300, 8, 2, 128, seed=23))
    plain = flash_kernel.flash_attention_cuda(q, k, v, True, None, 0, 300)
    lse = torch.empty((2, 8, 300), dtype=torch.float32, device="cuda")
    with_lse = flash_kernel.flash_attention_cuda(q, k, v, True, None, 0, 300,
                                                 lse=lse)
    torch.cuda.synchronize()
    assert torch.equal(plain, with_lse)
    torch.testing.assert_close(lse, logsumexp_ref(q.float(), k.float()),
                               rtol=1e-4, atol=1e-4)
