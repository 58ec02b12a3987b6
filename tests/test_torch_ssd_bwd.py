"""The SSD scan's gradient in the port against the JAX package's, on the
CPU, and its hand-written CUDA kernel against the plain version on a
card.

- ``ref.ssd_scan_bwd_ref`` (the gradient written out chunk by chunk)
  against ``jax.grad`` of ``repro.models.ssm.ssd_chunked`` for the
  cotangent sum(y w) + sum(state v) (v = 0 where no final-state
  cotangent is given): fast, slow and clipped decay, a ragged L, chunks
  16 and 32, at rtol 1e-4 / atol 1e-4, as
  ``tests/test_torch_ssd.py::test_cpu_route_differentiates_like_jax``
  holds the CPU route's autograd; in float64 against autograd of
  ``ssd_scan_ref`` in float64 at 1e-10; bf16 inputs give gradients in
  their dtypes.
- ``ops.SSDScanFunction``'s wiring, with the card's route taken on CPU
  tensors and the kernels swapped for their plain versions (in the
  test only): a gradient for each input that asks alone, the final
  state's cotangent passed through (None where the caller dropped the
  state), one backward call a forward; ``ssd_chunk`` and
  ``ssd_chunked(initial_state=...)`` differentiated this way against
  ``jax.grad`` of the JAX package's.
- The binding's refusal codes, constants, scratch and shared-memory
  formula read from the CUDA sources (which build on a card only): the
  fp32 route's ``ssd_scan_bwd.cu`` and the bf16 route's
  ``ssd_scan_bwd_wgmma.cu``.
- ``cuda``-marked: the kernel against the plain version (fp32 at 1e-4
  and bf16 at 1e-2 of each gradient's max |grad|, as the flash backward
  is held) at Mamba2-370M's and Zamba2-2.7B's instantiations (states 128
  and 64), every bf16 chunk, a ragged L, a mid-chunk clip against
  float64; bf16 shapes past the wgmma kernel's raising a ValueError; two
  launches bitwise; the rows of B = 1 launches bitwise the rows of a B =
  8 launch. Run them on a card with ``python -m pytest -q
  -m cuda tests/test_torch_ssd_bwd.py``; the JAX package is imported
  inside the CPU tests only.
"""

import functools
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import (ssd_chunk_ref, ssd_scan_bwd_ref,
                                         ssd_scan_ref)
from repro_torch.models import ssm

JAX_RTOL = JAX_ATOL = 1e-4
CARD_FP32_REL, CARD_BF16_REL = 1e-4, 1e-2
NAMES = ("dxd", "da", "dB", "dC")


def _draw(B, L, H, P, N, kind, chunk, seed=0):
    """numpy xd [B, L, H, P], a [B, L, H], B_, C_ [B, L, N], the
    cotangents dy [B, L, H, P] and dstate [B, H, P, N] (float32); a drawn
    as ``tests/test_torch_ssd.py`` draws it."""
    rng = np.random.default_rng(seed + B * 1000 + L * 10 + H + P + N)
    f = np.float32
    xd = (0.1 * rng.standard_normal((B, L, H, P))).astype(f)
    lo, hi = (0.01, 0.5) if kind == "sweep" else (1e-4, 1e-2)
    a = -rng.uniform(lo, hi, (B, L, H))
    if kind == "clip":                  # each chunk's last row
        a[:, chunk - 1::chunk] = -100.0
        a[:, L - 1] = -100.0
    if kind == "clip-mid":
        a[:, int(rng.integers(0, min(L, 128)))::128] = -100.0
    B_ = (0.3 * rng.standard_normal((B, L, N))).astype(f)
    C_ = (0.3 * rng.standard_normal((B, L, N))).astype(f)
    dy = rng.standard_normal((B, L, H, P)).astype(f)
    dstate = rng.standard_normal((B, H, P, N)).astype(f)
    return xd, a.astype(f), B_, C_, dy, dstate


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# (kind, (B, L, H, P, N, chunk), with a final-state cotangent): two
# shapes, each with a ragged L (40 = 2 x 16 + 8, 72 = 2 x 32 + 8), so
# that JAX compiles the scan and its gradient once a shape
JAX_CASES = [(kind, shape, with_state)
             for shape, first in (((2, 40, 2, 8, 4, 16), True),
                                  ((1, 72, 3, 16, 8, 32), False))
             for i, kind in enumerate(("sweep", "slow", "clip", "clip-mid"))
             for with_state in [(i % 2 == 0) == first]]


@functools.lru_cache(maxsize=None)
def _jax_scan_grad(chunk: int):
    """jax.grad of sum(y w) + sum(state v) over the JAX package's scan,
    jitted once a chunk (and a shape): (xd, a, B_, C_, w, v) -> the
    gradients of xd, a, B_ and C_."""
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked

    def loss(xd, a, B_, C_, w, v):
        y, s = ssd_chunked(xd, a, B_, C_, chunk=chunk)
        return jnp.sum(y * w) + jnp.sum(s * v)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))


@pytest.mark.parametrize("kind,shape,with_state", JAX_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}-"
                              f"{'dstate' if d else 'no-dstate'}"
                              for k, s, d in JAX_CASES])
def test_plain_backward_matches_jax_grad(kind, shape, with_state):
    chunk = shape[-1]
    xd, a, B_, C_, dy, dstate = _draw(*shape[:5], kind, chunk)
    v = dstate if with_state else np.zeros_like(dstate)
    want = _jax_scan_grad(chunk)(xd, a, B_, C_, dy, v)
    got = ssd_scan_bwd_ref(*_t(xd, a, B_, C_), chunk, torch.from_numpy(dy),
                           torch.from_numpy(dstate) if with_state else None)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g.numpy(), w, JAX_RTOL, JAX_ATOL)


@pytest.mark.parametrize("kind", ["sweep", "slow", "clip"])
def test_plain_backward_in_float64_is_autograd(kind):
    """In float64 the written-out gradient is autograd's of the plain
    scan to rounding (a ragged L, a final-state cotangent)."""
    xd, a, B_, C_, dy, dstate = (t.double() for t in _t(
        *_draw(2, 45, 2, 8, 4, kind, 16, seed=1)))
    leaves = [t.clone().requires_grad_() for t in (xd, a, B_, C_)]
    y, s = ssd_scan_ref(*leaves, 16)
    ((y * dy).sum() + (s * dstate).sum()).backward()
    got = ssd_scan_bwd_ref(xd, a, B_, C_, 16, dy, dstate)
    for name, g, t in zip(NAMES, got, leaves):
        assert g.dtype == torch.float64, name
        _close(g.numpy(), t.grad.numpy(), 1e-10, 1e-10)


def test_bf16_inputs_give_gradients_in_their_dtypes():
    """bf16 xd, B_, C_ and dy with float32 a: the work is fp32 on the
    bf16 values, dxd, dB and dC come back in bf16, da in fp32, each
    within one bf16 step of the fp32 run on the same values."""
    xd, a, B_, C_, dy, dstate = _t(*_draw(2, 40, 2, 16, 8, "slow", 16,
                                          seed=2))
    xb, Bb, Cb, gb = (t.to(torch.bfloat16) for t in (xd, B_, C_, dy))
    got = ssd_scan_bwd_ref(xb, a, Bb, Cb, 16, gb, dstate)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    want = ssd_scan_bwd_ref(xb.float(), a, Bb.float(), Cb.float(), 16,
                            gb.float(), dstate)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        _close(g.float().numpy(), w.numpy(), 2 ** -8, 1e-6)


# -------------------------------------- SSDScanFunction, wired on the CPU --

@pytest.fixture
def plain_card(monkeypatch):
    """The card's route on CPU tensors, the kernels swapped for their
    plain versions; yields the list of the backward's calls (its
    dstate argument each)."""
    calls = []

    def bwd(xd, a, B_, C_, chunk, dy, dstate=None):
        calls.append(dstate)
        return ssd_scan_bwd_ref(xd, a, B_, C_, chunk, dy, dstate)

    monkeypatch.setattr(ssd_ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ssd_kernel, "ssd_scan_cuda",
                        lambda xd, a, B_, C_, chunk: ssd_scan_ref(
                            xd, a, B_, C_, chunk))
    monkeypatch.setattr(ssd_kernel, "ssd_scan_bwd_cuda", bwd)
    return calls


def test_function_differentiates_only_what_asks(plain_card):
    """Each input alone asks for a gradient: one backward call a forward,
    the Function's backward returns that input's gradient and None for
    the others, equal to the CPU route's autograd; y alone drops the
    final state, whose cotangent reaches the backward as None."""
    xd, a, B_, C_, dy, dstate = _t(*_draw(1, 40, 2, 8, 4, "slow", 16,
                                          seed=3))
    for leaf in range(4):
        inputs = [t.clone().requires_grad_(i == leaf)
                  for i, t in enumerate((xd, a, B_, C_))]
        y, s = ssd_ops.ssd_scan(*inputs, chunk=16)
        assert type(y.grad_fn).__name__ == "SSDScanFunctionBackward"
        out = y.grad_fn.apply(dy, dstate)
        assert [g is not None for g in out] == [i == leaf for i in range(5)]
        assert len(plain_card) == 1 and plain_card.pop() is dstate
        ((y * dy).sum()).backward()
        assert plain_card.pop() is None and not plain_card
        ref = [t.clone().requires_grad_(i == leaf)
               for i, t in enumerate((xd, a, B_, C_))]
        ((ssd_scan_ref(*ref, 16)[0] * dy).sum()).backward()
        _close(inputs[leaf].grad.numpy(), ref[leaf].grad.numpy(), 1e-5,
               1e-6)


def test_function_passes_the_final_states_cotangent(plain_card):
    """sum(y dy) + sum(state dstate) through the Function: the backward
    takes dstate once, and the gradients are the CPU route's."""
    xd, a, B_, C_, dy, dstate = _t(*_draw(2, 37, 2, 8, 4, "clip", 16,
                                          seed=4))
    leaves = [t.clone().requires_grad_() for t in (xd, a, B_, C_)]
    y, s = ssd_ops.ssd_scan(*leaves, chunk=16)
    ((y * dy).sum() + (s * dstate).sum()).backward()
    assert len(plain_card) == 1 and torch.equal(plain_card[0], dstate)
    ref = [t.clone().requires_grad_() for t in (xd, a, B_, C_)]
    y, s = ssd_scan_ref(*ref, 16)
    ((y * dy).sum() + (s * dstate).sum()).backward()
    for name, g, w in zip(NAMES, leaves, ref):
        _close(g.grad.numpy(), w.grad.numpy(), 1e-5, 1e-6)


def test_function_under_no_grad_records_nothing(plain_card):
    xd, a, B_, C_ = (t.requires_grad_() for t in _t(
        *_draw(1, 20, 2, 8, 4, "sweep", 16)[:4]))
    with torch.no_grad():
        y, s = ssd_ops.ssd_scan(xd, a, B_, C_, chunk=16)
    assert y.grad_fn is None and s.grad_fn is None and not plain_card


@pytest.mark.parametrize("kind", ["sweep", "slow"])
def test_ssd_chunk_through_the_function_matches_jax(plain_card, kind):
    """``ssd_chunk``'s card route (the scan through the Function, then
    ``fold_state``) against ``jax.grad`` of the JAX package's
    ``ssd_chunk_ref``, for every input and the state."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd.ref import ssd_chunk_ref as jchunk_ref

    xd, a, B_, C_, dy, _ = _draw(1, 32, 1, 16, 8, kind, 32, seed=5)
    xd, a, dy = xd[0, :, 0], a[0, :, 0], dy[0, :, 0]
    B_, C_ = B_[0], C_[0]
    rng = np.random.default_rng(6)
    state = (0.5 * rng.standard_normal((16, 8))).astype(np.float32)
    v = rng.standard_normal((16, 8)).astype(np.float32)
    leaves = [t.requires_grad_() for t in _t(xd, a, B_, C_, state)]
    y, s = ssd_ops.ssd_chunk(*leaves)
    ((y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(v)).sum()) \
        .backward()
    assert len(plain_card) == 1

    def loss(*xs):
        y, s = jchunk_ref(*xs)
        return jnp.sum(y * dy) + jnp.sum(s * v)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (xd, a, B_, C_, state)))
    for t, w in zip(leaves, want):
        _close(t.grad.numpy(), w, JAX_RTOL, JAX_ATOL)


def test_ssd_chunked_from_a_state_through_the_function_matches_jax(
        plain_card):
    """``ssd_chunked(initial_state=...)`` on the card's route (the scan
    through the Function, the fold in plain torch) against ``jax.grad``
    of the JAX package's, over a ragged L and for the initial state."""
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked as jchunked

    xd, a, B_, C_, dy, v = _draw(2, 40, 2, 8, 4, "slow", 16, seed=7)
    s0 = (0.5 * np.random.default_rng(8).standard_normal(v.shape)).astype(
        np.float32)
    leaves = [t.requires_grad_() for t in _t(xd, a, B_, C_, s0)]
    y, s = ssm.ssd_chunked(*leaves[:4], chunk=16, initial_state=leaves[4])
    ((y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(v)).sum()) \
        .backward()
    assert len(plain_card) == 1

    def loss(x, a_, b, c, st):
        y, s = jchunked(x, a_, b, c, chunk=16, initial_state=st)
        return jnp.sum(y * dy) + jnp.sum(s * v)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (xd, a, B_, C_, s0)))
    for t, w in zip(leaves, want):
        _close(t.grad.numpy(), w, JAX_RTOL, JAX_ATOL)


def test_function_refuses_what_the_backward_cannot_take(plain_card,
                                                        monkeypatch):
    """A state past the backward's 128, or a shape past its shared
    memory that the forward takes, raises before the forward's launch;
    under no_grad the forward takes them."""
    launched = []
    monkeypatch.setattr(ssd_kernel, "ssd_scan_cuda",
                        lambda *args: launched.append(args))
    xd, a, B_, C_ = _t(*_draw(1, 20, 1, 8, 4, "sweep", 16)[:4])
    wide = torch.zeros(1, 20, 136)
    with pytest.raises(ValueError, match="backward kernel takes states "
                                         "<= 128"):
        ssd_ops.ssd_scan(xd.requires_grad_(), a, wide, wide, chunk=16)
    # head dim 80 at chunk 128 and state 128: the fp32 forward's 230,400
    # bytes fit, the backward's 246,656 do not
    big, state = torch.zeros(1, 20, 1, 80), torch.zeros(1, 20, 128)
    assert ssd_kernel.smem_bytes(128, 80, 128) <= ssd_kernel.SMEM_LIMIT
    with pytest.raises(ValueError, match="at most 232448 bytes"):
        ssd_ops.ssd_scan(big.requires_grad_(), a, state, state, chunk=128)
    assert not launched and not plain_card
    with torch.no_grad():
        ssd_ops.ssd_scan(xd, a, wide, wide, chunk=16)
        ssd_ops.ssd_scan(big, a, state, state, chunk=128)
    assert len(launched) == 2


# ------------------------------------------------ the binding vs its source --

def _source() -> str:
    return ssd_kernel.BWD_SOURCES[0].read_text()


def _wgmma_source() -> str:
    return ssd_kernel.BWD_SOURCES[1].read_text()


def _consts(src: str) -> dict:
    return {k: int(v) for k, v in
            re.findall(r"constexpr (?:int|size_t) (\w+) = (-?\d+);", src)}


def test_refusal_code_and_constants_match_the_source():
    """The binding's refusal codes, the largest state, the blocks of rows,
    the shared-memory limit and the heads a bf16 block walks are the CUDA
    sources' (read from the text: the sources build on a card only); the
    bf16 route refuses with the fp32 route's shape code, and neither
    takes a float atomic."""
    src, wgmma = _source(), _wgmma_source()
    consts = _consts(src)
    assert {consts["kRefusedShape"]: "shape"} == ssd_kernel.BWD_REFUSED
    assert "return kRefusedShape;" in src
    assert consts["MAX_STATE"] == ssd_kernel.BWD_MAX_STATE
    assert consts["ROW_BLOCK"] == ssd_kernel.BWD_ROW_BLOCK
    assert consts["STATE_TILE"] == ssd_kernel.BWD_STATE_TILE
    assert consts["SMEM_LIMIT"] == ssd_kernel.SMEM_LIMIT
    w = _consts(wgmma)
    w.update((k, int(v)) for k, v in re.findall(r"(kTmaRefused\w+) = (-\d+)",
                                                wgmma))
    assert w["kRefusedShape"] == consts["kRefusedShape"]
    assert "return kRefusedShape;" in wgmma
    assert {w[f"kTmaRefused{k}"]: v for k, v in
            (("Xd", "xd"), ("B", "B_"), ("C", "C_"), ("Dy", "dy"))} \
        == ssd_kernel.BWD_TMA_REFUSED
    assert w["HEADS"] == ssd_kernel.BWD_HEADS
    assert "ssd_bwd_wgmma::backward(" in src
    for text in (src, wgmma):
        assert not re.search(r"atomic\w*\(", text)


def test_backward_raises_a_refused_operand_by_name():
    """Each of the bf16 backward's tensor-map refusals raises a
    ValueError naming its operand (dy's too), the forward's codes raise
    as before, and a CUDA error a RuntimeError naming the backward."""
    xd, _, B_, C_, dy, _ = (torch.from_numpy(t) for t in
                            _draw(1, 32, 2, 16, 8, "sweep", 16))
    xd, B_, C_, dy = (t.to(torch.bfloat16) for t in (xd, B_, C_, dy))
    base = torch.zeros(dy.numel() + 8, dtype=torch.bfloat16)
    shifted = base[1:1 + dy.numel()].view(dy.shape)
    ssd_kernel.raise_for(0, xd, B_, C_, 16, dy)
    for rc, name in ssd_kernel.BWD_TMA_REFUSED.items():
        with pytest.raises(ValueError, match=f"backward kernel .* cannot "
                                             f"read {name}:"):
            ssd_kernel.raise_for(rc, xd, B_, C_, 16, dy)
    with pytest.raises(ValueError, match="cannot read dy: .* starts 2 "
                                         "bytes past a 16-byte boundary"):
        ssd_kernel.raise_for(-5, xd, B_, C_, 16, shifted)
    with pytest.raises(ValueError, match="ssd_scan kernel .* cannot read "
                                         "B_:"):
        ssd_kernel.raise_for(-2, xd, B_, C_, 16)
    with pytest.raises(RuntimeError, match="backward kernel launch failed"):
        ssd_kernel.raise_for(700, xd, B_, C_, 16, dy)


def _c_function(src: str, name: str):
    """A size_t function of (K, P, N) from the source, as Python."""
    body = re.search(rf"size_t {name}\(int K, int P, int N\) \{{(.*?)\n\}}",
                     src, re.S).group(1)
    body = body.replace("(size_t)", "").replace("sizeof(float)", "4")
    body = re.sub(r"(\w+) < (\w+) \? (\w+) : (\w+)", r"(\3 if \1 < \2 else \4)",
                  body)
    lines = [ln.strip() for ln in " ".join(body.split("\n")).split(";")
             if ln.strip()]
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}

    def fn(K, P, N):
        env = dict(consts, K=K, P=P, N=N)
        for ln in lines:
            if ln.startswith("const size_t"):
                for part in ln[len("const size_t"):].split(","):
                    key, expr = part.split("=", 1)
                    env[key.strip()] = eval(expr, {}, env)
            else:
                assert ln.startswith("return ")
                return eval(ln[len("return "):], {}, env)
    return fn


@pytest.mark.parametrize("shape", [(128, 64, 128), (128, 64, 64),
                                   (16, 32, 32), (32, 16, 8), (16, 128, 8),
                                   (64, 64, 128)], ids=str)
def test_shared_memory_formula_matches_the_source(shape):
    src = _source()
    states = _c_function(src, "states_smem_bytes")
    chunk = _c_function(src, "chunk_smem_bytes")
    assert ssd_kernel.bwd_smem_bytes(*shape) == max(states(*shape),
                                                    chunk(*shape))


def test_the_training_paths_fit_and_the_scratch_matches_the_source():
    """Mamba2-370M's chunk (K 128, P 64, N 128) and Zamba2's (N 64) fit a
    block's 227 KB; the binding's scratch holds the two states' [B, nc,
    H, P, N], the partials' [B, H, L, N] and the two scores' [B, nc, K,
    K] the source lays out."""
    assert ssd_kernel.bwd_smem_bytes(128, 64, 128) == 226_048
    assert ssd_kernel.bwd_smem_bytes(128, 64, 64) < ssd_kernel.SMEM_LIMIT
    src = _source()
    assert "const long long st = (long long)batch * nc * H * P * N;" in src
    assert "const long long pt = (long long)batch * H * L * N;" in src
    assert "const long long kt = (long long)batch * nc * K * K;" in src
    assert "float* dCpart = dBpart + pt;" in src
    assert "float* sct = sc + kt;" in src
    assert ssd_kernel.bwd_scratch_floats(8, 512, 32, 64, 128, 128) \
        == (2 * 8 * 4 * 32 * 64 * 128 + 2 * 8 * 32 * 512 * 128
            + 2 * 8 * 4 * 128 * 128)


def _scratch_floats(src: str):
    """ssd_scan_bwd_wgmma.cu's ``scratch_floats`` as Python."""
    body = re.search(r"long long scratch_floats\(int batch, int L, int H, "
                     r"int N, int K\) \{(.*?)\n\}", src, re.S).group(1)
    body = " ".join(body.replace("(long long)", "").split())
    body = re.sub(r"(\w+) > (\w+) \? (\w+) : (\w+)",
                  r"(\3 if \1 > \2 else \4)", body)
    consts = _consts(src)

    def fn(batch, L, H, N, K):
        env = dict(consts, batch=batch, L=L, H=H, N=N, K=K)
        for ln in (x.strip() for x in body.split(";") if x.strip()):
            if ln.startswith("const long long"):
                for part in re.split(r",(?![^(]*\))", ln[15:]):
                    key, expr = part.split("=", 1)
                    env[key.strip()] = eval(expr.replace("/", "//"), {}, env)
            else:
                assert ln.startswith("return ")
                return eval(ln[7:].replace("/", "//"), {}, env)
    return fn


@pytest.mark.parametrize("shape", [(8, 512, 32, 64, 128, 128),
                                   (8, 512, 80, 64, 64, 128),
                                   (2, 300, 4, 64, 128, 128),
                                   (1, 100, 1, 32, 16, 32),
                                   (2, 96, 17, 16, 8, 16)], ids=str)
def test_the_bf16_scratch_matches_the_source(shape):
    """The bf16 route's scratch (the two states, the head groups' dB and
    dC, da's terms) is the source's ``scratch_floats`` and carves as the
    source carves it; at the two train launches it is 85,463,040 and
    108,800,000 bytes, under half of the fp32 route's."""
    B, L, H, P, N, K = shape
    src = _wgmma_source()
    want = _scratch_floats(src)(B, L, H, N, K)
    assert ssd_kernel.bwd_scratch_floats(B, L, H, P, N, K, bf16=True) == want
    for line in ("p.dstates = p.states + st;", "p.dBp = p.dstates + st;",
                 "p.dCp = p.dBp + pt;", "p.uq = p.dCp + pt;",
                 "p.esd = p.ug + vt;"):
        assert line in src
    if shape[:2] == (8, 512):
        nbytes = 4 * want
        assert nbytes == {32: 85_463_040, 80: 108_800_000}[H]
        assert 2 * nbytes < 4 * ssd_kernel.bwd_scratch_floats(*shape)


# ------------------------------------------------------------ on a card --

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _cuda(arrays, dtype):
    xd, a, B_, C_, dy, dstate = (torch.from_numpy(t).cuda() for t in arrays)
    return xd.to(dtype), a, B_.to(dtype), C_.to(dtype), dy.to(dtype), dstate


def _hold(got, want, dtype, what):
    rel = CARD_FP32_REL if dtype == torch.float32 else CARD_BF16_REL
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        assert torch.all(torch.isfinite(g)), (what, name)
        err = float((g.float() - w.float()).abs().max())
        top = float(w.float().abs().max())
        assert err <= rel * top, (what, name, err, top)


CARD_SHAPES = ([(2, 300, 4, 64, 128, 128), (2, 300, 4, 64, 64, 128)]
               + [(2, 100, 3, 32, 32, K) for K in ssd_kernel.BF16_CHUNKS]
               + [(1, 100, 2, 16, 8, 32), (1, 70, 2, 5, 3, 24),
                  (2, 40, 1, 128, 16, 16), (8, 512, 32, 64, 128, 128)])


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sweep", "slow", "clip"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_cuda_backward_matches_plain_version(shape, kind, dtype,
                                             with_state):
    """Mamba2-370M's and Zamba2's instantiations (a ragged L of 300 at
    chunk 128), every bf16 chunk, ragged small shapes (odd head dim and
    state, a chunk of 24, head dim 128) and the training path's launch:
    fp32 within 1e-4, bf16 within 1e-2 of max |grad|; the bf16 shapes
    the wgmma kernel does not take (a chunk of 24, head dim 128) raise a
    ValueError before a launch."""
    _card()
    dt = getattr(torch, dtype)
    xd, a, B_, C_, dy, dstate = _cuda(_draw(*shape[:5], kind, shape[-1],
                                            seed=9), dt)
    ds = dstate if with_state else None
    P, N, K = shape[3], shape[4], shape[5]
    if dt == torch.bfloat16 and (K not in ssd_kernel.BF16_CHUNKS
                                 or P > ssd_kernel.BF16_MAX_HEAD_DIM
                                 or N > ssd_kernel.BF16_MAX_STATE):
        with pytest.raises(ValueError, match="refuses"):
            ssd_kernel.ssd_scan_bwd_cuda(xd, a, B_, C_, K, dy, ds)
        return
    got = ssd_kernel.ssd_scan_bwd_cuda(xd, a, B_, C_, shape[-1], dy, ds)
    want = ssd_scan_bwd_ref(xd, a, B_, C_, shape[-1], dy, ds)
    _hold(got, want, dt, (shape, kind, dtype, with_state))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_at_a_mid_chunk_clip_is_as_close_to_float64(dtype):
    """At a clipped step mid-chunk the kernel and the plain version are
    each read against a float64 run of the plain version; the kernel's
    error stays within 3x the plain version's, plus 1e-6 of max |grad|."""
    _card()
    dt = getattr(torch, dtype)
    args = _cuda(_draw(2, 300, 4, 64, 128, "clip-mid", 128, seed=10), dt)
    got = ssd_kernel.ssd_scan_bwd_cuda(*args[:4], 128, *args[4:])
    plain = ssd_scan_bwd_ref(*args[:4], 128, *args[4:])
    exact = ssd_scan_bwd_ref(*(t.double() for t in args[:4]), 128,
                             args[4].double(), args[5].double())
    for name, g, p, e in zip(NAMES, got, plain, exact):
        kern = float((g.double() - e).abs().max())
        ref = float((p.double() - e).abs().max())
        assert kern <= 3.0 * ref + 1e-6 * float(e.abs().max()), (name, kern,
                                                                  ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_bits_repeat_and_do_not_depend_on_batch(dtype):
    """Two launches bitwise equal; the rows of B = 1 launches bitwise the
    rows of a B = 8 launch (dB and dC sum the heads in one order)."""
    _card()
    dt = getattr(torch, dtype)
    args = _cuda(_draw(8, 300, 4, 64, 128, "slow", 128, seed=11), dt)
    got = ssd_kernel.ssd_scan_bwd_cuda(*args[:4], 128, *args[4:])
    again = ssd_kernel.ssd_scan_bwd_cuda(*args[:4], 128, *args[4:])
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    for b in (0, 3, 7):
        one = ssd_kernel.ssd_scan_bwd_cuda(
            *(t[b:b + 1].contiguous() for t in args[:4]), 128,
            *(t[b:b + 1].contiguous() for t in args[4:]))
        assert all(torch.equal(o[0], g[b]) for o, g in zip(one, got))
