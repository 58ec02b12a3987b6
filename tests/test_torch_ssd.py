"""The port's SSD chunk scan against the JAX package's: the plain PyTorch
version (what a CPU tensor runs, through the wrapper) vs
``repro.models.ssm.ssd_chunked``, the sequential oracle
``ssd_reference`` and the Pallas kernel ``ssd_scan_fused`` in interpret
mode, over the JAX kernel tests' sweep (the ragged L = 100 at chunk 32
included) and the reduced Mamba2's L = 20 at chunk 16; one chunk with a
carried state; the wrapper's checks and device route; and, on a card,
the hand-written CUDA kernel vs the plain version.

Three draws of the decay a = dt * A:

- ``sweep``: -U(0.01, 0.5), the JAX tests' draw. exp(cum) falls below
  1e-7 within some 30-60 steps, so a scan that lost the state once it
  had carried it through one chunk would still pass: it cannot stand
  alone.
- ``slow``: -U(1e-4, 1e-2), where the carried state dominates y.
- ``clip``: slow, and the last step of every chunk at dt's clip of 100
  with A = -1 (a = -100). Above the diagonal exp(cum_i - cum_j) then
  overflows to inf, which a 0/1 mask times inf turns into NaN; the
  scan must select instead.
- ``clip-mid``: slow, and one step at the clip at a random row of every
  128, so that the rows after it share |cum| ~ 100. cum_i - cum_j then
  keeps only the digits of |cum| (both packages form it so), and the
  order in which cum is summed moves y by ~2e-5. The two packages sum
  it in the same order on the CPU and agree at 1e-5; on the card the
  kernel and torch.cumsum do not, so there the kernel and the plain
  version are each read against a float64 run of the plain version,
  and the kernel's error must stay within 3x the plain version's.

Tolerances are the JAX kernel tests': rtol 1e-4 / atol 1e-5 in fp32.
On a card the kernel and its plain version both work in fp32 on the
same bf16 inputs and round y once, so in bf16 y differs by at most one
bf16 step (rtol 1e-2, atol 1e-4) and the fp32 state by the fp32 bound.
The JAX package is imported inside the parity tests only, so that the
``cuda`` tests also run on a machine with a card and no jax:
``python -m pytest -q -m cuda tests/test_torch_ssd.py``."""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.kernels.ssd.ref import segsum, ssd_chunk_ref, ssd_scan_ref
from repro_torch.models import ssm

RTOL, ATOL = 1e-4, 1e-5
CARD_BF16_RTOL, CARD_BF16_ATOL = 1e-2, 1e-4

# tests/test_kernels.py's SSD sweep (B, L, H, P, N, chunk), and the
# reduced Mamba2's (head dim 32, state 32, chunk 16) at a ragged L
SHAPES = [(1, 64, 2, 16, 8, 16),
          (2, 96, 3, 16, 8, 32),
          (1, 100, 1, 32, 16, 32),     # ragged: L % chunk != 0
          (2, 128, 4, 64, 32, 128),    # full-size chunk
          (1, 20, 2, 32, 32, 16)]      # reduced Mamba2, ragged
DRAWS = ["sweep", "slow", "clip"]


def _draw(B, L, H, P, N, kind, seed=0, chunk=128):
    """numpy xd [B, L, H, P], a [B, L, H], B_, C_ [B, L, N] (float32)."""
    rng = np.random.default_rng(seed + B * 1000 + L * 10 + H + P + N)
    f = np.float32
    xd = (0.1 * rng.standard_normal((B, L, H, P))).astype(f)
    lo, hi = (0.01, 0.5) if kind == "sweep" else (1e-4, 1e-2)
    a = -rng.uniform(lo, hi, (B, L, H))
    if kind == "clip":                  # each chunk's last row
        a[:, chunk - 1::chunk] = -100.0
        a[:, L - 1] = -100.0
    if kind == "clip-mid":
        offset = int(rng.integers(0, min(L, 128)))
        a[:, offset::128] = -100.0
    B_ = (0.3 * rng.standard_normal((B, L, N))).astype(f)
    C_ = (0.3 * rng.standard_normal((B, L, N))).astype(f)
    return xd, a.astype(f), B_, C_


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("kind", DRAWS + ["clip-mid"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scan_matches_jax(shape, kind):
    """The wrapper on CPU tensors vs the JAX model's chunked scan, its
    sequential oracle and the TPU kernel (Pallas, interpret mode on the
    CPU, as tests/test_kernels.py runs it): y and the final state."""
    from repro.kernels.ssd.ops import ssd_scan_fused
    from repro.models.ssm import ssd_chunked, ssd_reference

    chunk = shape[-1]
    xd, a, B_, C_ = _draw(*shape[:5], kind, chunk=chunk)
    y, state = ssd_scan(*_t(xd, a, B_, C_), chunk=chunk)
    assert y.shape == xd.shape and y.dtype == torch.float32
    assert state.shape == (shape[0], shape[2], shape[3], shape[4])
    assert torch.all(torch.isfinite(y)) and torch.all(torch.isfinite(state))
    for want_y, want_s in (ssd_chunked(xd, a, B_, C_, chunk=chunk),
                           ssd_reference(xd, a, B_, C_),
                           ssd_scan_fused(xd, a, B_, C_, chunk=chunk)):
        _close(y.numpy(), want_y)
        _close(state.numpy(), want_s)


@pytest.mark.parametrize("kind", DRAWS)
def test_port_oracle_matches_jax_oracle_and_the_scan(kind):
    """The port's sequential oracle (tests only) against the JAX one, and
    the port's routed ``ssd_chunked`` against both: the final state held
    against the step-by-step recurrence, not only the chunked form."""
    from repro.models.ssm import ssd_reference as jreference

    xd, a, B_, C_ = _draw(1, 100, 2, 16, 8, kind, seed=1, chunk=32)
    y_seq, s_seq = ssm.ssd_reference(*_t(xd, a, B_, C_))
    want_y, want_s = jreference(xd, a, B_, C_)
    _close(y_seq.numpy(), want_y)
    _close(s_seq.numpy(), want_s)
    y, s = ssm.ssd_chunked(*_t(xd, a, B_, C_), chunk=32)
    _close(y.numpy(), y_seq.numpy())
    _close(s.numpy(), s_seq.numpy())


@pytest.mark.parametrize("kind", DRAWS)
def test_one_chunk_with_a_state_matches_jax(kind):
    """``ssd_chunk_ref`` (one chunk, one (batch, head), a given state) vs
    the JAX oracle and the Pallas kernel's single-chunk entry."""
    from repro.kernels.ssd.ops import ssd_chunk_fused
    from repro.kernels.ssd.ref import ssd_chunk_ref as jchunk_ref

    xd, a, B_, C_ = (t[0, :, 0] if t.ndim == 4 else t[0]
                     for t in _draw(1, 32, 1, 16, 8, kind, seed=2,
                                    chunk=32))
    a = a[:, 0]
    state = (0.5 * np.random.default_rng(3).standard_normal(
        (16, 8))).astype(np.float32)
    y, new_state = ssd_chunk_ref(*_t(xd, a, B_, C_, state))
    for want_y, want_s in (jchunk_ref(xd, a, B_, C_, state),
                           ssd_chunk_fused(xd, a, B_, C_, state)):
        _close(y.numpy(), want_y)
        _close(new_state.numpy(), want_s)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_float64_plain_version_is_the_recurrence(shape):
    """The float64 run of the plain version, which the card's mid-chunk
    clip check reads both fp32 versions against, is the step-by-step
    recurrence in float64, and the fp32 run differs from it by no more
    than the fp32 bound."""
    chunk = shape[-1]
    arrays = _draw(*shape[:5], "clip-mid", seed=4, chunk=chunk)
    y, s = ssd_scan_ref(*(t.double() for t in _t(*arrays)), chunk)
    assert y.dtype == s.dtype == torch.float64
    y_seq, s_seq = ssm.ssd_reference(*(t.double() for t in _t(*arrays)))
    assert y_seq.dtype == s_seq.dtype == torch.float64
    _close(y.numpy(), y_seq.numpy(), rtol=1e-9, atol=1e-12)
    _close(s.numpy(), s_seq.numpy(), rtol=1e-9, atol=1e-12)
    y32, s32 = ssd_scan_ref(*_t(*arrays), chunk)
    _close(y32.double().numpy(), y.numpy())
    _close(s32.double().numpy(), s.numpy())


def test_segsum_matches_jax():
    from repro.models.ssm import segsum as jsegsum

    a = -np.random.default_rng(4).uniform(0.01, 0.5, (2, 3, 17)).astype(
        np.float32)
    got = segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(jsegsum(a))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], atol=1e-6)
    assert ssm.segsum is segsum


def test_slow_decay_draw_exposes_a_forgotten_state():
    """Why the slow draw is there. At the path's chunk of 128, a scan
    that forms each chunk's new state from that chunk alone (the state
    it carried in, decayed by exp(cum[-1]), forgotten) stays within the
    tolerance of the right answer at the sweep's fast decay, since
    exp(cum[-1]) is about e^-32 there, and is far outside it at the slow
    one. (A scan that drops the carried state altogether shows even at
    the sweep's decay, in the first rows of the next chunk.)"""
    def forgetful(xd, a, B_, C_, chunk):
        Bsz, L, H, P = xd.shape
        y = torch.empty_like(xd)
        state = torch.empty((Bsz, H, P, B_.shape[-1]))
        for b in range(Bsz):
            for h in range(H):
                carried = torch.zeros(P, B_.shape[-1])
                for i in range(0, L, chunk):
                    part = (xd[b, i:i + chunk, h], a[b, i:i + chunk, h],
                            B_[b, i:i + chunk], C_[b, i:i + chunk])
                    y[b, i:i + chunk, h] = ssd_chunk_ref(*part, carried)[0]
                    carried = ssd_chunk_ref(*part, torch.zeros_like(
                        carried))[1]
                state[b, h] = carried
        return y, state

    for kind, hidden in (("sweep", True), ("slow", False)):
        xd, a, B_, C_ = _t(*_draw(1, 384, 2, 16, 8, kind, seed=5))
        right = ssd_scan(xd, a, B_, C_, chunk=128)
        wrong = forgetful(xd, a, B_, C_, 128)
        for w, r in zip(wrong, right):
            assert torch.allclose(w, r, rtol=RTOL, atol=ATOL) == hidden
    assert float((wrong[0] - right[0]).abs().max()) > 100 * ATOL


@pytest.mark.parametrize("L,chunk", [(100, 32), (20, 16), (1, 16)])
def test_ragged_last_chunk_equals_the_padded_scan(L, chunk):
    """Rows past L act as the reference's padding (a = 0, xd = B_ = C_ =
    0): y is the padded scan's first L rows and the final state the
    padded scan's."""
    xd, a, B_, C_ = _t(*_draw(2, L, 3, 16, 8, "slow", seed=6))
    pad = (-L) % chunk
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (xd, a, B_, C_)]
    y, s = ssd_scan(xd, a, B_, C_, chunk=chunk)
    yp, sp = ssd_scan(*padded, chunk=chunk)
    assert torch.equal(y, yp[:, :L]) and torch.equal(s, sp)


def test_bf16_matches_jax():
    """bf16 xd, B_, C_ with float32 a: both sides work in fp32 and cast y
    to bf16 chunk by chunk; the state stays fp32."""
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked

    xd, a, B_, C_ = _draw(2, 96, 3, 16, 8, "slow", seed=7)
    jx, jb, jc = (jnp.asarray(t, jnp.bfloat16) for t in (xd, B_, C_))
    want_y, want_s = ssd_chunked(jx, jnp.asarray(a), jb, jc, chunk=32)
    tx, tb, tc = (t.to(torch.bfloat16) for t in _t(xd, B_, C_))
    y, s = ssd_scan(tx, torch.from_numpy(a), tb, tc, chunk=32)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    _close(y.float().numpy(), np.asarray(want_y.astype(jnp.float32)),
           rtol=CARD_BF16_RTOL, atol=CARD_BF16_ATOL)
    _close(s.numpy(), want_s)


def test_cpu_route_differentiates_like_jax():
    """The plain route carries gradients, autograd's of the plain scan:
    d(sum of y * w + sum of state * v) against jax.grad of the JAX
    model's scan, for every input."""
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked

    xd, a, B_, C_ = _draw(1, 40, 2, 8, 4, "slow", seed=8)
    rng = np.random.default_rng(9)
    w = rng.standard_normal(xd.shape).astype(np.float32)
    v = rng.standard_normal((1, 2, 8, 4)).astype(np.float32)
    args = [t.requires_grad_() for t in _t(xd, a, B_, C_)]
    y, s = ssd_scan(*args, chunk=16)
    ((y * torch.from_numpy(w)).sum() + (s * torch.from_numpy(v)).sum()) \
        .backward()

    def loss(*xs):
        y, s = ssd_chunked(*xs, chunk=16)
        return jnp.sum(y * w) + jnp.sum(s * v)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (xd, a, B_, C_)))
    for t, g in zip(args, want):
        _close(t.grad.numpy(), g, rtol=1e-4, atol=1e-4)


def test_cpu_route_runs_the_plain_version_and_launches_nothing(monkeypatch):
    xd, a, B_, C_ = _t(*_draw(1, 20, 2, 8, 4, "sweep"))
    calls = []
    monkeypatch.setattr(ssd_kernel, "ssd_scan_cuda",
                        lambda *args, **kw: calls.append(args))
    before = ssd_kernel.SSD_LAUNCHES.total
    y, s = dispatch.ssd_scan(xd, a, B_, C_, chunk=16)
    assert not calls and ssd_kernel.SSD_LAUNCHES.total == before
    want_y, want_s = ssd_scan_ref(xd, a, B_, C_, 16)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    assert dispatch.impl_for(xd.device) == "torch"


def test_wrapper_rejects_bad_arguments():
    xd, a, B_, C_ = _t(*_draw(1, 20, 2, 8, 4, "sweep"))
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        ssd_scan(xd.double(), a, B_.double(), C_.double(), chunk=16)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        ssd_scan(xd, a, B_.to(torch.bfloat16), C_, chunk=16)
    with pytest.raises(TypeError, match="a in float32"):
        ssd_scan(xd, a.to(torch.bfloat16), B_, C_, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(xd.transpose(2, 3).contiguous().transpose(2, 3), a, B_, C_,
                 chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(xd, a, B_, torch.cat([C_, C_], -1)[..., ::2], chunk=16)
    with pytest.raises(ValueError, match=r"a must be \[B, L, H\]"):
        ssd_scan(xd, a[:, :, :1], B_, C_, chunk=16)
    with pytest.raises(ValueError, match=r"xd \[B, L, H, P\]"):
        ssd_scan(xd[0], a, B_, C_, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(xd, a, B_, C_, chunk=0)
    with pytest.raises(ValueError, match="one device"):
        ssd_scan(xd, a, B_.to("meta"), C_, chunk=16)


def test_shared_memory_formula_bounds_the_path_and_refuses_past_it():
    """Mamba2-370M's chunk (K 128, P 64, N 128) fits a block's 227 KB
    and Zamba2's (N 64) too; a chunk of 256 does not."""
    assert ssd_kernel.smem_bytes(128, 64, 128) == 214_016
    assert ssd_kernel.smem_bytes(128, 64, 64) < ssd_kernel.SMEM_LIMIT
    assert ssd_kernel.smem_bytes(256, 64, 128) > ssd_kernel.SMEM_LIMIT


def test_tma_refusal_raises_a_value_error_naming_the_operand():
    """The CUDA driver holds TMA's 16-byte rules when the entry point
    encodes a bf16 operand's tensor map; the entry point then returns that
    operand's refusal code, which the binding raises as a ValueError
    naming the operand and its layout. Held here on CPU tensors of the
    layouts the card refuses: a view one element past a 16-byte boundary,
    and a state of 12 (24-byte rows). 0 raises nothing, a CUDA error a
    RuntimeError."""
    xd, _, B_, C_ = (t.to(torch.bfloat16) if t.dim() != 3 or i != 1 else t
                     for i, t in enumerate(_t(*_draw(1, 20, 2, 16, 8,
                                                      "slow"))))
    base = torch.zeros(xd.numel() + 8, dtype=torch.bfloat16)
    shifted = base[1:1 + xd.numel()].view(xd.shape)
    narrow = torch.zeros(1, 20, 12, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    ssd_kernel.raise_for(0, xd, B_, C_, 16)
    with pytest.raises(ValueError, match="cannot read xd: .* starts 2 bytes "
                                         "past a 16-byte boundary"):
        ssd_kernel.raise_for(-1, shifted, B_, C_, 16)
    with pytest.raises(ValueError, match=r"cannot read B_: .* strides are "
                                         r"\[480, 24\] bytes"):
        ssd_kernel.raise_for(-2, xd, narrow, C_, 16)
    with pytest.raises(ValueError, match="cannot read C_"):
        ssd_kernel.raise_for(-3, xd, B_, narrow, 16)
    with pytest.raises(RuntimeError, match="chunk=16 torch.bfloat16: "
                                           "cudaError 1$"):
        ssd_kernel.raise_for(1, xd, B_, C_, 16)


def test_tma_refusal_codes_match_the_entry_point():
    """The binding's refusal codes are the ones the CUDA source returns
    (its constants, read from the text: the source builds on a card
    only), and the entry point routes bf16 to that source's kernel."""
    entry, wgmma = (p.read_text() for p in ssd_kernel.SOURCES)
    found = re.search(r"constexpr int kTmaRefusedXd = (-\d+), "
                      r"kTmaRefusedB = (-\d+), kTmaRefusedC = (-\d+);",
                      wgmma)
    assert found is not None
    assert dict(zip(map(int, found.groups()), ("xd", "B_", "C_"))) \
        == ssd_kernel.TMA_REFUSED
    assert all(f"return kTmaRefused{n};" in wgmma for n in ("Xd", "B", "C"))
    assert "ssd_wgmma::forward(" in entry
    assert "launch<__nv_bfloat16>" not in entry


# ------------------------------------------------------------ on a card --

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _cuda(arrays, dtype):
    xd, a, B_, C_ = (torch.from_numpy(t).cuda() for t in arrays)
    return xd.to(dtype), a, B_.to(dtype), C_.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", DRAWS)
@pytest.mark.parametrize("shape", SHAPES + [(8, 32, 32, 64, 128, 128),
                                            (4, 2048, 32, 64, 128, 128)],
                         ids=str)
def test_cuda_kernel_matches_plain_version(shape, kind, dtype):
    """Every sweep shape and the serving path's two (8 x 32 and 4 x 2048
    tokens of Mamba2-370M) against the plain version on the card."""
    _card()
    dt = getattr(torch, dtype)
    args = _cuda(_draw(*shape[:5], kind, seed=10, chunk=shape[-1]), dt)
    before = ssd_kernel.SSD_LAUNCHES.total
    y, s = ssd_scan(*args, chunk=shape[-1])
    torch.cuda.synchronize()
    assert ssd_kernel.SSD_LAUNCHES.total == before + 1
    assert y.dtype == dt and y.shape == args[0].shape
    want_y, want_s = ssd_scan_ref(*args, shape[-1])
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float32" \
        else dict(rtol=CARD_BF16_RTOL, atol=CARD_BF16_ATOL)
    assert torch.all(torch.isfinite(y.float()))
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(s, want_s, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + [(8, 32, 32, 64, 128, 128),
                                            (4, 2048, 32, 64, 128, 128)],
                         ids=str)
def test_cuda_kernel_at_a_mid_chunk_clip_is_as_close_to_float64(shape,
                                                                 dtype):
    """At a clipped step mid-chunk the kernel and the plain version are
    each read against a float64 run of the plain version on the same
    inputs; the kernel's error stays within 3x the plain version's (plus
    1e-7, one rounding of a case the plain version gets exactly)."""
    _card()
    args = _cuda(_draw(*shape[:5], "clip-mid", seed=14, chunk=shape[-1]),
                 getattr(torch, dtype))
    got = ssd_scan(*args, chunk=shape[-1])
    plain = ssd_scan_ref(*args, shape[-1])
    exact = ssd_scan_ref(*(t.double() for t in args), shape[-1])
    for g, p, e in zip(got, plain, exact):
        assert torch.all(torch.isfinite(g))
        kern = float((g.double() - e).abs().max())
        ref = float((p.double() - e).abs().max())
        assert kern <= 3.0 * ref + 1e-7, (kern, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [32, 160])
def test_cuda_kernel_rows_do_not_depend_on_batch(L):
    """One ragged chunk, and two chunks: the rows of a B = 8 launch are
    bit for bit the B = 1 launches'."""
    _card()
    args = _cuda(_draw(8, L, 32, 64, 128, "slow", seed=11), torch.bfloat16)
    y, s = ssd_scan(*args, chunk=128)
    for b in range(8):
        one_y, one_s = ssd_scan(*(t[b:b + 1] for t in args), chunk=128)
        assert torch.equal(one_y[0], y[b]) and torch.equal(one_s[0], s[b])


@pytest.mark.cuda
def test_cuda_ssm_family_trains():
    """The reduced Mamba2-370M's loss and gradients on the card in fp32:
    one forward and one backward launch of the SSD kernels a layer (remat
    off), every gradient leaf finite and, with the same weights, within
    1e-4 of its max of the CPU's (the plain versions)."""
    _card()
    import dataclasses

    from repro_torch.checkpoint.convert import params_to
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.launch.specs import loss_and_grad
    from repro_torch.models.transformer import init_lm
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(reduced(get_config("mamba2-370m")),
                              remat=False)
    params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    ssd_kernel.SSD_LAUNCHES.reset()
    ssd_kernel.SSD_BWD_LAUNCHES.reset()
    loss, grads = loss_and_grad(cfg, params, toks.cuda())
    torch.cuda.synchronize()
    assert ssd_kernel.SSD_LAUNCHES.total == cfg.n_layers
    assert ssd_kernel.SSD_BWD_LAUNCHES.total == cfg.n_layers
    want_loss, want = loss_and_grad(cfg, params_to(params, "cpu"), toks)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-4)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert torch.all(torch.isfinite(g))
        top = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * max(top, 1e-30)


@pytest.mark.cuda
def test_cuda_wrapper_differentiates():
    """On the card a gradient goes through ``SSDScanFunction``: one
    forward and one backward launch for each input that asks, the
    gradient of that input alone, matching the CPU route's; under
    no_grad the kernel alone, and nothing records."""
    _card()
    args = _cuda(_draw(1, 20, 2, 8, 4, "slow", seed=12), torch.float32)
    cpu = [t.cpu() for t in args]
    for leaf in range(4):
        inputs, ref_in = list(args), list(cpu)
        inputs[leaf] = inputs[leaf].clone().requires_grad_()
        ref_in[leaf] = ref_in[leaf].clone().requires_grad_()
        before = (ssd_kernel.SSD_LAUNCHES.total,
                  ssd_kernel.SSD_BWD_LAUNCHES.total)
        y, s = ssd_scan(*inputs, chunk=16)
        (y.sum() + s.sum()).backward()
        assert (ssd_kernel.SSD_LAUNCHES.total,
                ssd_kernel.SSD_BWD_LAUNCHES.total) == (before[0] + 1,
                                                       before[1] + 1)
        ry, rs = ssd_scan(*ref_in, chunk=16)
        (ry.sum() + rs.sum()).backward()
        assert all(t.grad is None for i, t in enumerate(inputs) if i != leaf)
        _close(inputs[leaf].grad.cpu().numpy(), ref_in[leaf].grad.numpy(),
               rtol=1e-4, atol=1e-5)
    before = ssd_kernel.SSD_BWD_LAUNCHES.total
    with torch.no_grad():
        y, _ = ssd_scan(args[0].clone().requires_grad_(), *args[1:],
                        chunk=16)
    assert not y.requires_grad
    assert ssd_kernel.SSD_BWD_LAUNCHES.total == before


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back():
    _card()
    xd, a, B_, C_ = _cuda(_draw(1, 20, 2, 64, 128, "sweep", seed=13),
                          torch.float32)
    before = ssd_kernel.SSD_LAUNCHES.total
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        ssd_scan(xd.half(), a, B_.half(), C_.half(), chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(xd.transpose(2, 3).contiguous().transpose(2, 3), a, B_, C_,
                 chunk=16)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan(xd, a, B_, C_, chunk=256)
    assert ssd_kernel.SSD_LAUNCHES.total == before


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 20, 100, 2047])
@pytest.mark.parametrize("P", [16, 32, 64])
@pytest.mark.parametrize("N", [8, 32, 128])
@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_cuda_bf16_kernel_at_tile_edges(chunk, N, P, L):
    """The tensor-core kernel where its tiles are padded: chunks of 16
    and 32 (C's tile padded to 64 rows) and 128 (two consumers), states
    of 8 (a 16-column product over TMA's zeros), 32 and 128 (two slabs),
    head dims of 16 and 32 (64-column products, padded columns never
    stored) and 64, and ragged L (one row; a ragged chunk at every chunk
    size; 2047, one short of 2048). At the three decays against the
    plain version at the card's bf16 bounds; at a mid-chunk clip against
    float64, within 3x the plain version's error."""
    _card()
    before = ssd_kernel.SSD_LAUNCHES.total
    for n, kind in enumerate(DRAWS):
        args = _cuda(_draw(2, L, 2, P, N, kind, seed=20 + n, chunk=chunk),
                     torch.bfloat16)
        y, s = ssd_scan(*args, chunk=chunk)
        want_y, want_s = ssd_scan_ref(*args, chunk)
        assert torch.all(torch.isfinite(y.float()))
        torch.testing.assert_close(y.float(), want_y.float(),
                                   rtol=CARD_BF16_RTOL, atol=CARD_BF16_ATOL)
        torch.testing.assert_close(s, want_s, rtol=RTOL, atol=ATOL)
    args = _cuda(_draw(2, L, 2, P, N, "clip-mid", seed=23, chunk=chunk),
                 torch.bfloat16)
    got = ssd_scan(*args, chunk=chunk)
    plain = ssd_scan_ref(*args, chunk)
    exact = ssd_scan_ref(*(t.double() for t in args), chunk)
    for g, p, e in zip(got, plain, exact):
        assert torch.all(torch.isfinite(g.float()))
        kern = float((g.double() - e).abs().max())
        ref = float((p.double() - e).abs().max())
        assert kern <= 3.0 * ref + 1e-7, (kern, ref)
    assert ssd_kernel.SSD_LAUNCHES.total == before + len(DRAWS) + 1


@pytest.mark.cuda
def test_cuda_bf16_kernel_refuses_what_tma_cannot_read():
    """The CUDA driver refuses a tensor map over a tensor that is not
    16-byte aligned, or whose rows are not 16-byte multiples; the binding
    raises a ValueError naming the operand, and nothing is launched."""
    _card()
    xd, a, B_, C_ = _cuda(_draw(1, 20, 2, 16, 8, "slow", seed=15),
                          torch.bfloat16)
    before = ssd_kernel.SSD_LAUNCHES.total

    def shifted(t):
        base = torch.zeros(t.numel() + 8, dtype=t.dtype, device=t.device)
        view = base[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    with pytest.raises(ValueError, match="cannot read xd"):
        ssd_scan(shifted(xd), a, B_, C_, chunk=16)
    with pytest.raises(ValueError, match="cannot read C_"):
        ssd_scan(xd, a, B_, shifted(C_), chunk=16)
    wide = _cuda(_draw(1, 20, 2, 16, 12, "slow", seed=15), torch.bfloat16)
    with pytest.raises(ValueError, match="cannot read B_"):
        ssd_scan(*wide, chunk=16)      # a state of 12: 24-byte rows
    assert ssd_kernel.SSD_LAUNCHES.total == before


@pytest.mark.cuda
def test_cuda_bf16_kernel_refuses_shapes_it_cannot_take():
    """No shape falls back to the CUDA-core kernel: a chunk the kernel
    is not built for, a head dim past 64 or a state past 128 raises."""
    _card()
    before = ssd_kernel.SSD_LAUNCHES.total
    for B, L, H, P, N, chunk in [(1, 20, 2, 16, 8, 48), (1, 20, 2, 16, 8, 256),
                                 (1, 20, 2, 128, 8, 16),
                                 (1, 20, 2, 16, 136, 16)]:
        args = _cuda(_draw(B, L, H, P, N, "slow", seed=16), torch.bfloat16)
        with pytest.raises(ValueError, match="bf16 kernel takes"):
            ssd_scan(*args, chunk=chunk)
    assert ssd_kernel.SSD_LAUNCHES.total == before


@pytest.mark.cuda
def test_cuda_dtype_picks_the_kernel():
    """bf16 runs the tensor-core kernel and fp32 the CUDA-core one, by
    the device kernels' names in a profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _card()
    arrays = _draw(2, 100, 2, 32, 32, "slow", seed=17, chunk=32)
    for dtype, ran, not_ran in ((torch.bfloat16, "ssd_chunk_wgmma",
                                 "ssd_kernel"),
                                (torch.float32, "ssd_kernel",
                                 "ssd_chunk_wgmma")):
        args = _cuda(arrays, dtype)
        ssd_scan(*args, chunk=32)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ssd_scan(*args, chunk=32)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
        assert any(ran in n for n in names), names
        assert not any(not_ran in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sweep", "slow"])
@pytest.mark.parametrize("K,P,N", [(32, 16, 8), (128, 64, 128)], ids=str)
def test_cuda_ssd_chunk_matches_plain_version(K, P, N, kind):
    """``ssd_chunk`` (one chunk of one (batch, head) from a given state:
    the scan kernel at chunk K from zero, the state folded in after it)
    against its plain version, ``ssd_chunk_ref``, on the card in fp32;
    one launch, counted under the entry's own counter too."""
    from repro_torch.kernels.ssd.ops import ssd_chunk

    _card()
    xd, a, B_, C_ = _draw(1, K, 1, P, N, kind, seed=15, chunk=K)
    xd, a, B_, C_ = (torch.from_numpy(np.ascontiguousarray(t)).cuda()
                     for t in (xd[0, :, 0], a[0, :, 0], B_[0], C_[0]))
    state = (0.5 * torch.randn(P, N, generator=torch.Generator().manual_seed(
        K + P + N))).cuda()
    before = (ssd_kernel.SSD_LAUNCHES.total,
              ssd_kernel.SSD_CHUNK_LAUNCHES.total)
    y, new_state = ssd_chunk(xd, a, B_, C_, state)
    torch.cuda.synchronize()
    assert (ssd_kernel.SSD_LAUNCHES.total,
            ssd_kernel.SSD_CHUNK_LAUNCHES.total) == (before[0] + 1,
                                                     before[1] + 1)
    want_y, want_s = ssd_chunk_ref(xd, a, B_, C_, state)
    torch.testing.assert_close(y, want_y, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(new_state, want_s, rtol=RTOL, atol=ATOL)
