"""The port's Mamba2 decode halves and the SSD scan from a given state
against the JAX package's: ``ssd_decode_step``, ``conv_decode_step`` (K
4, and K 1, whose state is empty and comes back as it went),
``mamba2_decode``; a chain of decode steps against the chunked scan
(the port's mirror of ``tests/test_kernels.py``'s
``test_ssd_decode_matches_scan_tail``) and of block decodes against the
block's forward; ``ssd_chunked`` and ``ssd_reference`` with
``initial_state`` over several chunks at a ragged L; and ``ssd_chunk``,
the counterpart of the Pallas kernel's single-chunk entry
``ssd_chunk_fused``, with its checks and its CPU route.

Decay draws as in ``tests/test_torch_ssd.py``: ``sweep`` -U(0.01, 0.5),
the JAX tests' draw, and ``slow`` -U(1e-4, 1e-2), under which the
given state still weighs on the last chunk (ROADMAP's convention for a
carried state). Tolerances: SSD's fp32 rtol 1e-4 / atol 1e-5; a whole
block (projections, conv, norm) at rtol 1e-4 / atol 1e-4 as the other
zoo parity tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch.checkpoint.convert import zoo_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.ops import ssd_chunk
from repro_torch.models import ssm

RTOL, ATOL = 1e-4, 1e-5
BLOCK_RTOL, BLOCK_ATOL = 1e-4, 1e-4
DRAWS = ["sweep", "slow"]
NOISE = {"A_log": 0.5, "dt_bias": 0.5, "conv_b": 0.2, "D": 0.2,
         "norm_w": 0.2}


def _draw(B, L, H, P, N, kind, seed=0):
    """numpy xd [B, L, H, P], a [B, L, H], B_, C_ [B, L, N] and a state
    [B, H, P, N] (float32)."""
    rng = np.random.default_rng(seed + B * 1000 + L * 10 + H + P + N)
    f = np.float32
    lo, hi = (0.01, 0.5) if kind == "sweep" else (1e-4, 1e-2)
    return ((0.1 * rng.standard_normal((B, L, H, P))).astype(f),
            (-rng.uniform(lo, hi, (B, L, H))).astype(f),
            (0.3 * rng.standard_normal((B, L, N))).astype(f),
            (0.3 * rng.standard_normal((B, L, N))).astype(f),
            (0.5 * rng.standard_normal((B, H, P, N))).astype(f))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------- SSD decode --

@pytest.mark.parametrize("kind", DRAWS)
def test_ssd_decode_step_matches_jax(kind):
    xd, a, B_, C_, state = _draw(2, 1, 3, 8, 4, kind, seed=1)
    args = (state, xd[:, 0], a[:, 0], B_[:, 0], C_[:, 0])
    want_y, want_s = jssm.ssd_decode_step(*map(jnp.asarray, args))
    y, s = ssm.ssd_decode_step(*_t(*args))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    _close(y, want_y)
    _close(s, want_s)


@pytest.mark.parametrize("kind", DRAWS)
def test_decode_chain_equals_the_scan(kind):
    """L = 32 steps of ``ssd_decode_step`` from zero reproduce the chunked
    scan's y at chunk 8 and its final state."""
    xd, a, B_, C_, _ = _draw(1, 32, 2, 8, 4, kind, seed=2)
    y_scan, s_scan = ssm.ssd_chunked(*_t(xd, a, B_, C_), chunk=8)
    state = torch.zeros((1, 2, 8, 4))
    ys = []
    for t in range(32):
        y, state = ssm.ssd_decode_step(state, *_t(xd[:, t], a[:, t],
                                                  B_[:, t], C_[:, t]))
        ys.append(y)
    _close(torch.stack(ys, 1), y_scan.numpy())
    _close(state, s_scan.numpy())


# ---------------------------------------------------------- conv decode --

@pytest.mark.parametrize("K", [4, 1])
def test_conv_decode_step_matches_jax(K):
    """One step of the depthwise causal conv: y and the shifted state; at
    K 1 the state is [B, 0, C] and comes back unchanged."""
    rng = np.random.default_rng(K)
    f = np.float32
    conv_state = rng.standard_normal((2, K - 1, 6)).astype(f)
    x_t = rng.standard_normal((2, 6)).astype(f)
    w = rng.standard_normal((6, K)).astype(f)
    b = rng.standard_normal(6).astype(f)
    want_y, want_s = jssm.conv_decode_step(*map(jnp.asarray,
                                                (conv_state, x_t, w, b)))
    got_state = _t(conv_state)[0]
    y, s = ssm.conv_decode_step(got_state, *_t(x_t, w, b))
    _close(y, want_y, rtol=1e-5, atol=1e-6)
    assert tuple(s.shape) == (2, K - 1, 6)
    _close(s, want_s, rtol=0, atol=0)
    if K == 1:
        assert s is got_state


def test_conv_decode_chain_equals_the_causal_conv():
    """Steps of ``conv_decode_step`` from a zero state give
    ``causal_conv1d``'s output, step by step."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 10, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    want = ssm.causal_conv1d(x, w, b)
    state = torch.zeros((2, 3, 6))
    for t in range(10):
        y, state = ssm.conv_decode_step(state, x[:, t], w, b)
        torch.testing.assert_close(y, want[:, t], rtol=1e-5, atol=1e-6)


# -------------------------------------------------------- block decode --

def _block_params(seed=0):
    """One reduced Mamba2 layer's params, JAX init plus noise on its
    constant leaves, on both sides."""
    cfg = reduced(get_config("mamba2-370m"))
    jcfg = jreduced(jget_config("mamba2-370m"))
    rng = np.random.default_rng(seed)

    def noise(path, a):
        a = np.asarray(a.astype(jnp.float32))
        name = jax.tree_util.keystr(path).rsplit("'", 2)[-2]
        if name in NOISE:
            a = a + NOISE[name] * rng.standard_normal(a.shape)
        return a.astype(np.float32)

    jp = jax.tree_util.tree_map_with_path(
        noise, jtfm.init_lm(jcfg, jax.random.PRNGKey(seed)))
    port = zoo_params_from_numpy(cfg, jp, "cpu")
    pick = lambda tree: {k: v[0] for k, v in tree["layers"]["ssm"].items()}
    return cfg, pick(port), {k: jnp.asarray(v) for k, v in
                             pick(jp).items()}


def test_mamba2_decode_matches_jax():
    """One token through the whole block from a random conv and SSM
    state: y, the new conv state and the new SSM state."""
    cfg, p, jp = _block_params()
    rng = np.random.default_rng(4)
    f = np.float32
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    x_t = rng.standard_normal((2, cfg.d_model)).astype(f)
    conv = rng.standard_normal((2, cfg.ssm_conv - 1, conv_dim)).astype(f)
    st = (0.3 * rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                                     cfg.ssm_state))).astype(f)
    kw = dict(head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state)
    want = jssm.mamba2_decode(jp, *map(jnp.asarray, (x_t, conv, st)), **kw)
    got = ssm.mamba2_decode(p, *_t(x_t, conv, st), **kw)
    for g, w in zip(got, want):
        _close(g, w, BLOCK_RTOL, BLOCK_ATOL)


def test_mamba2_decode_chain_equals_the_block_forward():
    """Block decodes from zero states, token by token, give
    ``mamba2_apply``'s output over the whole sequence."""
    cfg, p, _ = _block_params(seed=1)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32))
    kw = dict(head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state)
    want = ssm.mamba2_apply(p, x, chunk=cfg.ssm_chunk, **kw)
    conv = torch.zeros((2, cfg.ssm_conv - 1,
                        cfg.d_inner + 2 * cfg.ssm_state))
    st = torch.zeros((2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
    for t in range(20):
        y, conv, st = ssm.mamba2_decode(p, x[:, t], conv, st, **kw)
        torch.testing.assert_close(y, want[:, t], rtol=BLOCK_RTOL,
                                   atol=BLOCK_ATOL)


# ---------------------------------------------- scan from a given state --

@pytest.mark.parametrize("kind", DRAWS)
@pytest.mark.parametrize("L,chunk", [(100, 32), (20, 16), (64, 16)],
                         ids=["ragged-4-chunks", "ragged-2-chunks",
                              "4-chunks"])
def test_ssd_chunked_from_a_state_matches_jax(L, chunk, kind):
    """The port's ``ssd_chunked(initial_state=...)`` (the scan from zero,
    the state folded in after it) against the JAX package's chunked
    scan carrying the state from chunk to chunk and its sequential
    oracle; and the port's oracle from the same state against both."""
    xd, a, B_, C_, state = _draw(2, L, 3, 16, 8, kind, seed=L)
    want_y, want_s = jssm.ssd_chunked(*map(jnp.asarray, (xd, a, B_, C_)),
                                      chunk=chunk,
                                      initial_state=jnp.asarray(state))
    ref_y, ref_s = jssm.ssd_reference(*map(jnp.asarray, (xd, a, B_, C_)),
                                      initial_state=jnp.asarray(state))
    y, s = ssm.ssd_chunked(*_t(xd, a, B_, C_), chunk=chunk,
                           initial_state=_t(state)[0])
    assert y.shape == xd.shape and s.dtype == torch.float32
    seq_y, seq_s = ssm.ssd_reference(*_t(xd, a, B_, C_),
                                     initial_state=_t(state)[0])
    for got_y, got_s in ((y, s), (seq_y, seq_s)):
        for wy, ws in ((want_y, want_s), (ref_y, ref_s)):
            _close(got_y, wy)
            _close(got_s, ws)


def test_the_given_state_weighs_on_the_last_chunk():
    """At the slow decay the state's share of y at the last step is far
    above the tolerance, so a fold that lost it would fail above."""
    xd, a, B_, C_, state = _draw(2, 100, 3, 16, 8, "slow", seed=100)
    with_state, _ = ssm.ssd_chunked(*_t(xd, a, B_, C_), chunk=32,
                                    initial_state=_t(state)[0])
    without, _ = ssm.ssd_chunked(*_t(xd, a, B_, C_), chunk=32)
    gap = float((with_state[:, -1] - without[:, -1]).abs().max())
    assert gap > 100 * (ATOL + RTOL * float(with_state.abs().max()))


# -------------------------------------------------------------- ssd_chunk --

@pytest.mark.parametrize("kind", DRAWS)
@pytest.mark.parametrize("K,P,N", [(32, 16, 8), (128, 64, 128)], ids=str)
def test_ssd_chunk_matches_jax_ssd_chunk_fused(K, P, N, kind):
    """One chunk of one (batch, head) from a given state: the port's
    entry (on the CPU, ``ssd_chunk_ref``) against the TPU kernel's entry
    ``ssd_chunk_fused`` (Pallas, interpret mode on the CPU) and the JAX
    oracle; and the fold the card runs (the scan from zero, then
    ``fold_state``) against the same."""
    from repro.kernels.ssd.ops import ssd_chunk_fused
    from repro.kernels.ssd.ref import ssd_chunk_ref as jchunk_ref
    from repro_torch.kernels.ssd.ref import fold_state, ssd_scan_ref

    xd, a, B_, C_, state = _draw(1, K, 1, P, N, kind, seed=K)
    xd, a, B_, C_, state = xd[0, :, 0], a[0, :, 0], B_[0], C_[0], \
        state[0, 0]
    y, new_state = ssd_chunk(*_t(xd, a, B_, C_, state))
    zy, zs = ssd_scan_ref(*_t(xd[None, :, None], a[None, :, None],
                              B_[None], C_[None]), K)
    fy, fs = fold_state(zy, zs, _t(a)[0][None, :, None], _t(C_)[0][None],
                        _t(state)[0][None, None])
    for want_y, want_s in (ssd_chunk_fused(xd, a, B_, C_, state),
                           jchunk_ref(xd, a, B_, C_, state)):
        for got_y, got_s in ((y, new_state), (fy[0, :, 0], fs[0, 0])):
            _close(got_y, want_y)
            _close(got_s, want_s)


def test_ssd_chunk_cpu_route_runs_the_plain_version(monkeypatch):
    """On CPU tensors ``ssd_chunk`` launches nothing and its dispatch is
    recorded as the op ``ssd_chunk`` on the plain (``torch``) route."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel launched on the CPU route")

    monkeypatch.setattr(ssd_kernel, "ssd_scan_cuda", refuse)
    xd, a, B_, C_, state = _draw(1, 16, 1, 8, 4, "slow", seed=3)
    args = _t(xd[0, :, 0], a[0, :, 0], B_[0], C_[0], state[0, 0])
    before = ssd_kernel.SSD_CHUNK_LAUNCHES.total
    with dispatch.counting() as counts:
        y, s = dispatch.ssd_chunk(*args)
    assert counts["ssd_chunk"] == 1
    assert counts.counts == {("cpu", "ssd_chunk", "torch", (1, 8)): 1}
    assert ssd_kernel.SSD_CHUNK_LAUNCHES.total == before
    assert y.shape == (16, 8) and s.shape == (8, 4)


def test_ssd_chunk_rejects_bad_arguments():
    xd, a, B_, C_, state = _t(*_draw(1, 16, 1, 8, 4, "slow", seed=4))
    xd, a, B_, C_, state = xd[0, :, 0], a[0, :, 0], B_[0], C_[0], \
        state[0, 0]
    with pytest.raises(ValueError, match="ssd_chunk expects"):
        ssd_chunk(xd[None], a, B_, C_, state)
    with pytest.raises(ValueError, match="ssd_chunk: a must be"):
        ssd_chunk(xd, a[:-1], B_, C_, state)
    with pytest.raises(ValueError, match="state must be"):
        ssd_chunk(xd, a, B_, C_, state[:, :2].contiguous())
    with pytest.raises(ValueError, match="state must be"):
        ssd_chunk(xd, a, B_, C_, state.double())
    with pytest.raises(TypeError, match="ssd_chunk takes a in float32"):
        ssd_chunk(xd, a.double(), B_, C_, state)
    with pytest.raises(ValueError, match="contiguous tensors, xd is not"):
        ssd_chunk(xd.t().contiguous().t(), a, B_, C_, state)
