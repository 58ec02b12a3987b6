"""The port's Mamba2 (the zoo's ``ssm`` family) against the JAX
package's, on the reduced Mamba2-370M (2 layers, d_model 256, 16 SSD
heads of 32, state 32, chunk 16) with the same weights on both sides:
the config, ``causal_conv1d``, ``mamba2_apply``, ``init_lm``'s param
tree, ``lm_forward``, ``ZooForecaster.predict`` on right-padded windows,
the weight converter's dtypes, and the serve CLI on the CPU.

The JAX init sets ``conv_b``, ``dt_bias`` and ``A_log`` to 0 and ``D``
and ``norm_w`` to 1, so every head decays alike (A = -1) and a bias,
skip or norm that went missing would not show: the parity tests add
numpy noise to those leaves (and to the RMSNorm weights) first. Their
``A_log`` noise spreads the heads' decays over e^-1 to e^1.

Tolerances: rtol 1e-4 / atol 1e-4 in fp32 (products summed in XLA's
order on one side and oneDNN's on the other, over two layers and a
1024-wide head), as for the dense zoo. In bf16 the two frameworks round
the products' sums at other places, so a block's output differs by a
few bf16 steps of its size (about 1): rtol 2e-2 / atol 3e-2."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import ssm as jssm
from repro.models.transformer import init_lm as jinit_lm
from repro.models.transformer import lm_forward as jlm_forward
from repro.serving.forecaster import ZooForecaster as JZooForecaster
from repro_torch.checkpoint.convert import zoo_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.tokens import synthetic_token_batch
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.models import ssm
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import init_lm, lm_forward
from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                 ServingEngine, ZooForecaster,
                                 build_zoo_forecaster)
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-4, 1e-4
BF16_RTOL, BF16_ATOL = 2e-2, 3e-2
ARCH = "mamba2-370m"
ROOT = Path(__file__).resolve().parents[1]
# the leaves the JAX init sets to a constant, and the noise put on them
NOISE = {"A_log": 0.5, "dt_bias": 0.5, "conv_b": 0.2, "D": 0.2,
         "norm_w": 0.2, "w": 0.2}


def _noisy_jax_params(jcfg, seed, dt_bias=None):
    """JAX init as float32 numpy leaves, with noise on every leaf the
    init sets to a constant; ``dt_bias`` (if given) is added to every
    head's dt bias on top."""
    rng = np.random.default_rng(seed)

    def noise(path, a):
        a = np.asarray(a.astype(jnp.float32))
        name = jax.tree_util.keystr(path).rsplit("'", 2)[-2]
        if name in NOISE:
            a = a + NOISE[name] * rng.standard_normal(a.shape)
        if name == "dt_bias" and dt_bias is not None:
            a = a + dt_bias
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        noise, jinit_lm(jcfg, jax.random.PRNGKey(seed)))


def _cfgs(**over):
    return reduced(get_config(ARCH), **over), \
        jreduced(jget_config(ARCH), **over)


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree["layers"]["ssm"].items()}


# ------------------------------------------------------------- configs --

def test_config_equals_jax_config_full_and_reduced():
    ours, theirs = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(reduced(ours)) == dataclasses.asdict(
        jreduced(theirs))
    for prop in ("padded_vocab", "d_inner", "ssm_heads",
                 "is_attention_free", "supports_long_context"):
        assert getattr(ours, prop) == getattr(theirs, prop)
    assert ours.param_count() == theirs.param_count()
    assert (ours.n_layers, ours.d_model, ours.ssm_heads, ours.ssm_head_dim,
            ours.ssm_state, ours.ssm_chunk) == (48, 1024, 32, 64, 128, 128)
    small = reduced(ours)
    assert (small.ssm_state, small.ssm_head_dim, small.ssm_chunk) == \
        (32, 32, 16)


# -------------------------------------------------------------- layers --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(dtype):
    """The taps summed in order in x's dtype, so bf16 agrees bit for bit
    and fp32 to its last bits."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 19, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    jt = getattr(jnp, dtype)
    want = jssm.causal_conv1d(*(jnp.asarray(t, jt) for t in (x, w, b)))
    got = ssm.causal_conv1d(*(torch.from_numpy(t).to(getattr(torch, dtype))
                              for t in (x, w, b)))
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # causal: y[t] reads no x after t
    late = x.copy()
    late[:, 10:] += 1.0
    moved = ssm.causal_conv1d(*map(torch.from_numpy, (late, w, b)))
    first = ssm.causal_conv1d(*map(torch.from_numpy, (x, w, b)))
    assert torch.equal(moved[:, :10], first[:, :10])


@pytest.mark.parametrize("dt_bias,L", [(None, 40), (None, 5), (120.0, 37)],
                         ids=["noised", "shorter-than-a-chunk", "dt-clip"])
def test_mamba2_apply_matches_jax(dt_bias, L):
    """One block in fp32 on noised weights. ``dt-clip`` pushes every
    head's dt to its clip of 100 (softplus(~120)), so the scan's masked
    exp overflows above the diagonal: the output must stay finite."""
    cfg, jcfg = _cfgs()
    params = _noisy_jax_params(jcfg, seed=1, dt_bias=dt_bias)
    x = np.random.default_rng(2).standard_normal(
        (3, L, cfg.d_model)).astype(np.float32)
    kw = dict(head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state,
              chunk=cfg.ssm_chunk)
    want = jssm.mamba2_apply(_layer(params), jnp.asarray(x), **kw)
    tp = zoo_params_from_numpy(cfg, params, device="cpu")
    got = ssm.mamba2_apply(_layer(tp), torch.from_numpy(x), **kw)
    assert got.shape == x.shape and torch.all(torch.isfinite(got))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_mamba2_apply_bf16_matches_jax():
    """bf16 weights and activations, dt_bias and A_log in float32: the
    casts of the JAX block (dt rounded to bf16 before it scales x, the
    scan's y cast to bf16, its state in fp32) give the same output
    within a few bf16 steps."""
    cfg, jcfg = _cfgs(dtype="bfloat16")
    params = _noisy_jax_params(jcfg, seed=3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jparams["layers"]["ssm"] = {
        k: v if k in ("dt_bias", "A_log") else v.astype(jnp.bfloat16)
        for k, v in jparams["layers"]["ssm"].items()}
    x = np.random.default_rng(4).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    kw = dict(head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state,
              chunk=cfg.ssm_chunk)
    want = jssm.mamba2_apply(_layer(jparams), jnp.asarray(x, jnp.bfloat16),
                             **kw)
    tp = zoo_params_from_numpy(cfg, params, device="cpu")
    got = ssm.mamba2_apply(_layer(tp), torch.from_numpy(x).to(
        torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


# ---------------------------------------------------------------- init --

def _dtypes(tree):
    if isinstance(tree, dict):
        return {k: _dtypes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_tree_matches_jax(dtype):
    """Same keys, shapes and dtypes, leaf by leaf: dt_bias and A_log stay
    float32 in a bf16 model; the constants are the JAX init's."""
    cfg, jcfg = _cfgs(dtype=dtype)
    ours = init_lm(cfg, torch.Generator().manual_seed(0))
    assert _dtypes(ours) == _dtypes(jinit_lm(jcfg, jax.random.PRNGKey(0)))
    blk = ours["layers"]["ssm"]
    assert blk["dt_bias"].dtype == blk["A_log"].dtype == torch.float32
    for name, value in (("conv_b", 0), ("dt_bias", 0), ("A_log", 0),
                        ("D", 1), ("norm_w", 1)):
        assert torch.all(blk[name] == value)
    assert not torch.equal(blk["in_proj"][0], blk["in_proj"][1])
    std = float(blk["in_proj"].float().std())
    assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "qwen1.5-4b",
                                  "zamba2-2.7b"])
def test_init_lm_on_the_meta_device_is_the_drawn_tree_without_data(arch,
                                                                   dtype):
    """With no generator, ``init_lm`` gives the drawn init's keys, shapes
    and dtypes on the meta device: what the weight converter casts to."""
    cfg = reduced(get_config(arch), dtype=dtype)
    meta = init_lm(cfg, None)
    assert all(t.is_meta for t in tree_leaves(meta))
    assert _dtypes(meta) == _dtypes(
        init_lm(cfg, torch.Generator().manual_seed(0)))


def test_zoo_params_from_numpy_keeps_the_fp32_leaves():
    """Converting the JAX tree of a bf16 model gives each leaf the JAX
    leaf's own dtype (dt_bias and A_log float32, the rest bf16), with
    the same values, whether the bf16 leaves arrive widened to float32
    or as numpy bfloat16 arrays."""
    cfg, jcfg = _cfgs(dtype="bfloat16")
    jtree = jinit_lm(jcfg, jax.random.PRNGKey(5))
    jtree["layers"]["ssm"]["A_log"] = jtree["layers"]["ssm"]["A_log"] + 0.3
    widened = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jtree)
    as_is = jax.tree_util.tree_map(np.asarray, jtree)
    want = jax.tree_util.tree_leaves_with_path(jtree)
    for tree in (widened, as_is):
        ours = zoo_params_from_numpy(cfg, tree, device="cpu")
        assert _dtypes(ours) == _dtypes(jtree)
        got = dict(zip(map(jax.tree_util.keystr, (p for p, _ in want)),
                       tree_leaves(ours)))
        for path, leaf in want:
            np.testing.assert_array_equal(
                got[jax.tree_util.keystr(path)].float().numpy(),
                np.asarray(leaf.astype(jnp.float32)))


# ------------------------------------------------------------- forward --

def test_lm_forward_matches_jax():
    cfg, jcfg = _cfgs()
    params = _noisy_jax_params(jcfg, seed=6)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab, (3, 37)).astype(np.int32)
    want, jaux = jlm_forward(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                             jnp.asarray(tokens))
    tparams = zoo_params_from_numpy(cfg, params, device="cpu")
    got, aux = lm_forward(cfg, tparams, torch.from_numpy(tokens))
    assert got.shape == (3, 37, cfg.padded_vocab)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    fwd, _ = build_model(cfg).forward(tparams, torch.from_numpy(tokens))
    assert torch.equal(fwd, got)


# ------------------------------------------------------------- serving --

@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's forecaster on the same noised weights, each
    calibrated on the same token windows."""
    from repro.data.tokens import synthetic_token_batch as jtokens

    cfg, jcfg = _cfgs()
    params = _noisy_jax_params(jcfg, seed=8)
    calib = jtokens(16, 32, jcfg.vocab, seed=11)
    ref = JZooForecaster(cfg=jcfg, params=params).calibrate(calib)
    ours = ZooForecaster(cfg=cfg, params=zoo_params_from_numpy(
        cfg, params, device="cpu"), device="cpu").calibrate(calib)
    return ref, ours


def _ragged(n, seed):
    toks = synthetic_token_batch(n, 32, 1024, seed=seed)
    lens = np.random.default_rng(seed).integers(1, 33, n).astype(np.int32)
    for i, t in enumerate(lens):
        toks[i, t:] = 0
    return toks, lens


def test_predict_matches_jax(pair):
    """Right-padded windows with their lengths: the SSM is causal, so a
    row's padding never reaches its last real position."""
    ref, ours = pair
    for key in ("xi", "scale", "tail_at_xi"):
        np.testing.assert_allclose(ours.tail[key], ref.tail[key],
                                   rtol=RTOL, atol=ATOL)
    toks, lens = _ragged(12, seed=2)
    tok_j, p_j = ref.predict(toks, lens)
    tok, p = ours.predict(toks, lens)
    np.testing.assert_array_equal(tok, tok_j)
    np.testing.assert_allclose(p, p_j, rtol=RTOL, atol=ATOL)
    assert np.all((p >= 0) & (p <= 1)) and np.any(p > 0)
    tok_j, p_j = ref.predict(toks[:4])
    tok, p = ours.predict(toks[:4])
    np.testing.assert_array_equal(tok, tok_j)
    np.testing.assert_allclose(p, p_j, rtol=RTOL, atol=ATOL)


def test_engine_token_traffic_equals_direct_predict(pair):
    _, fc = pair
    registry = ModelRegistry()
    registry.register(ARCH, fc)
    toks, lens = _ragged(8, seed=3)
    cfg = BatcherConfig(max_batch=8, max_wait_ms=60_000.0,
                        length_buckets=(32,))
    with ServingEngine(registry, cfg) as engine:
        futs = [engine.submit(ARCH, toks[i, :t], client_id=f"c{i}")
                for i, t in enumerate(lens)]
        got = [f.result(timeout=60) for f in futs]
        snap = engine.telemetry.snapshot()
    assert snap["requests"] == 8 and snap["batches"] == 1
    tok, p = fc.predict(toks, lens)
    assert got == [(float(tok[i]), float(p[i])) for i in range(8)]


def test_build_zoo_forecaster_serves_mamba2_on_the_cpu():
    """The reduced config by default, drawn from the seed; the CPU route
    runs the plain scan and launches no kernel."""
    before = ssd_kernel.SSD_LAUNCHES.total
    fc = build_zoo_forecaster(ARCH, seed=0, device="cpu")
    assert fc.cfg == reduced(get_config(ARCH)) and fc.tail is not None
    toks = synthetic_token_batch(4, 32, fc.cfg.vocab, seed=9)
    tok, p = fc.predict(toks)
    again = build_zoo_forecaster(ARCH, seed=0, device="cpu").predict(toks)
    np.testing.assert_array_equal(tok, again[0])
    assert np.all((tok >= 0) & (tok < fc.cfg.vocab)) and np.all(
        np.isfinite(p))
    assert ssd_kernel.SSD_LAUNCHES.total == before


def test_serve_cli_hosts_mamba2_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--model", ARCH,
         "--device", "cpu", "--requests", "16", "--max-batch", "8",
         "--prompt-len", "20"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"hosting '{ARCH}' on cpu" in out.stdout
    assert "16 req in" in out.stdout
