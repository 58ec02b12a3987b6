"""The port's Zamba2 (the zoo's ``hybrid`` family) against the JAX
package's, with the same weights on both sides: the config,
``init_lm``'s param tree (the Mamba2 layers and one ``shared``
attention + MLP block), ``lm_forward``, the shared block with a sliding
window, the long-context window rule, ``ZooForecaster.predict`` on
right-padded windows, the engine, and the serve CLI on the CPU.

The reduced Zamba2-2.7B (2 layers, d_model 256, 8 SSD heads of 32,
state 32, chunk 16, 4 MHA heads of 64) has ``attn_every`` 1: the shared
block runs after every layer, so it cannot tell a wrong grouping of the
layers into stages, nor a shared block copied per stage and drawn apart.
The forward parity therefore also runs ``n_layers`` 6, ``attn_every`` 3
(two stages of three Mamba2 layers).

The JAX init sets ``conv_b``, ``dt_bias`` and ``A_log`` to 0 and ``D``,
``norm_w`` and every RMSNorm weight (the shared block's two included) to
1: the parity tests add numpy noise to those leaves first (Zamba2's
shared block has no biases). Tolerances: rtol 1e-4 / atol 1e-4 in fp32,
as for the other zoo families (products summed in XLA's order on one
side and oneDNN's on the other)."""

import dataclasses
import functools
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
from repro.models import transformer as jtfm
from repro.serving.forecaster import ZooForecaster as JZooForecaster
from repro_torch.checkpoint.convert import zoo_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.tokens import synthetic_token_batch
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.models import transformer as tfm
from repro_torch.models.model_zoo import build_model
from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                 ServingEngine, ZooForecaster,
                                 build_zoo_forecaster)
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-4, 1e-4
ARCH = "zamba2-2.7b"
ROOT = Path(__file__).resolve().parents[1]
# the leaves the JAX init sets to a constant, and the noise put on them
NOISE = {"A_log": 0.5, "dt_bias": 0.5, "conv_b": 0.2, "D": 0.2,
         "norm_w": 0.2, "w": 0.2}
# the reduced config, and two stages of three Mamba2 layers
DEPTHS = {"reduced": {}, "6-layers-every-3": dict(n_layers=6, attn_every=3)}


def _cfgs(**over):
    return reduced(get_config(ARCH), **over), \
        jreduced(jget_config(ARCH), **over)


def _noisy_jax_params(jcfg, seed):
    """JAX init as float32 numpy leaves, with noise on every leaf the
    init sets to a constant."""
    rng = np.random.default_rng(seed)

    def noise(path, a):
        a = np.asarray(a.astype(jnp.float32))
        name = jax.tree_util.keystr(path).rsplit("'", 2)[-2]
        if name in NOISE:
            a = a + NOISE[name] * rng.standard_normal(a.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        noise, jtfm.init_lm(jcfg, jax.random.PRNGKey(seed)))


def _dtypes(tree):
    if isinstance(tree, dict):
        return {k: _dtypes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


# ------------------------------------------------------------- configs --

def test_config_equals_jax_config_full_and_reduced():
    ours, theirs = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for over in DEPTHS.values():
        assert dataclasses.asdict(reduced(ours, **over)) == \
            dataclasses.asdict(jreduced(theirs, **over))
    for prop in ("padded_vocab", "q_dim", "kv_dim", "d_inner", "ssm_heads",
                 "is_attention_free", "supports_long_context"):
        assert getattr(ours, prop) == getattr(theirs, prop)
    assert ours.param_count() == theirs.param_count() == 2_422_527_648
    assert (ours.family, ours.n_layers, ours.attn_every, ours.d_model,
            ours.ssm_heads, ours.ssm_head_dim, ours.ssm_state,
            ours.ssm_chunk, ours.n_heads, ours.n_kv_heads, ours.head_dim) \
        == ("hybrid", 54, 6, 2560, 80, 64, 64, 128, 32, 32, 80)
    small = reduced(ours)
    assert (small.n_layers, small.attn_every, small.n_heads,
            small.n_kv_heads) == (2, 1, 4, 4)


# ---------------------------------------------------------------- init --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_tree_matches_jax(dtype):
    """Same keys, shapes and dtypes, leaf by leaf: the Mamba2 layers
    stacked on a leading [L] dim, one ``shared`` decoder block with no
    leading dim; dt_bias and A_log float32 in a bf16 model; the
    constants are the JAX init's."""
    cfg, jcfg = _cfgs(dtype=dtype, n_layers=6, attn_every=3)
    ours = tfm.init_lm(cfg, torch.Generator().manual_seed(0))
    assert _dtypes(ours) == _dtypes(jtfm.init_lm(jcfg,
                                                 jax.random.PRNGKey(0)))
    assert sorted(ours) == ["embed", "final_norm", "layers", "lm_head",
                            "shared"]
    assert sorted(ours["layers"]) == ["norm1", "ssm"]
    shared = ours["shared"]
    assert sorted(shared) == ["attn", "mlp", "norm1", "norm2"]
    assert tuple(shared["attn"]["wq"].shape) == (cfg.d_model, cfg.q_dim)
    assert sorted(shared["mlp"]) == ["w1", "w2"]          # not gated
    for norm in ("norm1", "norm2"):
        assert torch.all(shared[norm]["w"] == 1)
    blk = ours["layers"]["ssm"]
    assert blk["dt_bias"].dtype == blk["A_log"].dtype == torch.float32
    assert not torch.equal(blk["in_proj"][0], blk["in_proj"][1])


def test_full_tree_on_the_meta_device_is_the_jax_tree():
    """The full config's tree, with no data: every key, shape and dtype
    of the JAX init's (read with ``jax.eval_shape``), 2,396,455,840
    parameters in all. ``param_count`` (2,422,527,648, the roofline's
    estimate, on both sides) counts the shared MLP as gated and leaves
    out ``conv_b``; the drawn tree is the number that is served."""
    cfg = get_config(ARCH)
    meta = tfm.init_lm(cfg, None)
    assert all(t.is_meta for t in tree_leaves(meta))
    want = jax.eval_shape(functools.partial(jtfm.init_lm, jget_config(ARCH)),
                          jax.random.PRNGKey(0))
    assert _dtypes(meta) == _dtypes(want)
    n = sum(t.numel() for t in tree_leaves(meta))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(want)) == 2_396_455_840


# ------------------------------------------------------------- forward --

@pytest.mark.parametrize("depth", list(DEPTHS))
def test_lm_forward_matches_jax(depth):
    cfg, jcfg = _cfgs(**DEPTHS[depth])
    params = _noisy_jax_params(jcfg, seed=6)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab, (3, 37)).astype(np.int32)
    want, jaux = jtfm.lm_forward(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                              params),
                                 jnp.asarray(tokens))
    tparams = zoo_params_from_numpy(cfg, params, device="cpu")
    got, aux = tfm.lm_forward(cfg, tparams, torch.from_numpy(tokens))
    assert got.shape == (3, 37, cfg.padded_vocab)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    fwd, _ = build_model(cfg).forward(tparams, torch.from_numpy(tokens))
    assert torch.equal(fwd, got)


def test_every_stage_reads_the_one_shared_block(monkeypatch):
    """At 6 layers, every 3: the shared block runs twice, after layers 3
    and 6, each time on the same tensors of ``params["shared"]``."""
    cfg, _ = _cfgs(**DEPTHS["6-layers-every-3"])
    params = tfm.init_lm(cfg, torch.Generator().manual_seed(1))
    calls, ssm_calls = [], []
    block, ssm_block = tfm._decoder_block, tfm._ssm_block

    def spy(cfg_, lp, x, positions, window):
        calls.append((len(ssm_calls), lp["attn"]["wq"].data_ptr()))
        return block(cfg_, lp, x, positions, window)

    def ssm_spy(cfg_, lp, x):
        ssm_calls.append(1)
        return ssm_block(cfg_, lp, x)

    monkeypatch.setattr(tfm, "_decoder_block", spy)
    monkeypatch.setattr(tfm, "_ssm_block", ssm_spy)
    tfm.lm_forward(cfg, params, torch.zeros(2, 5, dtype=torch.long))
    ptr = params["shared"]["attn"]["wq"].data_ptr()
    assert calls == [(3, ptr), (6, ptr)]


def test_depth_not_a_multiple_of_attn_every_raises_on_both_sides():
    cfg, jcfg = _cfgs(n_layers=5, attn_every=3)
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(TypeError):
        jtfm.lm_forward(jcfg, jtfm.init_lm(jcfg, jax.random.PRNGKey(0)),
                        jnp.asarray(tokens))
    params = tfm.init_lm(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="n_layers=5 .*attn_every=3"):
        tfm.lm_forward(cfg, params, torch.from_numpy(tokens).long())


@pytest.mark.parametrize("seq_len", [131072, 131073])
def test_effective_window_matches_jax(seq_len):
    """Past 131,072 tokens the shared block attends within the
    long-context window (4096)."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    want = jtfm._effective_window(jcfg, seq_len)
    assert tfm._effective_window(cfg, seq_len) == want
    assert want == (None if seq_len == 131072 else 4096)


def test_shared_decoder_block_with_a_window_matches_jax():
    """The shared block alone with a sliding window of 5 over 19
    positions (MHA, RoPE, RMSNorm, plain GELU MLP), on noised weights."""
    cfg, jcfg = _cfgs()
    params = _noisy_jax_params(jcfg, seed=4)
    x = np.random.default_rng(5).standard_normal(
        (2, 19, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(19), (2, 19))
    want, _ = jtfm._decoder_block(jcfg, jax.tree_util.tree_map(
        jnp.asarray, params["shared"]), jnp.asarray(x), jnp.asarray(pos), 5)
    shared = zoo_params_from_numpy(cfg, params, device="cpu")["shared"]
    got, _ = tfm._decoder_block(cfg, shared, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    full, _ = tfm._decoder_block(cfg, shared, torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()), None)
    assert torch.equal(full[:, :5], got[:, :5])
    assert not torch.allclose(full[:, 5:], got[:, 5:])


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
    """Right-padded windows with their lengths: the SSM and the shared
    attention are causal, so a row's padding never reaches its last real
    position."""
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


def test_build_zoo_forecaster_serves_zamba2_on_the_cpu():
    """The reduced config by default, drawn from the seed; the CPU route
    runs the plain scan and the plain attention and launches no
    kernel."""
    before = (ssd_kernel.SSD_LAUNCHES.total,
              attn_kernel.FLASH_LAUNCHES.total)
    fc = build_zoo_forecaster(ARCH, seed=0, device="cpu")
    assert fc.cfg == reduced(get_config(ARCH)) and fc.tail is not None
    assert sorted(fc.params) == ["embed", "final_norm", "layers", "lm_head",
                                 "shared"]
    toks = synthetic_token_batch(4, 32, fc.cfg.vocab, seed=9)
    tok, p = fc.predict(toks)
    again = build_zoo_forecaster(ARCH, seed=0, device="cpu").predict(toks)
    np.testing.assert_array_equal(tok, again[0])
    assert np.all((tok >= 0) & (tok < fc.cfg.vocab)) and np.all(
        np.isfinite(p))
    assert (ssd_kernel.SSD_LAUNCHES.total,
            attn_kernel.FLASH_LAUNCHES.total) == before


def test_serve_cli_hosts_zamba2_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--model", ARCH,
         "--device", "cpu", "--requests", "16", "--max-batch", "8",
         "--prompt-len", "20"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"hosting '{ARCH}' on cpu" in out.stdout
    assert "16 req in" in out.stdout
