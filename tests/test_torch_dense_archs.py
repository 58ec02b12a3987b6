"""The rest of the port's dense zoo and its VLM against the JAX
package's, with the same weights on both sides: Nemotron-4-15B (GQA
48/8, LayerNorm, non-gated squared ReLU), Granite-20B (MQA 48/1,
LayerNorm, non-gated tanh-GELU), Qwen2.5-32B (GQA 40/8, QKV bias, RoPE
theta 1e6) and Chameleon-34B (the ``vlm`` family: a dense decoder with
QK norm over one vocabulary of text and image tokens). For each: the
config, full and reduced; ``init_lm``'s tree (reduced, drawn, and the
full config's on the meta device against ``jax.eval_shape``);
``lm_forward``; ``zoo_params_from_numpy`` leaf for leaf;
``ZooForecaster.predict`` and a burst through ``ServingEngine``; the
serve CLI on the CPU.

The reduced configs keep the kinds of attention: Granite's 4 query
heads share one KV head (MQA), the others' 4 share 2 (GQA). The JAX
init sets the QKV biases and LayerNorm's ``b`` to 0 and every norm
weight (QK norm's included) to 1, which would hide a missing leaf: the
parity tests add numpy noise to those leaves first. Tolerances: rtol
1e-4 / atol 1e-4 in fp32, as for the other zoo families (products
summed in XLA's order on one side and oneDNN's on the other)."""

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
from repro_torch.models import transformer as tfm
from repro_torch.models.model_zoo import build_model
from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                 ServingEngine, ZooForecaster,
                                 build_zoo_forecaster)
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-4, 1e-4
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["nemotron-4-15b", "granite-20b", "qwen2.5-32b", "chameleon-34b"]
# arch -> (family, n_layers, d_model, Hq, Hkv, d_ff, padded_vocab, norm,
#          activation, gated, qkv_bias, qk_norm); reduced Hkv
FULL = {
    "nemotron-4-15b": (("dense", 32, 6144, 48, 8, 24576, 256000,
                        "layernorm", "relu2", False, False, False), 2),
    "granite-20b": (("dense", 52, 6144, 48, 1, 24576, 49152, "layernorm",
                     "gelu", False, False, False), 1),
    "qwen2.5-32b": (("dense", 64, 5120, 40, 8, 27648, 152064, "rmsnorm",
                     "silu", True, True, False), 2),
    "chameleon-34b": (("vlm", 48, 8192, 64, 8, 22016, 65536, "rmsnorm",
                       "silu", True, False, True), 2),
}
# the leaves the JAX init sets to a constant, and the noise put on them
NOISE = {"w": 0.2, "b": 0.2, "bq": 0.2, "bk": 0.2, "bv": 0.2,
         "q_norm": 0.2, "k_norm": 0.2}


def _cfgs(arch, **over):
    return reduced(get_config(arch), **over), \
        jreduced(jget_config(arch), **over)


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


def _extra_leaves(cfg) -> int:
    """What the drawn tree holds beyond ``param_count`` (the roofline's
    estimate, on both sides): LayerNorm's biases, the QKV biases and the
    QK-norm weights."""
    L, d = cfg.n_layers, cfg.d_model
    n = 0
    if cfg.norm == "layernorm":
        n += 2 * L * d + d
    if cfg.qkv_bias:
        n += L * (cfg.q_dim + 2 * cfg.kv_dim)
    if cfg.qk_norm:
        n += 2 * L * cfg.head_dim
    return n


# ------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax_config_full_and_reduced(arch):
    ours, theirs = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for over in ({}, dict(n_layers=3), dict(dtype="bfloat16")):
        assert dataclasses.asdict(reduced(ours, **over)) == \
            dataclasses.asdict(jreduced(theirs, **over))
    for prop in ("padded_vocab", "q_dim", "kv_dim", "is_attention_free",
                 "supports_long_context"):
        assert getattr(ours, prop) == getattr(theirs, prop)
        assert getattr(reduced(ours), prop) == getattr(reduced(theirs), prop)
    assert ours.param_count() == theirs.param_count()
    assert reduced(ours).param_count() == reduced(theirs).param_count()
    want, small_kv = FULL[arch]
    assert (ours.family, ours.n_layers, ours.d_model, ours.n_heads,
            ours.n_kv_heads, ours.d_ff, ours.padded_vocab, ours.norm,
            ours.activation, ours.gated_mlp, ours.qkv_bias,
            ours.qk_norm) == want
    assert ours.head_dim == 128 and ours.dtype == "bfloat16"
    small = reduced(ours)
    assert (small.n_layers, small.d_model, small.n_heads, small.n_kv_heads,
            small.head_dim, small.dtype) == (2, 256, 4, small_kv, 64,
                                             "float32")


# ---------------------------------------------------------------- init --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_tree_matches_jax(arch, dtype):
    """Same keys, shapes and dtypes, leaf by leaf, as the JAX init of the
    reduced config: LayerNorm's ``b`` beside its ``w``, no ``w3`` in a
    non-gated MLP, the QKV biases and the QK-norm weights where the
    config has them, each at the JAX init's constant."""
    cfg, jcfg = _cfgs(arch, dtype=dtype)
    ours = tfm.init_lm(cfg, torch.Generator().manual_seed(0))
    assert _dtypes(ours) == _dtypes(jtfm.init_lm(jcfg,
                                                 jax.random.PRNGKey(0)))
    lay = ours["layers"]
    for norm in (lay["norm1"], lay["norm2"], ours["final_norm"]):
        assert torch.all(norm["w"] == 1)
        assert ("b" in norm) == (cfg.norm == "layernorm")
        if "b" in norm:
            assert torch.all(norm["b"] == 0)
    assert sorted(lay["mlp"]) == (["w1", "w2", "w3"] if cfg.gated_mlp
                                  else ["w1", "w2"])
    attn = lay["attn"]
    assert ("bq" in attn) == cfg.qkv_bias
    assert ("q_norm" in attn) == ("k_norm" in attn) == cfg.qk_norm
    if cfg.qk_norm:
        assert tuple(attn["q_norm"].shape) == (cfg.n_layers, cfg.head_dim)
        assert torch.all(attn["q_norm"] == 1)
    assert tuple(attn["wk"].shape) == (cfg.n_layers, cfg.d_model,
                                       cfg.kv_dim)
    assert not torch.equal(attn["wq"][0], attn["wq"][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_full_tree_on_the_meta_device_is_the_jax_tree(arch):
    """The full config's tree, with no data: every key, shape and dtype
    of the JAX init's (read with ``jax.eval_shape``). The drawn tree is
    ``param_count()`` plus the leaves the estimate leaves out."""
    cfg = get_config(arch)
    meta = tfm.init_lm(cfg, None)
    assert all(t.is_meta for t in tree_leaves(meta))
    want = jax.eval_shape(functools.partial(jtfm.init_lm, jget_config(arch)),
                          jax.random.PRNGKey(0))
    assert _dtypes(meta) == _dtypes(want)
    n = sum(t.numel() for t in tree_leaves(meta))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(want))
    assert n == cfg.param_count() + _extra_leaves(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_params_from_numpy_leaf_for_leaf(arch):
    """The JAX package's noised params reach the port leaf for leaf: the
    same keys and shapes, each leaf in the dtype of ``init_lm`` on the
    meta device (fp32 values cast to a bf16 config's dtype), its values
    the JAX leaf's."""
    for dtype in ("float32", "bfloat16"):
        cfg, jcfg = _cfgs(arch, dtype=dtype)
        params = _noisy_jax_params(_cfgs(arch)[1], seed=3)
        tparams = zoo_params_from_numpy(cfg, params, device="cpu")
        assert _dtypes(tparams) == _dtypes(tfm.init_lm(cfg, None))
        flat = jax.tree_util.tree_leaves_with_path(params)
        got = tree_leaves(tparams)
        assert len(flat) == len(got)
        for (path, a), t in zip(flat, got):
            want = torch.from_numpy(a).to(t.dtype)
            assert torch.equal(t, want), (dtype, jax.tree_util.keystr(path))


# ------------------------------------------------------------- forward --

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_jax(arch):
    cfg, jcfg = _cfgs(arch)
    params = _noisy_jax_params(jcfg, seed=len(arch))
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, (3, 21)).astype(np.int32)
    want, jaux = jtfm.lm_forward(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(tokens))
    tparams = zoo_params_from_numpy(cfg, params, device="cpu")
    got, aux = build_model(cfg).forward(tparams, torch.from_numpy(tokens))
    assert got.shape == (3, 21, cfg.padded_vocab)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------- serving --

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """The JAX and the port's forecaster of one arch on the same noised
    weights, each calibrated on the same token windows."""
    from repro.data.tokens import synthetic_token_batch as jtokens

    arch = request.param
    cfg, jcfg = _cfgs(arch)
    params = _noisy_jax_params(jcfg, seed=8)
    calib = jtokens(16, 32, jcfg.vocab, seed=11)
    ref = JZooForecaster(cfg=jcfg, params=params).calibrate(calib)
    ours = ZooForecaster(cfg=cfg, params=zoo_params_from_numpy(
        cfg, params, device="cpu"), device="cpu").calibrate(calib)
    return arch, ref, ours


def _ragged(n, seed):
    toks = synthetic_token_batch(n, 32, 1024, seed=seed)
    lens = np.random.default_rng(seed).integers(1, 33, n).astype(np.int32)
    for i, t in enumerate(lens):
        toks[i, t:] = 0
    return toks, lens


def test_predict_matches_jax(pair):
    """Right-padded windows with their lengths (causal attention: a
    row's padding never reaches its last real position)."""
    _, ref, ours = pair
    for key in ("xi", "scale", "tail_at_xi"):
        np.testing.assert_allclose(ours.tail[key], ref.tail[key],
                                   rtol=RTOL, atol=ATOL)
    toks, lens = _ragged(12, seed=2)
    tok_j, p_j = ref.predict(toks, lens)
    tok, p = ours.predict(toks, lens)
    np.testing.assert_array_equal(tok, tok_j)
    np.testing.assert_allclose(p, p_j, rtol=RTOL, atol=ATOL)
    assert np.all((p >= 0) & (p <= 1))


def test_engine_burst_equals_direct_predict(pair):
    """A burst of 16 ragged requests through ``ServingEngine`` at
    ``max_batch`` 8: two flushes, each answer the forecaster's own on
    the same window; no kernel launched on the CPU route."""
    arch, _, fc = pair
    registry = ModelRegistry()
    registry.register(arch, fc)
    toks, lens = _ragged(16, seed=3)
    before = attn_kernel.FLASH_LAUNCHES.total
    cfg = BatcherConfig(max_batch=8, max_wait_ms=60_000.0,
                        length_buckets=(32,))
    with ServingEngine(registry, cfg) as engine:
        futs = [engine.submit(arch, toks[i, :t], client_id=f"c{i}")
                for i, t in enumerate(lens)]
        got = [f.result(timeout=120) for f in futs]
        snap = engine.telemetry.snapshot()
    assert snap["requests"] == 16 and snap["batches"] == 2
    assert attn_kernel.FLASH_LAUNCHES.total == before
    for half in (slice(0, 8), slice(8, 16)):
        tok, p = fc.predict(toks[half], lens[half])
        assert got[half] == [(float(a), float(b)) for a, b in zip(tok, p)]


@pytest.mark.parametrize("arch", ARCHS)
def test_build_zoo_forecaster_serves_the_reduced_config_on_the_cpu(arch):
    """The reduced config by default, drawn from the seed and the same
    for the same seed."""
    fc = build_zoo_forecaster(arch, seed=0, device="cpu")
    assert fc.cfg == reduced(get_config(arch)) and fc.tail is not None
    toks = synthetic_token_batch(4, 32, fc.cfg.vocab, seed=9)
    tok, p = fc.predict(toks)
    again = build_zoo_forecaster(arch, seed=0, device="cpu").predict(toks)
    np.testing.assert_array_equal(tok, again[0])
    np.testing.assert_array_equal(p, again[1])
    assert np.all((tok >= 0) & (tok < fc.cfg.vocab)) and np.all(
        np.isfinite(p))


def test_serve_cli_hosts_granite_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--model",
         "granite-20b", "--device", "cpu", "--requests", "16",
         "--max-batch", "8", "--prompt-len", "20"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "hosting 'granite-20b' on cpu" in out.stdout
    assert "16 req in" in out.stdout
