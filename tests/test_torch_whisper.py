"""The port's audio family, Whisper-medium (an encoder-decoder over the
stubbed frontend's frame embeddings), against the JAX package's, with
the same weights and frames on both sides: the config, full and
reduced; ``synthetic_embedding_batch``; ``init_lm``'s tree (reduced,
drawn, and the full config's on the meta device against
``jax.eval_shape``); ``zoo_params_from_numpy`` leaf for leaf;
``_run_encoder`` and ``lm_forward``; ``ZooForecaster.predict`` on the
JAX package's own stub frames, handed to the port through
``stub_frames``; a burst through ``ServingEngine``; the serve CLI on
the CPU. The decode path's audio layout is in
``tests/test_torch_decode.py``.

The reduced config is 2 encoder + 2 decoder layers, d 256, 4 MHA heads
of 64 and 16 frames, fp32. The JAX init sets the QKV biases (the cross
projections' among them) and LayerNorm's ``b`` to 0 and its ``w`` to 1,
which would hide a missing leaf: the parity tests add numpy noise to
those leaves first. Tolerances: rtol 1e-4 / atol 1e-4 in fp32, as for
the other zoo families (products summed in XLA's order on one side and
oneDNN's on the other)."""

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
from repro.data.tokens import synthetic_embedding_batch as jembeddings
from repro.models import transformer as jtfm
from repro.serving.forecaster import ZooForecaster as JZooForecaster
from repro_torch.checkpoint.convert import zoo_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.tokens import (synthetic_embedding_batch,
                                     synthetic_token_batch)
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.models import transformer as tfm
from repro_torch.models.model_zoo import build_model
from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                 ServingEngine, ZooForecaster,
                                 build_zoo_forecaster)
from repro_torch.serving import forecaster as forecaster_mod
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-4, 1e-4
ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-medium"
# the leaves the JAX init sets to a constant, and the noise put on them
NOISE = {"w": 0.2, "b": 0.2, "bq": 0.2, "bk": 0.2, "bv": 0.2}


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


def _extra_leaves(cfg) -> int:
    """What the drawn tree holds beyond ``param_count`` (the roofline's
    estimate, on both sides): the learned encoder positions,
    LayerNorm's biases (three norms a decoder layer, two an encoder
    layer, the final one) and the QKV biases of every attention (self
    and cross in a decoder layer)."""
    L, E, d = cfg.n_layers, cfg.encoder_layers, cfg.d_model
    qkv = cfg.q_dim + 2 * cfg.kv_dim
    return cfg.n_frames * d + (3 * L + 2 * E + 1) * d + (2 * L + E) * qkv


def _tokens(cfg, B, S, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


# ------------------------------------------------------------- configs --

def test_config_equals_jax_config_full_and_reduced():
    ours, theirs = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for over in ({}, dict(n_layers=3), dict(dtype="bfloat16")):
        assert dataclasses.asdict(reduced(ours, **over)) == \
            dataclasses.asdict(jreduced(theirs, **over))
    for cfg, jcfg in ((ours, theirs), (reduced(ours), reduced(theirs))):
        for prop in ("padded_vocab", "q_dim", "kv_dim", "is_attention_free",
                     "supports_long_context"):
            assert getattr(cfg, prop) == getattr(jcfg, prop)
        assert cfg.param_count() == jcfg.param_count()
    assert (ours.family, ours.n_layers, ours.encoder_layers, ours.n_frames,
            ours.d_model, ours.n_heads, ours.n_kv_heads, ours.head_dim,
            ours.d_ff, ours.padded_vocab, ours.norm, ours.activation,
            ours.gated_mlp, ours.qkv_bias, ours.dtype) == (
        "audio", 24, 24, 1500, 1024, 16, 16, 64, 4096, 51968, "layernorm",
        "gelu", False, True, "bfloat16")
    small = reduced(ours)
    assert (small.n_layers, small.encoder_layers, small.n_frames,
            small.d_model, small.n_heads, small.n_kv_heads,
            small.dtype) == (2, 2, 16, 256, 4, 4, "float32")


@pytest.mark.parametrize("args", [(2, 16, 256, 0), (3, 1500, 1024, 7),
                                  (1, 5, 3, 123)])
def test_synthetic_embedding_batch_equals_jax(args):
    got = synthetic_embedding_batch(*args)
    want = jembeddings(*args)
    assert got.dtype == np.float32 and got.shape == args[:3]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- init --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_tree_matches_jax(dtype):
    """Same keys, shapes and dtypes, leaf by leaf, as the JAX init of the
    reduced config: ``enc_pos``, the encoder stack without cross blocks,
    the decoder stack with ``norm_x`` and ``xattn``, each constant leaf
    at the JAX init's constant; every layer its own draw."""
    cfg, jcfg = _cfgs(dtype=dtype)
    ours = tfm.init_lm(cfg, torch.Generator().manual_seed(0))
    assert _dtypes(ours) == _dtypes(jtfm.init_lm(jcfg,
                                                 jax.random.PRNGKey(0)))
    assert tuple(ours["enc_pos"].shape) == (cfg.n_frames, cfg.d_model)
    enc, dec = ours["enc_layers"], ours["layers"]
    assert "xattn" not in enc and "norm_x" not in enc
    assert tuple(enc["attn"]["wq"].shape)[0] == cfg.encoder_layers
    for norm in (dec["norm1"], dec["norm_x"], dec["norm2"], enc["norm1"]):
        assert torch.all(norm["w"] == 1) and torch.all(norm["b"] == 0)
    assert torch.all(dec["xattn"]["bk"] == 0)
    assert sorted(dec["mlp"]) == ["w1", "w2"]
    assert not torch.equal(dec["xattn"]["wq"][0], dec["xattn"]["wq"][1])
    assert not torch.equal(enc["attn"]["wq"][0], enc["attn"]["wq"][1])
    assert not torch.equal(dec["xattn"]["wq"][0], dec["attn"]["wq"][0])


def test_full_tree_on_the_meta_device_is_the_jax_tree():
    """The full config's tree, with no data: every key, shape and dtype
    of the JAX init's (read with ``jax.eval_shape``). The drawn tree is
    ``param_count()`` plus the leaves the estimate leaves out."""
    cfg = get_config(ARCH)
    meta = tfm.init_lm(cfg, None)
    assert all(t.is_meta for t in tree_leaves(meta))
    want = jax.eval_shape(functools.partial(jtfm.init_lm, jget_config(ARCH)),
                          jax.random.PRNGKey(0))
    assert _dtypes(meta) == _dtypes(want)
    n = sum(t.numel() for t in tree_leaves(meta))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(want))
    assert n == cfg.param_count() + _extra_leaves(cfg)
    assert n == 813_078_528          # 1.51 GiB in bf16


def test_zoo_params_from_numpy_leaf_for_leaf():
    """The JAX package's noised params reach the port leaf for leaf: the
    same keys and shapes (the encoder's and the cross blocks' among
    them), each leaf in the dtype of ``init_lm`` on the meta device,
    its values the JAX leaf's."""
    for dtype in ("float32", "bfloat16"):
        cfg, _ = _cfgs(dtype=dtype)
        params = _noisy_jax_params(_cfgs()[1], seed=3)
        tparams = zoo_params_from_numpy(cfg, params, device="cpu")
        assert _dtypes(tparams) == _dtypes(tfm.init_lm(cfg, None))
        flat = jax.tree_util.tree_leaves_with_path(params)
        got = tree_leaves(tparams)
        assert len(flat) == len(got)
        for (path, a), t in zip(flat, got):
            want = torch.from_numpy(a).to(t.dtype)
            assert torch.equal(t, want), (dtype, jax.tree_util.keystr(path))


# ------------------------------------------------------------- forward --

@pytest.fixture(scope="module")
def weights():
    cfg, jcfg = _cfgs()
    params = _noisy_jax_params(jcfg, seed=4)
    return cfg, jcfg, params, zoo_params_from_numpy(cfg, params, "cpu")


@pytest.mark.parametrize("n_frames", [16, 9])
def test_run_encoder_matches_jax(weights, n_frames):
    """The encoder over the whole frame table and over fewer frames
    (``enc_pos`` sliced): bidirectional attention without RoPE."""
    cfg, jcfg, params, tparams = weights
    frames = synthetic_embedding_batch(3, n_frames, cfg.d_model, seed=1)
    want = jtfm._run_encoder(jcfg, jax.tree.map(jnp.asarray, params),
                             jnp.asarray(frames))
    got = tfm._run_encoder(cfg, tparams, torch.from_numpy(frames))
    assert got.shape == (3, n_frames, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_lm_forward_matches_jax(weights):
    cfg, jcfg, params, tparams = weights
    tokens = _tokens(cfg, 3, 21)
    frames = synthetic_embedding_batch(3, cfg.n_frames, cfg.d_model, seed=2)
    want, jaux = jtfm.lm_forward(
        jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
        jnp.asarray(frames))
    got, aux = build_model(cfg).forward(tparams, torch.from_numpy(tokens),
                                        torch.from_numpy(frames))
    assert got.shape == (3, 21, cfg.padded_vocab)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_forward_and_prefill_without_frames_raise(weights):
    """An audio forward needs frame embeddings, as in the JAX package;
    so does its prefill."""
    cfg, jcfg, params, tparams = weights
    tokens = _tokens(cfg, 1, 4)
    with pytest.raises(ValueError, match="frame embeddings"):
        jtfm.lm_forward(jcfg, jax.tree.map(jnp.asarray, params),
                        jnp.asarray(tokens))
    model = build_model(cfg)
    for fn in (model.forward, model.prefill):
        with pytest.raises(ValueError, match="frame embeddings"):
            fn(tparams, torch.from_numpy(tokens))


def test_cross_attention_reads_the_frames(weights):
    """The logits depend on the frames (a decoder that skipped the cross
    blocks would not) and on each row's own frames only."""
    cfg, _, _, tparams = weights
    tokens = torch.from_numpy(_tokens(cfg, 2, 8))
    frames = torch.from_numpy(synthetic_embedding_batch(
        2, cfg.n_frames, cfg.d_model, seed=3))
    base, _ = tfm.lm_forward(cfg, tparams, tokens, frames)
    other = frames.clone()
    other[1] += 1.0
    moved, _ = tfm.lm_forward(cfg, tparams, tokens, other)
    torch.testing.assert_close(moved[0], base[0], rtol=0, atol=0)
    assert float((moved[1] - base[1]).abs().max()) > 1e-2


# ------------------------------------------------------------- serving --

def _jax_frames(cfg, batch):
    """The JAX forecaster's stub frames for a batch, as numpy."""
    return np.array(jax.random.normal(
        jax.random.PRNGKey(0), (batch, cfg.n_frames, cfg.d_model)))


@pytest.fixture()
def jax_frames(monkeypatch):
    """Serve the port on the JAX package's stub frames."""
    def frames(cfg, batch, device):
        return torch.from_numpy(_jax_frames(cfg, batch)).to(device)

    monkeypatch.setattr(forecaster_mod, "stub_frames", frames)


@pytest.fixture()
def pair(weights, jax_frames):
    """The JAX and the port's forecaster on the same noised weights,
    each calibrated on the same token windows, the port's reading the
    JAX package's frames."""
    from repro.data.tokens import synthetic_token_batch as jtokens

    cfg, jcfg, params, tparams = weights
    calib = jtokens(16, 32, jcfg.vocab, seed=11)
    ref = JZooForecaster(cfg=jcfg, params=params).calibrate(calib)
    ours = ZooForecaster(cfg=cfg, params=tparams,
                         device="cpu").calibrate(calib)
    return ref, ours


def _ragged(n, seed):
    toks = synthetic_token_batch(n, 32, 1024, seed=seed)
    lens = np.random.default_rng(seed).integers(1, 33, n).astype(np.int32)
    for i, t in enumerate(lens):
        toks[i, t:] = 0
    return toks, lens


def test_stub_frames_are_drawn_on_the_device_from_seed_0():
    cfg = reduced(get_config(ARCH))
    a = forecaster_mod.stub_frames(cfg, 3, torch.device("cpu"))
    b = forecaster_mod.stub_frames(cfg, 3, "cpu")
    assert a.shape == (3, cfg.n_frames, cfg.d_model)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    want = torch.randn((3, cfg.n_frames, cfg.d_model),
                       generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, want)
    assert abs(float(a.std()) - 1.0) < 0.05


def test_predict_matches_jax(pair):
    """Right-padded windows with their lengths, on the JAX package's
    frames: the tail, the greedy tokens and the probabilities."""
    ref, ours = pair
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
    _, fc = pair
    registry = ModelRegistry()
    registry.register(ARCH, fc)
    toks, lens = _ragged(16, seed=3)
    before = attn_kernel.FLASH_LAUNCHES.total
    cfg = BatcherConfig(max_batch=8, max_wait_ms=60_000.0,
                        length_buckets=(32,))
    with ServingEngine(registry, cfg) as engine:
        futs = [engine.submit(ARCH, toks[i, :t], client_id=f"c{i}")
                for i, t in enumerate(lens)]
        got = [f.result(timeout=120) for f in futs]
        snap = engine.telemetry.snapshot()
    assert snap["requests"] == 16 and snap["batches"] == 2
    assert attn_kernel.FLASH_LAUNCHES.total == before
    for half in (slice(0, 8), slice(8, 16)):
        tok, p = fc.predict(toks[half], lens[half])
        assert got[half] == [(float(a), float(b)) for a, b in zip(tok, p)]


def test_build_zoo_forecaster_serves_the_reduced_config_on_the_cpu():
    """The reduced config by default, drawn from the seed and the same
    for the same seed, on the port's own stub frames."""
    fc = build_zoo_forecaster(ARCH, seed=0, device="cpu")
    assert fc.cfg == reduced(get_config(ARCH)) and fc.tail is not None
    toks = synthetic_token_batch(4, 32, fc.cfg.vocab, seed=9)
    tok, p = fc.predict(toks)
    again = build_zoo_forecaster(ARCH, seed=0, device="cpu").predict(toks)
    np.testing.assert_array_equal(tok, again[0])
    np.testing.assert_array_equal(p, again[1])
    assert np.all((tok >= 0) & (tok < fc.cfg.vocab)) and np.all(
        np.isfinite(p))


def test_serve_cli_hosts_whisper_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--model", ARCH,
         "--device", "cpu", "--requests", "16", "--max-batch", "8",
         "--prompt-len", "20"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"hosting '{ARCH}' on cpu" in out.stdout
    assert "16 req in" in out.stdout
