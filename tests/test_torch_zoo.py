"""The port's model zoo (dense family) against the JAX package's: the
configs, the layers (norms, interleaved RoPE, activations, the MLP),
``init_lm``'s param tree, and ``lm_forward`` on the reduced Qwen1.5-4B
in fp32 with the same weights on both sides.

The JAX init sets the QKV biases to zero and the norm weights to one,
which would hide a missing bias or norm, so the forward parity adds
numpy noise to every bias and norm weight first. Tolerances:
elementwise layers at rtol 1e-5 / atol 1e-6 (fp32, one rounding
apart); the MLP and the forward at rtol 1e-4 / atol 1e-4 (fp32 products
summed in XLA's order on one side and oneDNN's on the other, over two
layers and a 1024-wide head)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import layers as jlayers
from repro.models.mlp import mlp_apply as jmlp_apply
from repro.models.transformer import init_lm as jinit_lm
from repro.models.transformer import lm_forward as jlm_forward
from repro_torch.checkpoint.convert import zoo_params_from_numpy
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import pad_vocab, reduced
from repro_torch.models import layers
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import init_lm, lm_forward
from repro_torch.tree import tree_leaves

EW_RTOL, EW_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 1e-4
ARCH = "qwen1.5-4b"


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, rtol=EW_RTOL, atol=EW_ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# ------------------------------------------------------------- configs --

def test_config_equals_jax_config_full_and_reduced():
    ours, theirs = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(reduced(ours)) == dataclasses.asdict(
        jreduced(theirs))
    assert dataclasses.asdict(reduced(ours, n_layers=3)) == \
        dataclasses.asdict(jreduced(theirs, n_layers=3))
    for prop in ("padded_vocab", "q_dim", "kv_dim", "d_inner",
                 "supports_long_context"):
        assert getattr(ours, prop) == getattr(theirs, prop)
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()
    assert ours.padded_vocab == 152064 and ours.n_layers == 40


def test_registry_lists_the_ported_archs_and_rejects_others():
    assert list_archs() == ["chameleon-34b", "granite-20b", "mamba2-370m",
                            "mixtral-8x7b", "nemotron-4-15b", ARCH,
                            "qwen2.5-32b", "qwen3-moe-235b-a22b",
                            "whisper-medium", "zamba2-2.7b"]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large")
    assert [pad_vocab(v) for v in (1, 256, 257, 151936)] == \
        [jlayers.pad_vocab(v) for v in (1, 256, 257, 151936)]
    assert layers.pad_vocab(151936) == 152064


# -------------------------------------------------------------- layers --

def test_rms_norm_and_layer_norm_match_jax():
    rng = _rng(0)
    x, w, b = _f32(rng, 3, 5, 64), _f32(rng, 64), _f32(rng, 64)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    _close(layers.rms_norm(tx, tw), jlayers.rms_norm(x, w))
    _close(layers.layer_norm(tx, tw, tb), jlayers.layer_norm(x, w, b))
    _close(layers.layer_norm(tx, tw, None), jlayers.layer_norm(x, w, None))
    for kind, p in (("rmsnorm", {"w": tw}), ("layernorm", {"w": tw, "b": tb})):
        jp = {k: v.numpy() for k, v in p.items()}
        _close(layers.apply_norm(tx, p, kind), jlayers.apply_norm(x, jp, kind))


def test_norms_upcast_bf16_inside():
    rng = _rng(1)
    x, w = _f32(rng, 4, 128, scale=30.0), _f32(rng, 128)
    got = layers.rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(w).to(torch.bfloat16))
    want = jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(w, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_interleaved_matches_jax(theta):
    rng = _rng(2)
    x = _f32(rng, 2, 7, 3, 64)
    pos = np.array([[0, 1, 5, 9, 33, 101, 2047],
                    [3, 7, 11, 13, 17, 19, 1999]], np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta)
    _close(got, jlayers.apply_rope(x, pos, theta), atol=1e-5)
    _close(layers.rope_frequencies(64, theta),
           jlayers.rope_frequencies(64, theta))


def test_rope_rotates_adjacent_pairs_not_halves():
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0                      # the pair (x[0], x[1])
    y = layers.apply_rope(x, torch.tensor([[1]]))
    assert y[0, 0, 0, 1] != 0 and torch.all(y[0, 0, 0, 2:] == 0)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu2"])
def test_activations_match_jax(name):
    x = _f32(_rng(3), 257, scale=4.0)
    _close(layers.ACTIVATIONS[name](torch.from_numpy(x)),
           jlayers.ACTIVATIONS[name](x))


@pytest.mark.parametrize("gated,bias,act", [(True, False, "silu"),
                                            (False, True, "gelu"),
                                            (False, False, "relu2")])
def test_mlp_apply_matches_jax(gated, bias, act):
    rng = _rng(4)
    x = _f32(rng, 2, 5, 32)
    p = {"w1": _f32(rng, 32, 48, scale=0.2), "w2": _f32(rng, 48, 32, scale=0.2)}
    if gated:
        p["w3"] = _f32(rng, 32, 48, scale=0.2)
    if bias:
        p["b1"], p["b2"] = _f32(rng, 48), _f32(rng, 32)
    got = mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), act, gated)
    _close(got, jmlp_apply(p, x, act, gated), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- init --

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_tree_matches_jax(dtype):
    cfg = reduced(get_config(ARCH), dtype=dtype)
    ours = init_lm(cfg, torch.Generator().manual_seed(0))
    theirs = jinit_lm(jreduced(jget_config(ARCH), dtype=dtype),
                      jax.random.PRNGKey(0))
    assert _shapes(ours) == _shapes(theirs)
    attn = ours["layers"]["attn"]
    assert torch.all(attn["bq"] == 0) and torch.all(
        ours["layers"]["norm1"]["w"] == 1)
    std = float(attn["wq"].float().std())
    assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.05
    again = init_lm(cfg, torch.Generator().manual_seed(0))
    other = init_lm(cfg, torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ours),
                                                 tree_leaves(again)))
    assert not torch.equal(ours["lm_head"], other["lm_head"])
    # every layer of the stack is its own draw
    assert not torch.equal(attn["wq"][0], attn["wq"][1])


def test_other_families_are_not_ported_yet():
    """Zoo training runs (``loss`` is ``lm_loss``); the audio family,
    the last one the port lacked, runs (an audio forward or prefill
    without frames raises, as in the JAX package); a family no package
    has is refused."""
    cfg = reduced(get_config(ARCH))
    model = build_model(cfg)
    loss = model.loss(model.init(torch.Generator().manual_seed(0)),
                      torch.zeros(2, 8, dtype=torch.long))
    assert loss.shape == () and torch.isfinite(loss)
    audio = build_model(reduced(get_config("whisper-medium")))
    params = audio.init(torch.Generator().manual_seed(0))
    toks = torch.zeros(1, 4, dtype=torch.long)
    frames = torch.zeros(1, audio.cfg.n_frames, audio.cfg.d_model)
    logits, cache = audio.prefill(params, toks, frames)
    assert torch.all(torch.isfinite(logits)) and {"xk", "xv"} <= set(cache)
    assert set(audio.init_cache(1, 4, device="cpu")) == set(cache)
    for fn in (audio.forward, audio.prefill):
        with pytest.raises(ValueError, match="frame embeddings"):
            fn(params, toks)
    with pytest.raises(ValueError, match="unknown family"):
        init_lm(dataclasses.replace(cfg, family="speech"), None)


# ------------------------------------------------------------- forward --

def _noisy_jax_params(jcfg, seed):
    """JAX init, with numpy noise on every QKV bias and norm weight (the
    init leaves them 0 and 1), as numpy leaves."""
    rng = _rng(seed)

    def noise(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if any(f"'{k}'" in name for k in ("bq", "bk", "bv", "w", "b",
                                          "q_norm", "k_norm")):
            a = a + 0.2 * rng.standard_normal(a.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        noise, jinit_lm(jcfg, jax.random.PRNGKey(seed)))


# the reduced Qwen1.5-4B, and variants through the other dense branches
# (sliding window, LayerNorm + GELU + plain MLP + QK norm)
VARIANTS = {
    "qwen": {},
    "window": dict(window=5),
    "layernorm-gelu-qknorm": dict(norm="layernorm", activation="gelu",
                                  gated_mlp=False, qk_norm=True,
                                  rope_theta=1e6),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lm_forward_matches_jax(variant):
    over = VARIANTS[variant]
    cfg = reduced(get_config(ARCH), **over)
    jcfg = jreduced(jget_config(ARCH), **over)
    params = _noisy_jax_params(jcfg, seed=len(variant))
    tokens = _rng(5).integers(0, cfg.vocab, (3, 21)).astype(np.int32)
    want, jaux = jlm_forward(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                             jnp.asarray(tokens))
    tparams = zoo_params_from_numpy(cfg, params, device="cpu")
    got, aux = lm_forward(cfg, tparams, torch.from_numpy(tokens))
    assert got.shape == (3, 21, cfg.padded_vocab)
    assert float(aux) == float(jaux) == 0.0
    _close(got, want, rtol=RTOL, atol=ATOL)
    fwd, _ = build_model(cfg).forward(tparams, torch.from_numpy(tokens))
    assert torch.equal(fwd, got)


def test_zoo_params_from_numpy_casts_to_the_config_dtype():
    cfg = reduced(get_config(ARCH), dtype="bfloat16")
    params = _noisy_jax_params(jreduced(jget_config(ARCH)), seed=3)
    tparams = zoo_params_from_numpy(cfg, params, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tparams))
    assert _shapes(tparams) == {
        k: v for k, v in _shapes(init_lm(
            cfg, torch.Generator().manual_seed(0))).items()}
    np.testing.assert_array_equal(
        tparams["embed"].float().numpy(),
        torch.from_numpy(params["embed"]).to(torch.bfloat16).float().numpy())
