"""The port's MoE family against the JAX package's: ``moe_apply`` (the
output and the Switch load-balance loss, over dropping and no-drop
capacities, padded groups, exact router ties, gated SiLU and non-gated
GELU experts), and Mixtral-8x7B and Qwen3-MoE-235B-A22B: the configs,
full and reduced; ``init_lm``'s tree (the router float32 in a bf16
model); ``zoo_params_from_numpy`` leaf for leaf; ``lm_forward``'s
logits and aux; a burst through ``ServingEngine``; the serve CLI on
the CPU. The decode path of both archs is in ``test_torch_decode.py``
(layouts ``moe``, ``moe-ring`` and ``moe-drop``).

Tolerances: ``moe_apply`` in fp32 at rtol 1e-5 / atol 1e-6 (products
summed in XLA's order on one side and oneDNN's on the other), in bf16
at flash attention's bf16 tolerance, 0.08; the models at rtol 1e-4 /
atol 1e-4, as for the other zoo families."""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtfm
from repro.models.mlp import moe_apply as jmoe_apply
from repro.serving.forecaster import ZooForecaster as JZooForecaster
from repro_torch.checkpoint.convert import zoo_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.tokens import synthetic_token_batch
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.models import transformer as tfm
from repro_torch.models.mlp import moe_apply
from repro_torch.models.model_zoo import build_model
from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                 ServingEngine, ZooForecaster,
                                 build_zoo_forecaster)
from repro_torch.tree import tree_leaves

EW_RTOL, EW_ATOL = 1e-5, 1e-6
BF16_TOL = 0.08
RTOL, ATOL = 1e-4, 1e-4
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["mixtral-8x7b", "qwen3-moe-235b-a22b"]
GROUP = 16
# arch -> (n_layers, d_model, Hq, Hkv, d_ff, padded_vocab, E, top_k,
#          window, qk_norm, rope_theta)
FULL = {"mixtral-8x7b": (32, 4096, 32, 8, 14336, 32000, 8, 2, 4096, False,
                         1e4),
        "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 1536, 152064, 128, 8, None,
                                True, 1e6)}
# the leaves the JAX init sets to a constant, and the noise put on them
NOISE = {"w": 0.2, "q_norm": 0.2, "k_norm": 0.2}


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _moe_params(rng, E, D, F, gated):
    p = {"router": _f32(rng, D, E, scale=D ** -0.5),
         "w1": _f32(rng, E, D, F, scale=D ** -0.5),
         "w2": _f32(rng, E, F, D, scale=F ** -0.5)}
    if gated:
        p["w3"] = _f32(rng, E, D, F, scale=D ** -0.5)
    return p


def _both(p, x, **kw):
    """(JAX out, JAX aux, port out, port aux) as numpy / float, on the
    same numpy params and input."""
    jout, jaux = jmoe_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), **kw)
    out, aux = moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), **kw)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    assert aux.shape == ()
    return np.asarray(jout), float(jaux), out.numpy(), float(aux)


# ----------------------------------------------------------- moe_apply --

MOE_CASES = [(E, k, cf, tokens, act)
             for E, k in ((4, 1), (8, 2), (16, 8))
             for cf in (0.25, 1.25, "no-drop")
             for tokens in ((2, 16), (3, 7))
             for act in ("silu-gated", "gelu")]


@pytest.mark.parametrize(
    "E,top_k,cf,tokens,act", MOE_CASES,
    ids=[f"E{E}-k{k}-cf{cf}-{t[0]}x{t[1]}-{a}"
         for E, k, cf, t, a in MOE_CASES])
def test_moe_apply_matches_jax(E, top_k, cf, tokens, act):
    """Groups of 16 tokens: 2 x 16 fills two groups, 3 x 7 leaves the
    second of two padded by 11 zero rows. A factor of 0.25 and 1.25
    drops pairs past capacity, ``E / top_k`` gives every expert a slot
    for every token of a group."""
    rng = np.random.default_rng(E * 100 + top_k * 10 + tokens[1])
    D, F = 32, 48
    gated = act == "silu-gated"
    p = _moe_params(rng, E, D, F, gated)
    x = _f32(rng, *tokens, D)
    factor = E / top_k if cf == "no-drop" else cf
    jout, jaux, out, aux = _both(
        p, x, top_k=top_k, activation="silu" if gated else "gelu",
        gated=gated, group_size=GROUP, capacity_factor=factor)
    assert out.shape == x.shape
    np.testing.assert_allclose(out, jout, rtol=EW_RTOL, atol=EW_ATOL)
    np.testing.assert_allclose(aux, jaux, rtol=EW_RTOL, atol=EW_ATOL)


def test_moe_apply_bf16_rounds_the_gates_to_bf16():
    """bf16 x and experts, the router fp32: the port's output within
    the bf16 tolerance of the JAX package's. With scaled identity
    experts (non-gated squared ReLU, w1 = I, expert e's w2 = (1 + e/8)
    I, x of small integers) each expert's output is (1 + e/8) x**2
    rounded to bf16, so the port's output must be, bitwise, the sum of
    those times each gate rounded to bf16, the sum in fp32 rounded once; the
    unrounded gates give other bits."""
    rng = np.random.default_rng(7)
    E, k, D = 8, 2, 16
    p = {"router": _f32(rng, D, E, scale=D ** -0.5),
         "w1": np.broadcast_to(np.eye(D, dtype=np.float32), (E, D, D)).copy(),
         "w2": np.eye(D, dtype=np.float32)
         * (1 + np.arange(E, dtype=np.float32) / 8)[:, None, None]}
    x = rng.integers(1, 9, (2, 16, D)).astype(np.float32)
    kw = dict(top_k=k, activation="relu2", gated=False, group_size=GROUP,
              capacity_factor=E / k)
    out, aux = moe_apply(
        {n: torch.from_numpy(v).to(torch.float32 if n == "router"
                                   else torch.bfloat16)
         for n, v in p.items()},
        torch.from_numpy(x).to(torch.bfloat16), **kw)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    jout, jaux = jmoe_apply(
        {n: jnp.asarray(v, jnp.float32 if n == "router" else jnp.bfloat16)
         for n, v in p.items()}, jnp.asarray(x, jnp.bfloat16), **kw)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=EW_RTOL)
    # the gates, as the router computes them in fp32
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, D))
                          @ torch.from_numpy(p["router"]), -1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    gates = top / top.sum(-1, keepdim=True)
    sq = torch.from_numpy(x.reshape(-1, D) ** 2)
    # each expert's output, (1 + e/8) x**2 rounded to bf16
    y = [((1 + idx[:, j:j + 1].float() / 8) * sq).to(torch.bfloat16).float()
         for j in range(k)]
    rounded = sum(gates[:, j:j + 1].to(torch.bfloat16).float() * y[j]
                  for j in range(k)).to(torch.bfloat16)
    unrounded = sum(gates[:, j:j + 1] * y[j]
                    for j in range(k)).to(torch.bfloat16)
    assert torch.equal(out.reshape(-1, D), rounded)
    assert not torch.equal(rounded, unrounded)


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_ties_pick_the_lower_experts_as_jax(top_k):
    """Zero tokens give equal router logits: ``lax.top_k`` takes the
    lowest expert indices. All-zero tokens: the aux is exactly the JAX
    package's (1.0). Zero tokens first in a group, then real ones, at a
    capacity the zero tokens fill: a real token that picks expert 0
    finds no slot left, in both packages alike; and 21 tokens in groups
    of 16 pad the last group with 11 zero rows, whose picks the aux
    counts."""
    rng = np.random.default_rng(11)
    E, D, F = 8, 32, 48
    p = _moe_params(rng, E, D, F, True)
    kw = dict(top_k=top_k, activation="silu", gated=True, group_size=GROUP)
    zeros = np.zeros((2, 16, D), np.float32)
    jout, jaux, out, aux = _both(p, zeros, capacity_factor=1.25, **kw)
    assert aux == jaux == 1.0
    assert not out.any() and not jout.any()
    mixed = _f32(rng, 1, 32, D)
    mixed[0, :12] = 0.0                  # 12 zero tokens, then 4 real ones
    jout, jaux, out, aux = _both(p, mixed, capacity_factor=1.0, **kw)
    np.testing.assert_allclose(out, jout, rtol=EW_RTOL, atol=EW_ATOL)
    np.testing.assert_allclose(aux, jaux, rtol=EW_RTOL, atol=EW_ATOL)
    padded = _f32(rng, 1, 21, D)         # groups of 16: 11 zero rows
    jout, jaux, out, aux = _both(p, padded, capacity_factor=1.25, **kw)
    np.testing.assert_allclose(out, jout, rtol=EW_RTOL, atol=EW_ATOL)
    np.testing.assert_allclose(aux, jaux, rtol=EW_RTOL, atol=EW_ATOL)
    # the pads' picks move the aux: the lowest experts, not others
    probs = torch.softmax(torch.from_numpy(padded[0])
                          @ torch.from_numpy(p["router"]), -1)
    counts = torch.zeros(E)
    for row in torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[:, :top_k]:
        counts[row] += 1
    mean_prob = torch.cat([probs, torch.full((11, E), 1 / E)]).mean(0)
    for pads_pick in (torch.arange(top_k), torch.arange(E - top_k, E)):
        c = counts.clone()
        c[pads_pick] += 11
        guess = float(E * torch.sum(c / 32 / top_k * mean_prob))
        assert (abs(guess - aux) < 1e-5) == (int(pads_pick[0]) == 0)


def test_dropped_tokens_keep_only_the_residual_in_both_packages():
    """top-1 routing at capacity factor 0.25 (one slot on each of 4
    experts for a group's 16 tokens): the tokens whose one pair
    is dropped get an output of exactly 0, the same tokens in both
    packages, and the kept ones agree."""
    rng = np.random.default_rng(5)
    E, D, F = 4, 32, 48
    p = _moe_params(rng, E, D, F, True)
    x = _f32(rng, 3, 16, D)
    jout, jaux, out, aux = _both(p, x, top_k=1, activation="silu",
                                 gated=True, group_size=GROUP,
                                 capacity_factor=0.25)
    dropped = ~out.reshape(-1, D).any(-1)
    jdropped = ~jout.reshape(-1, D).any(-1)
    np.testing.assert_array_equal(dropped, jdropped)
    # capacity max(1, int(16 * 1 * 0.25 / 4)) = 1: at most one token
    # an expert in each of the 3 groups
    assert 0 < (~dropped).sum() <= 3 * E
    np.testing.assert_allclose(out, jout, rtol=EW_RTOL, atol=EW_ATOL)
    np.testing.assert_allclose(aux, jaux, rtol=EW_RTOL, atol=EW_ATOL)


def test_moe_apply_chunks_groups_without_changing_the_result(monkeypatch):
    """The experts run a chunk of groups at a time (``_CHUNK_ELEMENTS``):
    one group a chunk gives the same output, bitwise, as all groups in
    one chunk."""
    from repro_torch.models import mlp

    rng = np.random.default_rng(9)
    p = {k: torch.from_numpy(v)
         for k, v in _moe_params(rng, 8, 32, 48, True).items()}
    x = torch.from_numpy(_f32(rng, 5, 13, 32))
    kw = dict(top_k=2, activation="silu", gated=True, group_size=GROUP,
              capacity_factor=1.25)
    whole, aux = moe_apply(p, x, **kw)
    monkeypatch.setattr(mlp, "_CHUNK_ELEMENTS", 1)
    chunked, aux1 = moe_apply(p, x, **kw)
    assert torch.equal(whole, chunked) and torch.equal(aux, aux1)


# ------------------------------------------------------------- configs --

def _cfgs(arch, **over):
    return reduced(get_config(arch), **over), \
        jreduced(jget_config(arch), **over)


def _noisy_jax_params(jcfg, seed):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax_config_full_and_reduced(arch):
    ours, theirs = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for over in ({}, dict(n_layers=3), dict(dtype="bfloat16")):
        assert dataclasses.asdict(reduced(ours, **over)) == \
            dataclasses.asdict(jreduced(theirs, **over))
    for prop in ("padded_vocab", "q_dim", "kv_dim", "supports_long_context"):
        assert getattr(ours, prop) == getattr(theirs, prop)
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()
    assert (ours.n_layers, ours.d_model, ours.n_heads, ours.n_kv_heads,
            ours.d_ff, ours.padded_vocab, ours.n_experts, ours.top_k,
            ours.window, ours.qk_norm, ours.rope_theta) == FULL[arch]
    assert ours.family == "moe" and ours.dtype == "bfloat16"
    assert (ours.moe_group_size, ours.moe_capacity_factor) == (512, 1.25)
    small = reduced(ours)
    assert (small.n_layers, small.d_model, small.n_experts, small.top_k,
            small.moe_group_size, small.moe_capacity_factor) == \
        (2, 256, 4, 2, 64, 2.0)


# ---------------------------------------------------------------- init --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_tree_matches_jax(arch, dtype):
    """The reduced config's drawn tree: the JAX init's keys, shapes and
    dtypes, ``moe`` in place of ``mlp``, the router float32 in either
    dtype, each expert drawn apart."""
    cfg, jcfg = _cfgs(arch, dtype=dtype)
    ours = tfm.init_lm(cfg, torch.Generator().manual_seed(0))
    assert _dtypes(ours) == _dtypes(jtfm.init_lm(jcfg,
                                                 jax.random.PRNGKey(0)))
    moe = ours["layers"]["moe"]
    assert "mlp" not in ours["layers"]
    assert sorted(moe) == ["router", "w1", "w2", "w3"]
    assert moe["router"].dtype == torch.float32
    assert moe["w1"].dtype == (torch.bfloat16 if dtype == "bfloat16"
                               else torch.float32)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert tuple(moe["w1"].shape) == (2, E, d, f)
    assert tuple(moe["w2"].shape) == (2, E, f, d)
    assert tuple(moe["router"].shape) == (2, d, E)
    assert not torch.equal(moe["w1"][0, 0], moe["w1"][0, 1])


@pytest.mark.parametrize("arch", ARCHS)
def test_full_tree_on_the_meta_device_is_the_jax_tree(arch):
    """The full config's tree, with no data: every key, shape and dtype
    of the JAX init's (``jax.eval_shape``), the router float32 beside
    bf16 experts; its size ``param_count()`` plus the QK norms."""
    cfg = get_config(arch)
    meta = tfm.init_lm(cfg, None)
    assert all(t.is_meta for t in tree_leaves(meta))
    want = jax.eval_shape(functools.partial(jtfm.init_lm, jget_config(arch)),
                          jax.random.PRNGKey(0))
    assert _dtypes(meta) == _dtypes(want)
    moe = meta["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert all(moe[k].dtype == torch.bfloat16 for k in ("w1", "w2", "w3"))
    n = sum(t.numel() for t in tree_leaves(meta))
    extra = 2 * cfg.n_layers * cfg.head_dim if cfg.qk_norm else 0
    assert n == cfg.param_count() + extra


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_params_from_numpy_keeps_the_router_fp32(arch):
    """A bf16 JAX tree (ml_dtypes leaves, the router float32) reaches
    the port leaf for leaf in ``init_lm``'s dtypes: the router float32
    with its values, the experts bf16 with theirs."""
    cfg, jcfg = _cfgs(arch, dtype="bfloat16")
    noisy = _noisy_jax_params(_cfgs(arch)[1], seed=3)
    jtree = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "router" in jax.tree_util.keystr(path)
        else a.astype(ml_dtypes.bfloat16), noisy)
    tparams = zoo_params_from_numpy(cfg, jtree, device="cpu")
    assert _dtypes(tparams) == _dtypes(tfm.init_lm(cfg, None))
    assert _dtypes(tparams) == _dtypes(jtfm.init_lm(jcfg,
                                                    jax.random.PRNGKey(0)))
    moe = tparams["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w1"].dtype == moe["w2"].dtype == torch.bfloat16
    flat = jax.tree_util.tree_leaves_with_path(jtree)
    got = tree_leaves(tparams)
    assert len(flat) == len(got)
    for (path, a), t in zip(flat, got):
        want = torch.from_numpy(np.asarray(a, np.float32)).to(t.dtype)
        assert torch.equal(t, want), jax.tree_util.keystr(path)


# ------------------------------------------------------------- forward --

@pytest.mark.parametrize("cf", ["reduced", 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_jax_logits_and_aux(arch, cf):
    """Logits and the aux summed over the layers, at the reduced
    config's no-drop factor and at 0.5 (pairs dropped), 3 x 21 tokens
    in groups of 64 (the last group padded)."""
    over = {} if cf == "reduced" else {"moe_capacity_factor": cf}
    cfg, jcfg = _cfgs(arch, **over)
    params = _noisy_jax_params(jcfg, seed=len(arch))
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, (3, 21)).astype(np.int32)
    want, jaux = jtfm.lm_forward(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(tokens))
    tparams = zoo_params_from_numpy(cfg, params, device="cpu")
    got, aux = build_model(cfg).forward(tparams, torch.from_numpy(tokens))
    assert got.shape == (3, 21, cfg.padded_vocab)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL,
                               atol=ATOL)
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


def test_predict_matches_jax(pair):
    _, ref, ours = pair
    for key in ("xi", "scale", "tail_at_xi"):
        np.testing.assert_allclose(ours.tail[key], ref.tail[key],
                                   rtol=RTOL, atol=ATOL)
    toks = synthetic_token_batch(8, 32, 1024, seed=2)
    tok_j, p_j = ref.predict(toks)
    tok, p = ours.predict(toks)
    np.testing.assert_array_equal(tok, tok_j)
    np.testing.assert_allclose(p, p_j, rtol=RTOL, atol=ATOL)


def test_engine_burst_equals_direct_predict(pair):
    """16 requests through ``ServingEngine`` at ``max_batch`` 8: two
    flushes, each answer the forecaster's own on the same batch (an MoE
    row's answer depends on its batch-mates through capacity, so the
    comparison is batch for batch); no kernel launched on the CPU."""
    arch, _, fc = pair
    registry = ModelRegistry()
    registry.register(arch, fc)
    toks = synthetic_token_batch(16, 32, fc.cfg.vocab, seed=3)
    before = attn_kernel.FLASH_LAUNCHES.total
    cfg = BatcherConfig(max_batch=8, max_wait_ms=60_000.0,
                        length_buckets=(32,))
    with ServingEngine(registry, cfg) as engine:
        futs = [engine.submit(arch, toks[i], client_id=f"c{i}")
                for i in range(16)]
        got = [f.result(timeout=120) for f in futs]
        snap = engine.telemetry.snapshot()
    assert snap["requests"] == 16 and snap["batches"] == 2
    assert attn_kernel.FLASH_LAUNCHES.total == before
    for half in (slice(0, 8), slice(8, 16)):
        tok, p = fc.predict(toks[half])
        assert got[half] == [(float(a), float(b)) for a, b in zip(tok, p)]


@pytest.mark.parametrize("arch", ARCHS)
def test_build_zoo_forecaster_serves_the_reduced_config_on_the_cpu(arch):
    fc = build_zoo_forecaster(arch, seed=0, device="cpu")
    assert fc.cfg == reduced(get_config(arch)) and fc.tail is not None
    toks = synthetic_token_batch(4, 32, fc.cfg.vocab, seed=9)
    tok, p = fc.predict(toks)
    again = build_zoo_forecaster(arch, seed=0, device="cpu").predict(toks)
    np.testing.assert_array_equal(tok, again[0])
    np.testing.assert_array_equal(p, again[1])
    assert np.all((tok >= 0) & (tok < fc.cfg.vocab)) and np.all(
        np.isfinite(p))


def test_serve_cli_hosts_mixtral_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--model",
         "mixtral-8x7b", "--device", "cpu", "--requests", "16",
         "--max-batch", "8", "--prompt-len", "20"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "hosting 'mixtral-8x7b' on cpu" in out.stdout
    assert "16 req in" in out.stdout
