"""The port's zoo decode path against the JAX package's, with the same
weights on both sides: ``init_cache``'s tree, ``lm_prefill``'s logits
and every cache leaf, ``lm_decode_step`` for 12 steps (from the JAX
package's own prefill cache and from an empty cache) with
``flush_recent`` at the reduced ``decode_buffer`` of 8, and, in the
port alone, decode against ``lm_forward``; ``decode_attention``; the
clamping ``dynamic_update_slice_in_dim``; ``zoo_cache_from_numpy``.

Four cache layouts: the reduced Qwen1.5-4B (dense, full mode: a main
cache and 8 recent slots), the same with ``window`` 8 on both sides
(ring mode: slot = pos % 8), the reduced Mamba2-370M (ssm: conv and
state per layer) and the reduced Zamba2-2.7B (hybrid: both), the last
also at 6 layers, every 3 (two stages, where the per-stage attention
cache shows). Every one of those attention caches is MHA; the reduced
Granite-20B (MQA: 4 query heads over one KV head), Qwen2.5-32B (GQA
4/2, QKV bias), Nemotron-4-15B (GQA 4/2, LayerNorm, non-gated squared
ReLU) and Chameleon-34B (the ``vlm`` family, GQA 4/2 with QK norm) add
full-mode caches of ``Hkv`` < ``Hq`` and the grouped decode
attention. The MoE family runs the dense branch with ``moe_apply``
in place of the MLP: the reduced Qwen3-MoE-235B-A22B (GQA 4/2, QK norm,
a full-mode cache) and Mixtral-8x7B with ``window`` 8 (a ring), both at
the reduced configs' capacity factor, ``n_experts / top_k``, where no
pair is dropped; and, in the decode from the JAX package's cache only,
Mixtral at 0.5 (``moe-drop``), where a step's group is its batch and
both packages drop the same pairs. The audio family: the reduced
Whisper-medium (``audio``: 2 encoder and 2 decoder layers over 16
frames from ``synthetic_embedding_batch``, MHA 4/4, LayerNorm, QKV
bias), whose cache adds each decoder layer's cross k and v, ``xk`` and
``xv``, beside a full-mode attention cache, and whose steps attend them
with ``blocked_attention`` at one query. A ring prompt of 16 tokens
fills the ring exactly (S % W == 0), one of 13 leaves it rolled by 5.

A JAX prefill cache's main holds the prompt only: decoding past it, the
JAX test grows main first (``place``, ``tests/test_arch_smoke.py``), as
the ``grown`` cases do here; the ``as-prefilled`` cases do not, so that
a flush lands past main's end and is clamped, on both sides alike.

The JAX init sets biases (LayerNorm's ``b`` among them), ``conv_b``,
``dt_bias`` and ``A_log`` to 0 and ``D`` and the norm weights (QK
norm's among them) to 1: the tests add numpy noise to those
leaves first. Tolerances (ROADMAP): the logits and the attention and
conv leaves at attention's fp32 rtol 2e-4 / atol 2e-5; the SSM state at
SSD's rtol 1e-4 / atol 1e-5; decode against the forward in the port at
the JAX test's bound, max |got - want| / max |want| < 0.05 a step, and
in fp32 also at 1e-4 of it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import attention as jattention
from repro.models import transformer as jtfm
from repro_torch.checkpoint.convert import (zoo_cache_from_numpy,
                                            zoo_params_from_numpy)
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.tokens import synthetic_embedding_batch
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import decode_attention
from repro_torch.models.model_zoo import build_model
from repro_torch.tree import tree_map

RTOL, ATOL = 2e-4, 2e-5             # attention, fp32
SSD_RTOL, SSD_ATOL = 1e-4, 1e-5
FORWARD_BOUND = 0.05                # tests/test_arch_smoke.py, a step
FORWARD_FP32 = 1e-4
STEPS = 12
# the leaves the JAX init sets to a constant, and the noise put on them
NOISE = {"A_log": 0.5, "dt_bias": 0.5, "conv_b": 0.2, "D": 0.2,
         "norm_w": 0.2, "w": 0.2, "b": 0.2, "bq": 0.2, "bk": 0.2,
         "bv": 0.2, "q_norm": 0.2, "k_norm": 0.2}
# layout -> (arch, config overrides)
LAYOUTS = {"dense-full": ("qwen1.5-4b", {}),
           "dense-ring": ("qwen1.5-4b", {"window": 8}),
           "ssm": ("mamba2-370m", {}),
           "hybrid": ("zamba2-2.7b", {}),
           "hybrid-6-every-3": ("zamba2-2.7b", dict(n_layers=6,
                                                    attn_every=3)),
           "dense-mqa": ("granite-20b", {}),
           "dense-gqa": ("qwen2.5-32b", {}),
           "dense-layernorm-relu2": ("nemotron-4-15b", {}),
           "vlm": ("chameleon-34b", {}),
           "moe": ("qwen3-moe-235b-a22b", {}),
           "moe-ring": ("mixtral-8x7b", {"window": 8}),
           "moe-drop": ("mixtral-8x7b", {"moe_capacity_factor": 0.5}),
           "audio": ("whisper-medium", {})}
FOUR = ["dense-full", "dense-ring", "ssm", "hybrid"]
# the dense-branch archs whose KV heads are fewer than their query heads
GROUPED = ["dense-mqa", "dense-gqa", "dense-layernorm-relu2", "vlm"]
# the MoE family at the reduced configs' no-drop capacity factor
MOE = ["moe", "moe-ring"]
RING = ("dense-ring", "moe-ring")
AUDIO = ["audio"]


def _cfgs(layout, dtype=None):
    arch, over = LAYOUTS[layout]
    over = dict(over, **({"dtype": dtype} if dtype else {}))
    window = over.pop("window", None)
    cfg, jcfg = reduced(get_config(arch), **over), \
        jreduced(jget_config(arch), **over)
    if window is not None:
        cfg = dataclasses.replace(cfg, window=window)
        jcfg = dataclasses.replace(jcfg, window=window)
    return cfg, jcfg


def _models(layout, seed=0):
    """(cfg, jcfg, port params, JAX params): the JAX init with noise on
    every constant leaf, in fp32, and the same weights in the port."""
    cfg, jcfg = _cfgs(layout)
    rng = np.random.default_rng(seed)

    def noise(path, a):
        a = np.asarray(a.astype(jnp.float32))
        name = jax.tree_util.keystr(path).rsplit("'", 2)[-2]
        if name in NOISE:
            a = a + NOISE[name] * rng.standard_normal(a.shape)
        return a.astype(np.float32)

    jp = jax.tree_util.tree_map_with_path(
        noise, jtfm.init_lm(jcfg, jax.random.PRNGKey(seed)))
    return cfg, jcfg, zoo_params_from_numpy(cfg, jp, "cpu"), \
        jax.tree.map(jnp.asarray, jp)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(100 + seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _t(toks):
    return torch.as_tensor(toks, dtype=torch.long)


def _frames(cfg, B, seed=0):
    """An audio arch's frame embeddings [B, n_frames, d] as numpy (None
    for the other families): the same on both sides."""
    if cfg.family != "audio":
        return None
    return synthetic_embedding_batch(B, cfg.n_frames, cfg.d_model,
                                     seed=200 + seed)


def _jf(frames):
    return None if frames is None else jnp.asarray(frames)


def _tf(frames):
    return None if frames is None else torch.from_numpy(frames)


def _tree(tree):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


def _close_cache(got, want, where):
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        assert tuple(g.shape) == w.shape, (where, k)
        if k in ("len", "flushed"):
            assert g.dtype == torch.int32 and int(g) == int(w), (where, k)
            continue
        rtol, atol = (SSD_RTOL, SSD_ATOL) if k == "ssm" else (RTOL, ATOL)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol,
                                   err_msg=f"{where}: {k}")


def _close_logits(got, want, where):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=where)


def _place(cache, full):
    """The JAX test's ``place``: each prefill leaf copied into a longer
    empty cache's (main grown along its sequence dim)."""
    out = dict(full)
    for k, src in cache.items():
        dst = full[k]
        if dst.shape == src.shape:
            out[k] = src.to(dst.dtype)
        elif dst.dim() == src.dim() and dst.shape[2] != src.shape[2]:
            out[k] = dst.clone()
            out[k][:, :, :src.shape[2]] = src
        else:
            out[k] = src
    return out


def _jplace(cache, full):
    def place(dst, src):
        if dst.shape == src.shape:
            return src.astype(dst.dtype)
        if dst.ndim == src.ndim and dst.shape[2] != src.shape[2]:
            return dst.at[:, :, :src.shape[2]].set(src)
        return src
    return jax.tree.map(place, full, cache)


def _needs_flush(cache, cfg):
    return "kr" in cache and int(cache["len"] - cache["flushed"]) >= \
        cfg.decode_buffer


# ---------------------------------------------------------- init_cache --

@pytest.mark.parametrize("layout",
                         FOUR + ["hybrid-6-every-3"] + GROUPED + MOE + AUDIO)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_tree_matches_jax(layout, dtype):
    """Keys, shapes and dtypes leaf by leaf against ``jax.eval_shape``
    of the JAX package's ``init_cache``; every leaf zero, the counters
    0-d int32."""
    cfg, jcfg = _cfgs(layout, dtype)
    ours = tfm.init_cache(cfg, 2, 24, device="cpu")
    want = jax.eval_shape(lambda: jtfm.init_cache(jcfg, 2, 24))
    assert _tree(ours) == _tree(want)
    assert all(not torch.any(t != 0) for t in ours.values())
    ring = layout in RING
    assert ("kr" in ours) == (layout not in ("ssm",) and not ring)
    if ring:
        assert ours["k"].shape[2] == 8
    if layout in GROUPED:
        Hkv = 1 if layout == "dense-mqa" else 2
        assert cfg.n_heads == 4 and ours["k"].shape[3] == Hkv
        assert ours["kr"].shape == (2, 2, cfg.decode_buffer, Hkv, 64)
    assert ("xk" in ours) == ("xv" in ours) == (layout in AUDIO)
    if layout in AUDIO:
        assert ours["xk"].shape == (2, 2, cfg.n_frames, 4, 64)


def test_init_cache_on_the_model_handle_and_the_meta_device():
    cfg, _ = _cfgs("hybrid")
    model = build_model(cfg)
    cache = model.init_cache(1, 16, device="cpu")
    assert _tree(cache) == _tree(tfm.init_cache(cfg, 1, 16, device="cpu"))
    meta = tfm.init_cache(cfg, 1, 16, device="meta")
    assert _tree(meta) == _tree(cache)


# ------------------------------------------------------------- prefill --

@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("layout",
                         FOUR + ["hybrid-6-every-3"] + GROUPED + MOE + AUDIO)
def test_prefill_matches_jax(layout, S):
    """Last-token logits and every cache leaf (the ring rolled at
    S % W != 0 and not at S % W == 0; the audio cross k, v)."""
    cfg, jcfg, params, jparams = _models(layout)
    toks = _tokens(cfg, 2, S)
    frames = _frames(cfg, 2)
    want_logits, want = jtfm.lm_prefill(jcfg, jparams, jnp.asarray(toks),
                                        _jf(frames))
    logits, cache = build_model(cfg).prefill(params, _t(toks), _tf(frames))
    assert logits.shape == (2, cfg.padded_vocab)
    _close_logits(logits, want_logits, f"{layout} S {S}")
    _close_cache(cache, want, f"{layout} S {S}")
    if layout in RING:
        assert cache["k"].shape[2] == 8 and "kr" not in cache


def test_prefill_ring_places_position_p_at_slot_p_mod_w():
    """A ring prefill's slot p % W holds position p's key and value, for
    the last W positions, at S % W == 0 and != 0: held on the first
    layer, whose k and v do not depend on the window, against the
    full-mode prefill of the same tokens."""
    cfg, _, params, _ = _models("dense-ring")
    full_cfg = dataclasses.replace(cfg, window=None)
    for S in (16, 13):
        toks = _t(_tokens(cfg, 2, S))
        _, ring = tfm.lm_prefill(cfg, params, toks)
        _, full = tfm.lm_prefill(full_cfg, params, toks)
        for p in range(S - 8, S):
            for name in ("k", "v"):
                assert torch.equal(ring[name][0, :, p % 8],
                                   full[name][0, :, p]), (S, p, name)


# -------------------------------------------------------------- decode --

def _decode_both(cfg, jcfg, params, jparams, cache, jcache, steps=STEPS,
                 where=""):
    """``steps`` teacher-forced decode steps on both sides, flushing
    whenever len - flushed reaches decode_buffer; logits and every
    cache leaf compared at every step. Returns how many flushes ran."""
    batch = next(v.shape[1] for v in cache.values() if v.dim() > 1)
    toks = _tokens(cfg, batch, steps, seed=7)
    jstep = jax.jit(lambda p, tok, c: jtfm.lm_decode_step(jcfg, p, tok, c))
    flushes = 0
    for t in range(steps):
        want_logits, jcache = jstep(jparams, jnp.asarray(toks[:, t]), jcache)
        logits, cache = tfm.lm_decode_step(cfg, params, _t(toks[:, t]),
                                           cache)
        _close_logits(logits, want_logits, f"{where} step {t}")
        _close_cache(cache, jcache, f"{where} step {t}")
        if _needs_flush(jcache, jcfg):
            assert _needs_flush(cache, cfg)
            jcache = jtfm.flush_recent(jcfg, jcache)
            cache = tfm.flush_recent(cfg, cache)
            _close_cache(cache, jcache, f"{where} flush after step {t}")
            flushes += 1
    return flushes


DECODE_CASES = [(layout, "grown")
                for layout in FOUR + ["hybrid-6-every-3"] + GROUPED + MOE
                + ["moe-drop"] + AUDIO] \
    + [("dense-full", "as-prefilled"), ("hybrid", "as-prefilled")]


@pytest.mark.parametrize("layout,main", DECODE_CASES,
                         ids=[f"{a}-{b}" for a, b in DECODE_CASES])
def test_decode_from_the_jax_prefill_cache_matches_jax(layout, main):
    """12 steps from the JAX package's own prefill cache (13 tokens;
    through ``zoo_cache_from_numpy``), against the JAX package's 12
    steps from the same cache."""
    cfg, jcfg, params, jparams = _models(layout)
    S = 13
    _, jcache = jtfm.lm_prefill(jcfg, jparams, jnp.asarray(_tokens(cfg, 2,
                                                                   S)),
                                _jf(_frames(cfg, 2)))
    if main == "grown":
        jcache = _jplace(jcache, jtfm.init_cache(jcfg, 2, S + STEPS))
    cache = zoo_cache_from_numpy(cfg, jax.tree.map(np.asarray, jcache),
                                 "cpu")
    _close_cache(cache, jcache, "converted")
    flushes = _decode_both(cfg, jcfg, params, jparams, cache, jcache,
                           where=f"{layout} {main}")
    assert flushes == (1 if "kr" in jcache else 0)


@pytest.mark.parametrize("layout", FOUR)
def test_decode_from_an_empty_cache_matches_jax(layout):
    """12 steps from ``init_cache`` (main's valid length 0; the ring
    filling from slot 0) on both sides."""
    cfg, jcfg, params, jparams = _models(layout)
    cache = tfm.init_cache(cfg, 2, STEPS, device="cpu")
    jcache = jtfm.init_cache(jcfg, 2, STEPS)
    flushes = _decode_both(cfg, jcfg, params, jparams, cache, jcache,
                           where=f"{layout} empty")
    assert flushes == (1 if "kr" in jcache else 0)


@pytest.mark.parametrize("layout",
                         FOUR + ["hybrid-6-every-3"] + GROUPED + MOE + AUDIO)
def test_decode_equals_forward(layout):
    """The port alone, as ``test_prefill_decode_matches_forward``: a
    prefill of 16 of 28 tokens, then 12 teacher-forced steps (full mode:
    main grown first, a flush every 8 tokens) give the forward's logits
    at the same positions."""
    cfg, _, params, _ = _models(layout)
    model = build_model(cfg)
    S, prompt = 28, 16
    toks = _t(_tokens(cfg, 2, S, seed=3))
    frames = _tf(_frames(cfg, 2, seed=3))
    want_all, _ = model.forward(params, toks, frames)
    lp, cache = model.prefill(params, toks[:, :prompt], frames)
    torch.testing.assert_close(lp, want_all[:, prompt - 1], rtol=RTOL,
                               atol=ATOL)
    cache = _place(cache, model.init_cache(2, S, device="cpu"))
    flushes = 0
    for t in range(prompt, S):
        lg, cache = model.decode_step(params, toks[:, t], cache)
        want = want_all[:, t]
        rel = float((lg - want).abs().max() / (want.abs().max() + 1e-9))
        assert rel < FORWARD_BOUND and rel < FORWARD_FP32, (layout, t, rel)
        if _needs_flush(cache, cfg):
            cache = tfm.flush_recent(cfg, cache)
            flushes += 1
    assert flushes == (1 if "kr" in cache else 0)
    assert int(cache["len"]) == S


def test_decode_and_prefill_launch_no_kernel_on_the_cpu(monkeypatch):
    """On CPU tensors the prefill runs the plain versions of flash and
    SSD and the decode step runs plain torch alone."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel launched on the CPU route")

    monkeypatch.setattr(attn_kernel, "flash_attention_cuda", refuse)
    monkeypatch.setattr(ssd_kernel, "ssd_scan_cuda", refuse)
    cfg, _, params, _ = _models("hybrid")
    model = build_model(cfg)
    toks = _t(_tokens(cfg, 2, 9))
    _, cache = model.prefill(params, toks[:, :8])
    logits, cache = model.decode_step(params, toks[:, 8], cache)
    assert torch.all(torch.isfinite(logits)) and int(cache["len"]) == 9


def test_bf16_decode_runs_in_the_configs_dtypes():
    """A bf16 config's prefill and decode keep the cache in the init's
    dtypes (the SSM state float32, the counters int32) and give finite
    logits near the fp32 model's."""
    cfg, _ = _cfgs("hybrid", "bfloat16")
    cfg32, _, params32, _ = _models("hybrid")
    params = zoo_params_from_numpy(cfg, tree_map(lambda t: t.numpy(),
                                                 params32), "cpu")
    toks = _t(_tokens(cfg, 2, 12))
    _, cache = tfm.lm_prefill(cfg, params, toks[:, :8])
    _, cache32 = tfm.lm_prefill(cfg32, params32, toks[:, :8])
    assert _tree(cache) == _tree(tfm.init_cache(cfg, 2, 8, device="cpu"))
    for t in range(8, 12):
        lg, cache = tfm.lm_decode_step(cfg, params, toks[:, t], cache)
        lg32, cache32 = tfm.lm_decode_step(cfg32, params32, toks[:, t],
                                           cache32)
        assert lg.dtype == torch.bfloat16
        rel = float((lg.float() - lg32).abs().max() / lg32.abs().max())
        assert rel < FORWARD_BOUND, (t, rel)


# ---------------------------------------------------- decode attention --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens", [(0, 5), (7, 3), (9, 0)],
                         ids=["main-empty", "both", "recent-empty"])
def test_decode_attention_matches_jax(lens, dtype):
    """GQA (8 query heads over 2 KV heads), two sources under one max and
    one denominator, either of them empty (valid length 0). bf16: k, v
    in bf16, products in fp32, p rounded to bf16 on both sides; held at
    one bf16 step (rtol 1e-2, atol 1e-3)."""
    rng = np.random.default_rng(sum(lens))
    B, Hq, Hkv, D = 2, 8, 2, 16

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q = draw(B, 1, Hq, D)
    k1, v1 = draw(B, 9, Hkv, D), draw(B, 9, Hkv, D)
    k2, v2 = draw(B, 4, Hkv, D), draw(B, 4, Hkv, D)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    want = jattention.decode_attention(
        jnp.asarray(q, jdt),
        [(jnp.asarray(k1, jdt), jnp.asarray(v1, jdt), jnp.int32(lens[0])),
         (jnp.asarray(k2, jdt), jnp.asarray(v2, jdt),
          jnp.int32(min(lens[1], 4)))])
    got = decode_attention(
        torch.from_numpy(q).to(tdt),
        [(torch.from_numpy(k1).to(tdt), torch.from_numpy(v1).to(tdt),
          torch.tensor(lens[0], dtype=torch.int32)),
         (torch.from_numpy(k2).to(tdt), torch.from_numpy(v2).to(tdt),
          min(lens[1], 4))])
    assert got.shape == (B, 1, Hq, D) and got.dtype == tdt
    rtol, atol = (RTOL, ATOL) if dtype == "float32" else (1e-2, 1e-3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


# --------------------------------------------- dynamic_update_slice --

@pytest.mark.parametrize("start", [0, 3, 5, 6, -2],
                         ids=["first", "in-range", "last-fit",
                              "one-past-the-end", "negative"])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_dynamic_update_slice_clamps_as_jax(start, as_tensor):
    """A [2, 6, 3] operand, a 1-row update along dim 1 and a 2-row one
    along dim 1, at starts in range, at the last start that fits, one
    past the end and negative: JAX clamps the start so that the update
    fits, and so does the port."""
    rng = np.random.default_rng(start + 10)
    base = rng.standard_normal((2, 6, 3)).astype(np.float32)
    for n in (1, 2):
        upd = rng.standard_normal((2, n, 3)).astype(np.float32)
        want = jax.lax.dynamic_update_slice_in_dim(
            jnp.asarray(base), jnp.asarray(upd), start, axis=1)
        operand = torch.from_numpy(base.copy())
        s = torch.tensor(start, dtype=torch.int32) if as_tensor else start
        got = tfm.dynamic_update_slice_in_dim(operand, torch.from_numpy(upd),
                                              s, 1)
        assert got is operand                  # written in place
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flush_into_a_main_cache_no_longer_than_the_prompt_is_clamped():
    """``flush_recent`` into a main cache the size of the prompt writes
    the recent slots at size - R (over valid keys), as the JAX package
    does: grow main first (``test_decode_equals_forward``)."""
    cfg, _, params, _ = _models("dense-full")
    toks = _t(_tokens(cfg, 2, 17))
    _, cache = tfm.lm_prefill(cfg, params, toks[:, :9])
    main_before = cache["k"].clone()
    for t in range(9, 17):
        _, cache = tfm.lm_decode_step(cfg, params, toks[:, t], cache)
    kr = cache["kr"].clone()
    cache = tfm.flush_recent(cfg, cache)
    R = cfg.decode_buffer
    assert torch.equal(cache["k"][:, :, 9 - R:], kr)
    assert torch.equal(cache["k"][:, :, :9 - R], main_before[:, :, :9 - R])
    assert int(cache["flushed"]) == 17


# --------------------------------------------------------- conversion --

def test_zoo_cache_from_numpy_casts_to_the_ports_cache_dtypes():
    """A JAX bf16 cache (ml_dtypes leaves) arrives in the port's
    ``init_cache`` dtypes: counters int32, SSM state float32, the rest
    bf16, the values widened exactly."""
    cfg, jcfg = _cfgs("hybrid", "bfloat16")
    jcache = jtfm.init_cache(jcfg, 2, 24)
    jcache["k"] = jcache["k"] + jnp.asarray(
        np.random.default_rng(0).standard_normal(jcache["k"].shape),
        jnp.bfloat16)
    cache = zoo_cache_from_numpy(cfg, jax.tree.map(np.asarray, jcache),
                                 "cpu")
    assert _tree(cache) == _tree(tfm.init_cache(cfg, 2, 24, device="cpu"))
    np.testing.assert_array_equal(
        cache["k"].float().numpy(),
        np.asarray(jcache["k"].astype(jnp.float32)))
