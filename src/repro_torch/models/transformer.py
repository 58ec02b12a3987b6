"""Transformer zoo (``repro.models.transformer``): the decoder LM of the
``dense`` family (and of the ``vlm`` family, Chameleon's early-fusion
decoder, whose image tokens are ids of the one vocabulary: it runs the
dense path throughout, as in the JAX package; and of the ``moe``
family, the same decoder with a Mixture-of-Experts layer, ``moe_apply``,
in place of each MLP), the Mamba2 stack of the ``ssm`` family, the
Zamba2 stack of the ``hybrid`` family (Mamba2 layers with one shared
attention + MLP block after every ``attn_every`` of them) and the
Whisper encoder-decoder of the ``audio`` family, their init, their
forward and their decode path.

    params = init_lm(cfg, generator)                 # leaves on its device
    logits, aux = lm_forward(cfg, params, tokens)    # serve (predict)
                                                     # aux: MoE's loss
    logits, cache = lm_prefill(cfg, params, tokens)  # prefill
    logits, cache = lm_decode_step(cfg, params, token, cache)  # decode
    cache = flush_recent(cfg, cache)                 # every decode_buffer

The audio family takes ``frames`` [B, n_frames, d_model] beside the
tokens in ``lm_forward`` and ``lm_prefill`` (the stubbed frontend's
output, as in the JAX package). Its encoder attends over the frames
with no mask and with the learned ``enc_pos`` table, no RoPE; its
decoder layers run causal self-attention with RoPE (the JAX package's
deviation from Whisper's learned decoder positions, kept), then
cross-attention over the encoder output's per-layer k and v, then the
MLP. So a forward or a prefill makes 3 flash launches a decoder layer
pair: the encoder's, the decoder's causal one and the cross one. The
decode cache keeps each layer's cross k and v (``xk``, ``xv``) beside
the self-attention buffers, and a decode step attends over them with
``blocked_attention`` at one query, as the JAX package does: on the
card that is one flash launch a layer a step, where the other
families' steps launch no kernel.

Layers are stacked on a leading [L, ...] dim, as in the JAX package, so
its params map onto these one to one (``checkpoint.convert``); the
forward walks the stack in a Python loop where the JAX package scans,
taking each leaf's layers once by ``torch.unbind`` (``_unstack``). The
JAX package's ``pshard.constrain`` sharding hints have no single-GPU
counterpart and are dropped. Its ``jax.checkpoint`` rematerialization
(``cfg.remat``, ``_maybe_remat``) is ``torch.utils.checkpoint``'s
non-reentrant form around the same blocks: a layer (the hybrid: a
stage), recomputed in the backward; a forward under no_grad runs the
blocks as they are.

The caches are the JAX package's, leaf for leaf: ``len`` (and, in full
mode, ``flushed``) 0-d int32 tensors on the cache's device, attention
k/v stacked per attention layer, the SSM's conv and state per layer. A
decode step and ``flush_recent`` write the cache's buffers in place,
as XLA's dynamic-update-slice does on a donated buffer: decode from the
cache they return, never again from the one passed in.

An MoE layer's answer for a token depends on the other tokens of its
group, through each expert's capacity, in both packages: the prefill
and a decode step route in groups of their own tokens, so where the
forward drops a pair a decode step may keep it, and the other way
round. At a capacity factor of ``n_experts / top_k`` (the reduced
configs') no pair is ever dropped and they agree.

``lm_loss`` is the training loss, next-token cross entropy in fp32
plus ``aux_weight`` times the MoE aux. On the card its gradient runs
through the flash kernel's backward; the ``ssm`` and ``hybrid``
families' would need the SSD scan's, which is not ported, so their
forward raises ``NotImplementedError`` on the card where autograd
records a parameter (``_check_trainable``); on the CPU they
differentiate.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint as torch_checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd.ops import BACKWARD_ITEM as SSD_BACKWARD_ITEM
from repro_torch.models.attention import blocked_attention, decode_attention
from repro_torch.models.layers import (apply_norm, apply_rope, dense_init,
                                       embed_init, init_device, norm_param,
                                       rms_norm)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.mlp import mlp_apply, moe_apply
from repro_torch.models.ssm import mamba2_apply
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

# the families the port runs: every family of the JAX package (``vlm``
# and ``moe`` through the dense decoder)
_PORTED = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP, Next: "
                               f"{item})")


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in _PORTED:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"zoo has {_PORTED}")


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ==========================================================================
# Parameter construction
# ==========================================================================

def _init_attn(g, cfg: ArchConfig, dt):
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    dev = init_device(g)
    p = {
        "wq": dense_init(g, (d, H * hd), dt, dev),
        "wk": dense_init(g, (d, Hkv * hd), dt, dev),
        "wv": dense_init(g, (d, Hkv * hd), dt, dev),
        "wo": dense_init(g, (H * hd, d), dt, dev, scale=1.0),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((Hkv * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((Hkv * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def _init_mlp(g, cfg: ArchConfig, dt):
    d, f, dev = cfg.d_model, cfg.d_ff, init_device(g)
    p = {"w1": dense_init(g, (d, f), dt, dev),
         "w2": dense_init(g, (f, d), dt, dev)}
    if cfg.gated_mlp:
        p["w3"] = dense_init(g, (d, f), dt, dev)
    return p


def _init_moe(g, cfg: ArchConfig, dt):
    """The router in float32 whatever the model's dtype, as in the JAX
    package; the experts stacked on a leading [E] dim."""
    d, f, E, dev = cfg.d_model, cfg.d_ff, cfg.n_experts, init_device(g)
    p = {"router": dense_init(g, (d, E), torch.float32, dev),
         "w1": dense_init(g, (E, d, f), dt, dev),
         "w2": dense_init(g, (E, f, d), dt, dev)}
    if cfg.gated_mlp:
        p["w3"] = dense_init(g, (E, d, f), dt, dev)
    return p


def _init_ssm_block(g, cfg: ArchConfig, dt):
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N
    dev = init_device(g)
    return {
        "in_proj": dense_init(g, (d, 2 * di + 2 * N + H), dt, dev),
        "conv_w": dense_init(g, (conv_dim, cfg.ssm_conv), dt, dev,
                             scale=1.0),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),  # A = -1
        "D": torch.ones((H,), dtype=dt, device=dev),
        "norm_w": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": dense_init(g, (di, d), dt, dev, scale=1.0),
    }


def _init_decoder_layer(g, cfg: ArchConfig, dt, cross: bool = False):
    """A decoder layer; with ``cross`` (the audio decoder) also the
    cross-attention's norm and projections, drawn after the MLP, as in
    the JAX package."""
    dev = init_device(g)
    p = {"norm1": norm_param(cfg.norm, cfg.d_model, dt, dev),
         "attn": _init_attn(g, cfg, dt),
         "norm2": norm_param(cfg.norm, cfg.d_model, dt, dev)}
    if cfg.n_experts:
        p["moe"] = _init_moe(g, cfg, dt)
    else:
        p["mlp"] = _init_mlp(g, cfg, dt)
    if cross:
        p["norm_x"] = norm_param(cfg.norm, cfg.d_model, dt, dev)
        p["xattn"] = _init_attn(g, cfg, dt)
    return p


def _stack(fn, n: int):
    """``n`` draws of a param subtree stacked on a leading dim, written
    layer by layer into the stacked leaves: one drawn layer is held at a
    time beside them."""
    layer = fn()
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), layer)
    for i in range(n):
        if i:
            layer = fn()
        tree_map(lambda dst, src: dst[i].copy_(src), out, layer)
        layer = None
    return out


def init_lm(cfg: ArchConfig, generator: torch.Generator | None) -> PyTree:
    """Random params of a dense or MoE decoder LM, a Mamba2 stack, a
    Zamba2 stack (the Mamba2 layers, and one ``shared`` attention + MLP
    block) or the Whisper encoder-decoder (``enc_pos`` [n_frames, d],
    the ``enc_layers`` stack, and decoder ``layers`` with cross blocks),
    in the config's dtype (``dt_bias``, ``A_log`` and the MoE
    ``router`` in float32, as in the JAX package), drawn from
    ``generator`` on its own device (a CUDA generator draws on the card,
    each leaf in fp32 and cast, one layer at a time). With no generator
    the leaves lie on the meta device: the tree's keys, shapes and
    dtypes, with no data."""
    _require_ported(cfg)
    dt = _dtype(cfg)
    V, d = cfg.padded_vocab, cfg.d_model
    dev = init_device(generator)

    def layer():
        if cfg.family in ("ssm", "hybrid"):
            return {"norm1": norm_param(cfg.norm, d, dt, dev),
                    "ssm": _init_ssm_block(generator, cfg, dt)}
        return _init_decoder_layer(generator, cfg, dt,
                                   cross=cfg.family == "audio")

    params = {
        "embed": embed_init(generator, (V, d), dt, dev),
        "final_norm": norm_param(cfg.norm, d, dt, dev),
        "lm_head": dense_init(generator, (d, V), dt, dev),
        "layers": _stack(layer, cfg.n_layers),
    }
    if cfg.family == "audio":
        params["enc_pos"] = embed_init(generator, (cfg.n_frames, d), dt, dev)
        params["enc_layers"] = _stack(
            lambda: _init_decoder_layer(generator, cfg, dt),
            cfg.encoder_layers)
    if cfg.family == "hybrid":
        # one SHARED attention + MLP block (tied weights, run per stage)
        params["shared"] = _init_decoder_layer(generator, cfg, dt)
    return params


# ==========================================================================
# Forward
# ==========================================================================

def _project_qkv(cfg: ArchConfig, p, x, positions):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if positions is not None:   # None: learned positions, added upstream
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_block(cfg: ArchConfig, p, x, positions, *, causal=True,
                window=None, return_kv=False):
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = blocked_attention(q, k, v, causal=causal, window=window)
    out = out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]
    if return_kv:
        return out, (k, v)      # k after RoPE, as the cache keeps it
    return out


def _cross_attn_block(cfg: ArchConfig, p, x, kv):
    """Cross-attention: q from x [B, S, d], (k, v) [B, F, Hkv, hd] the
    encoder output's, every query over every frame (no mask)."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    k, v = kv
    out = blocked_attention(q, k, v, causal=False)
    return out.reshape(B, S, -1) @ p["wo"]


def _encode_cross_kv(cfg: ArchConfig, p, enc_out):
    """A decoder layer's cross k, v [B, F, Hkv, hd] of the encoder
    output [B, F, d]."""
    B, F, _ = enc_out.shape
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, F, -1, cfg.head_dim)
    v = v.reshape(B, F, -1, cfg.head_dim)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    return k, v


def _ffn(cfg: ArchConfig, lp, h):
    """The layer's MLP, or its MoE layer. Returns (out, aux): the MoE
    load-balance loss, or 0.0."""
    if cfg.n_experts:
        return moe_apply(lp["moe"], h, top_k=cfg.top_k,
                         activation=cfg.activation, gated=cfg.gated_mlp,
                         group_size=cfg.moe_group_size,
                         capacity_factor=cfg.moe_capacity_factor)
    return mlp_apply(lp["mlp"], h, cfg.activation, cfg.gated_mlp), 0.0


def _decoder_block(cfg: ArchConfig, lp, x, positions, window,
                   cross_kv=None):
    h = apply_norm(x, lp["norm1"], cfg.norm)
    x = x + _attn_block(cfg, lp["attn"], h, positions, window=window)
    if cross_kv is not None:
        h = apply_norm(x, lp["norm_x"], cfg.norm)
        x = x + _cross_attn_block(cfg, lp["xattn"], h, cross_kv)
    h = apply_norm(x, lp["norm2"], cfg.norm)
    out, aux = _ffn(cfg, lp, h)
    return x + out, aux


def _ssm_block(cfg: ArchConfig, lp, x):
    h = apply_norm(x, lp["norm1"], cfg.norm)
    return x + mamba2_apply(lp["ssm"], h, head_dim=cfg.ssm_head_dim,
                            ssm_state=cfg.ssm_state, chunk=cfg.ssm_chunk)


def _effective_window(cfg: ArchConfig, seq_len: int):
    """SWA window for this forward: the arch's own window if it has one,
    else the long-context variant's window when seq_len is huge."""
    if cfg.window is not None:
        return cfg.window
    if seq_len > 131072 and cfg.family not in ("ssm",):
        return cfg.long_context_window
    return None


def _unstack(layers) -> list:
    """The [L, ...] stack's L layers, each a nest of views, every leaf
    split once by ``torch.unbind``: under autograd its backward stacks
    the L gradients once, where ``t[i]`` for each layer would write a
    zero-filled [L, ...] gradient for every one. The views are those of
    ``t[i]``, so the forward's values do not change."""
    leaves = tree_leaves(layers)
    split = [torch.unbind(t) for t in leaves]
    return [tree_unflatten(layers, [parts[i] for parts in split])
            for i in range(leaves[0].shape[0])]


def _maybe_remat(cfg: ArchConfig, fn):
    """``jax.checkpoint`` of the JAX package's ``_maybe_remat``: with
    ``cfg.remat``, where autograd records, ``fn``'s activations are not
    kept for the backward but recomputed from its inputs
    (``torch.utils.checkpoint``, non-reentrant; the forward draws no
    random numbers, so no RNG state is kept). Under no_grad ``fn`` runs
    as it is."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn

    def run(*args):
        return torch_checkpoint(fn, *args, use_reentrant=False,
                                preserve_rng_state=False)
    return run


def _check_trainable(cfg: ArchConfig, params) -> None:
    """The ``ssm`` and ``hybrid`` families train on the CPU only: on the
    card their gradient would need the SSD scan's backward kernel, which
    is not ported. Raises where autograd records a parameter on the
    card; never falls back to the plain scan."""
    if cfg.family in ("ssm", "hybrid") and torch.is_grad_enabled() and any(
            t.is_cuda and t.requires_grad for t in tree_leaves(params)):
        raise not_ported(f"training {cfg.name} ({cfg.family}) on the card",
                         SSD_BACKWARD_ITEM)


def _embed(cfg: ArchConfig, params, tokens):
    return params["embed"][tokens]


def _run_encoder(cfg: ArchConfig, params, frames):
    """frames [B, F, d] (the stubbed frontend's output, F <= n_frames),
    cast to the config's dtype, plus the learned positions, through the
    encoder stack: bidirectional attention (no mask, no RoPE), then the
    MLP. Returns [B, F, d]."""
    if frames is None:
        raise ValueError(f"{cfg.name}: an audio arch needs frame "
                         f"embeddings [B, {cfg.n_frames}, {cfg.d_model}]")
    x = frames.to(_dtype(cfg)) + params["enc_pos"][None, :frames.shape[1]]

    def enc_block(x, lp):
        h = apply_norm(x, lp["norm1"], cfg.norm)
        x = x + _attn_block(cfg, lp["attn"], h, None, causal=False)
        h = apply_norm(x, lp["norm2"], cfg.norm)
        return x + _ffn(cfg, lp, h)[0]

    enc_block = _maybe_remat(cfg, enc_block)
    for lp in _unstack(params["enc_layers"]):
        x = enc_block(x, lp)
    return x


def _check_stages(cfg: ArchConfig, n_layers: int) -> None:
    """The hybrid runs stages of ``attn_every`` Mamba2 layers, each
    followed by the shared block. The JAX package reshapes the layer
    stack into stages, which fails on a depth that is not a multiple of
    ``attn_every``; so does this."""
    if cfg.attn_every < 1 or n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: n_layers={n_layers} is not a "
                         f"multiple of attn_every={cfg.attn_every}")


def lm_forward(cfg: ArchConfig, params: PyTree, tokens, frames=None):
    """Forward of a dense or MoE decoder LM, a Mamba2 stack, a Zamba2
    stack or the Whisper encoder-decoder over every position. The hybrid
    runs ``n_layers // attn_every`` stages, each ``attn_every`` Mamba2
    layers and then the one shared attention + MLP block, whose tensors
    every stage reads. The audio family runs the encoder over
    ``frames`` [B, F, d] (required: a ``ValueError`` without them), then
    each decoder layer with cross-attention over the encoder output.
    With ``cfg.remat``, where autograd records, each layer (the
    hybrid's: each stage; the audio family's: each encoder and decoder
    layer) runs under ``torch.utils.checkpoint``, as the JAX package's
    scans run under ``jax.checkpoint``.

    tokens: integer [B, S] on the params' device. Returns (logits
    [B, S, padded_vocab] in the config's dtype, aux_loss: a float32
    scalar on that device, the MoE load-balance loss summed over the
    layers, as the JAX package's scan sums it; zero for the other
    families).
    """
    _require_ported(cfg)
    _check_trainable(cfg, params)
    B, S = tokens.shape
    layers = _unstack(params["layers"])
    if cfg.family == "hybrid":
        _check_stages(cfg, len(layers))
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    window = _effective_window(cfg, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        block = _maybe_remat(cfg, lambda x, lp: _ssm_block(cfg, lp, x))
        for lp in layers:
            x = block(x, lp)
    elif cfg.family == "hybrid":
        def stage(x, stage_layers):
            for lp in stage_layers:
                x = _ssm_block(cfg, lp, x)
            return _decoder_block(cfg, params["shared"], x, positions,
                                  window)[0]

        stage = _maybe_remat(cfg, stage)
        for i in range(0, len(layers), cfg.attn_every):
            x = stage(x, layers[i:i + cfg.attn_every])
    elif cfg.family == "audio":
        enc_out = _run_encoder(cfg, params, frames)

        def block(x, lp):
            kv = _encode_cross_kv(cfg, lp["xattn"], enc_out)
            return _decoder_block(cfg, lp, x, positions, window, kv)[0]

        block = _maybe_remat(cfg, block)
        for lp in layers:
            x = block(x, lp)
    else:
        block = _maybe_remat(cfg, lambda x, lp: _decoder_block(
            cfg, lp, x, positions, window))
        for lp in layers:
            x, aux = block(x, lp)
            aux_total = aux_total + aux
    x = apply_norm(x, params["final_norm"], cfg.norm)
    logits = x @ params["lm_head"]
    return logits, aux_total


def lm_loss(cfg: ArchConfig, params: PyTree, tokens, frames=None,
            aux_weight: float = 0.01):
    """Next-token cross entropy over ``lm_forward``'s logits, in fp32,
    plus ``aux_weight`` times the MoE load-balance aux: a float32
    scalar."""
    logits, aux = lm_forward(cfg, params, tokens, frames)
    logits = logits[:, :-1].float()
    labels = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean() + aux_weight * aux


# ==========================================================================
# KV / state caches and decode
# ==========================================================================

def dynamic_update_slice_in_dim(operand, update, start, axis: int):
    """``jax.lax.dynamic_update_slice_in_dim``, written into ``operand``
    in place: ``update``'s n rows go to [start, start + n) along
    ``axis``. As in JAX, a negative start counts from the end, and the
    start is then clamped into [0, size - n] so that the update fits (a
    start past the end overwrites the last n rows). ``start``: a 0-d
    integer tensor, read on operand's device (one already there costs
    no host sync), or an int. Returns ``operand``."""
    n, size = update.shape[axis], operand.shape[axis]
    start = torch.as_tensor(start).to(device=operand.device,
                                      dtype=torch.long)
    first = torch.clamp(torch.where(start < 0, start + size, start), 0,
                        size - n)
    idx = first + torch.arange(n, device=operand.device)
    return operand.index_copy_(axis, idx, update.to(operand.dtype))


def _attn_cache_mode(cfg: ArchConfig, max_len: int) -> tuple[str, int]:
    """('ring', W) for sliding-window archs (cache = W slots, slot =
    pos % W), else ('full', max_len) with a main + recent split."""
    W = _effective_window(cfg, max_len)
    if W is not None and W < max_len:
        return "ring", W
    return "full", max_len


def _counter(value: int, device):
    """A 0-d int32 cache counter, filled on its device (no copy from the
    host)."""
    return torch.full((), value, dtype=torch.int32, device=device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    """An empty decode cache for ``batch`` sequences of up to ``max_len``
    tokens, on ``device``: the JAX package's tree, leaf for leaf.

    Attention (dense and vlm; the hybrid's shared block, once per
    stage): a ring
    of W slots for a sliding window shorter than max_len, else a full
    main cache of max_len slots, read-only inside a decode step, beside
    ``decode_buffer`` recent slots that the step writes and
    ``flush_recent`` folds into main. SSM: each layer's last K - 1 conv
    inputs and its float32 state. Audio: each decoder layer's cross k
    and v of the encoder output, ``xk``, ``xv`` [L, batch, n_frames,
    Hkv, hd], beside its attention buffers."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads
    cache: dict = {"len": _counter(0, dev)}

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family in ("ssm", "hybrid"):
        cache.update(_ssm_cache(cfg, batch, zeros))
    if cfg.family != "ssm":
        # one attention cache per dense layer, one per hybrid stage
        n = cfg.n_layers
        if cfg.family == "hybrid":
            _check_stages(cfg, n)
            n //= cfg.attn_every
        mode, size = _attn_cache_mode(cfg, max_len)
        cache["k"] = zeros(n, batch, size, Hkv, hd)
        cache["v"] = zeros(n, batch, size, Hkv, hd)
        if mode == "full":
            R = cfg.decode_buffer
            cache["kr"] = zeros(n, batch, R, Hkv, hd)
            cache["vr"] = zeros(n, batch, R, Hkv, hd)
            cache["flushed"] = _counter(0, dev)
    if cfg.family == "audio":
        cache["xk"] = zeros(cfg.n_layers, batch, cfg.n_frames, Hkv, hd)
        cache["xv"] = zeros(cfg.n_layers, batch, cfg.n_frames, Hkv, hd)
    return cache


def _ssm_cache(cfg: ArchConfig, batch: int, zeros) -> dict:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {"conv": zeros(cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim),
            "ssm": zeros(cfg.n_layers, batch, cfg.ssm_heads,
                         cfg.ssm_head_dim, cfg.ssm_state,
                         dtype=torch.float32)}


def _decode_attn(cfg: ArchConfig, p, x, bufs, pos, flushed):
    """x: [B, 1, d]; bufs = (k, v) ring or (k, v, kr, vr) full split, one
    attention layer's. pos: 0-d int32 (the token being decoded);
    flushed: 0-d int32, the tokens already in main (full mode). Writes
    the token's k, v into the ring slot pos % W or the recent slot
    pos - flushed; main is only read. Returns out [B, 1, d]."""
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, pos.reshape(1, 1).expand(B, 1))
    if len(bufs) == 2:                      # ring (sliding window)
        kc, vc = bufs
        W = kc.shape[1]
        slot = pos % W
        dynamic_update_slice_in_dim(kc, k, slot, 1)
        dynamic_update_slice_in_dim(vc, v, slot, 1)
        out = decode_attention(q, [(kc, vc, torch.clamp(pos + 1, max=W))])
    else:                                   # full: read-only main + recent
        km, vm, kr, vr = bufs
        slot = pos - flushed
        dynamic_update_slice_in_dim(kr, k, slot, 1)
        dynamic_update_slice_in_dim(vr, v, slot, 1)
        out = decode_attention(
            q, [(km, vm, flushed), (kr, vr, pos - flushed + 1)])
    return out.reshape(B, 1, -1) @ p["wo"]


def _decode_ssm_block(cfg: ArchConfig, lp, x, conv_state, ssm_state):
    h = apply_norm(x, lp["norm1"], cfg.norm)
    y, conv_state, ssm_state = ssm_mod.mamba2_decode(
        lp["ssm"], h[:, 0], conv_state, ssm_state,
        head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state)
    return x + y[:, None], conv_state, ssm_state


def _decode_decoder_block(cfg: ArchConfig, lp, x, bufs, pos, flushed,
                          cross_kv=None):
    """One decoder layer at one token; ``cross_kv`` (audio): the layer's
    cached cross k, v, attended by ``blocked_attention`` at one query."""
    h = apply_norm(x, lp["norm1"], cfg.norm)
    x = x + _decode_attn(cfg, lp["attn"], h, bufs, pos, flushed)
    if cross_kv is not None:
        h = apply_norm(x, lp["norm_x"], cfg.norm)
        x = x + _cross_attn_block(cfg, lp["xattn"], h, cross_kv)
    h = apply_norm(x, lp["norm2"], cfg.norm)
    out, _ = _ffn(cfg, lp, h)
    return x + out


def lm_decode_step(cfg: ArchConfig, params: PyTree, token, cache: PyTree):
    """One decode step. token: integer [B] on the params' device.
    Returns (logits [B, V], cache).

    Attention caches: ring mode writes slot pos % W; full mode writes
    only the recent buffer, main is read (and written by
    ``flush_recent``). The SSM layers write their conv and state. All
    in place; the counters ``len`` and ``flushed`` stay on the device,
    so a step makes no host sync. The audio decoder also attends each
    layer's cached ``xk``, ``xv`` (read only): one flash launch a layer
    on the card."""
    _require_ported(cfg)
    pos = cache["len"]
    full = "kr" in cache
    flushed = cache.get("flushed")
    layers = params["layers"]
    n_layers = tree_leaves(layers)[0].shape[0]
    if cfg.family == "hybrid":
        _check_stages(cfg, n_layers)
    x = _embed(cfg, params, token[:, None])

    def bufs(j):
        names = ("k", "v", "kr", "vr") if full else ("k", "v")
        return tuple(cache[n][j] for n in names)

    stage = 0
    for i in range(n_layers):
        lp = tree_map(lambda t: t[i], layers)
        if cfg.family in ("ssm", "hybrid"):
            x, conv, st = _decode_ssm_block(cfg, lp, x, cache["conv"][i],
                                            cache["ssm"][i])
            cache["conv"][i].copy_(conv)
            cache["ssm"][i].copy_(st)
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                x = _decode_decoder_block(cfg, params["shared"], x,
                                          bufs(stage), pos, flushed)
                stage += 1
        else:
            cross = (cache["xk"][i], cache["xv"][i]) \
                if cfg.family == "audio" else None
            x = _decode_decoder_block(cfg, lp, x, bufs(i), pos, flushed,
                                      cross)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    logits = (x @ params["lm_head"])[:, 0]
    new_cache = dict(cache)
    new_cache["len"] = pos + 1
    return logits, new_cache


def flush_recent(cfg: ArchConfig, cache: PyTree) -> PyTree:
    """Fold the recent buffer into the main cache (full mode only): all
    ``decode_buffer`` recent slots are written to main at ``flushed``
    (clamped as JAX clamps, see ``dynamic_update_slice_in_dim``: grow
    main first) and ``flushed`` becomes ``len``. The serving loop calls
    it when len - flushed reaches ``decode_buffer``; it is the only op
    that writes main. Writes main in place and returns the cache."""
    if "kr" not in cache:
        return cache
    flushed = cache["flushed"]
    out = dict(cache)
    dynamic_update_slice_in_dim(cache["k"], cache["kr"], flushed, 2)
    dynamic_update_slice_in_dim(cache["v"], cache["vr"], flushed, 2)
    out["flushed"] = flushed + (cache["len"] - flushed)
    return out


class _PrefillKV:
    """Each attention layer's prefill k, v, written as it comes into the
    decode cache's layout for S prompt tokens: a ring of W slots holding
    the last W rows, position p at slot p % W (the JAX package rolls the
    stacked rows by S % W; taking each layer's rows as the layer ends
    keeps one layer's whole k and v alive, not every layer's); else the
    whole prompt as main, beside empty recent slots."""

    def __init__(self, cfg: ArchConfig, n: int, S: int):
        self.cfg, self.n, self.S = cfg, n, S
        self.mode, self.size = _attn_cache_mode(cfg, S)
        self.k = self.v = None
        self.i = 0

    def add(self, k, v) -> None:
        S, W = self.S, self.size
        if self.k is None:
            shape = (self.n, k.shape[0], W) + tuple(k.shape[2:])
            self.k = k.new_empty(shape)
            self.v = v.new_empty(shape)
        for dst, src in ((self.k, k), (self.v, v)):
            if self.mode == "ring":
                src = src[:, S - W:]
                if S % W:
                    src = torch.roll(src, S % W, dims=1)
            dst[self.i].copy_(src)
        self.i += 1

    def cache(self) -> dict:
        out = {"k": self.k, "v": self.v}
        if self.mode == "full":
            shape = self.k.shape[:2] + (self.cfg.decode_buffer,) \
                + self.k.shape[3:]
            out["kr"] = self.k.new_zeros(shape)
            out["vr"] = self.k.new_zeros(shape)
            out["flushed"] = _counter(self.S, self.k.device)
        return out


def _ssm_prefill_block(cfg: ArchConfig, p, x):
    """Like ``mamba2_apply`` but also returns (conv_state, ssm_state)."""
    Bsz, L, D = x.shape
    d_inner = cfg.d_inner
    H, N = cfg.ssm_heads, cfg.ssm_state

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * N:]
    # a copy: a view would hold the whole projection alive in the cache
    conv_state = xBC[:, -(cfg.ssm_conv - 1):, :].clone()
    xBC = ssm_mod.silu(ssm_mod.causal_conv1d(xBC, p["conv_w"], p["conv_b"]))
    xs = xBC[..., :d_inner].reshape(Bsz, L, H, cfg.ssm_head_dim)
    B_ = xBC[..., d_inner:d_inner + N]
    C_ = xBC[..., d_inner + N:]

    dt = ssm_mod._softplus(dt.to(torch.float32) + p["dt_bias"])
    dt = torch.clamp(dt, 1e-4, 1e2)
    A = -torch.exp(p["A_log"].to(torch.float32))
    a = dt * A[None, None, :]
    xd = xs * dt[..., None].to(xs.dtype)
    y, final_state = ssm_mod.ssd_chunked(xd, a, B_, C_, chunk=cfg.ssm_chunk)
    y = y + xs * p["D"][None, None, :, None]
    y = y.reshape(Bsz, L, d_inner)
    y = rms_norm(y * ssm_mod.silu(z), p["norm_w"])
    return y @ p["out_proj"], conv_state, final_state


def lm_prefill(cfg: ArchConfig, params: PyTree, tokens, frames=None):
    """Prefill: the forward over the prompt, building the decode cache
    (sized to the prompt: the ring of the window the prompt's length
    takes, or a main cache of S slots; to decode past it in full mode,
    copy main into a longer ``init_cache``'s first). The audio family
    runs the encoder over ``frames`` and keeps each layer's cross k, v
    in the cache. Returns (last-token logits [B, V], cache)."""
    _require_ported(cfg)
    B, S = tokens.shape
    layers = params["layers"]
    n_layers = tree_leaves(layers)[0].shape[0]
    if cfg.family == "hybrid":
        _check_stages(cfg, n_layers)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    window = _effective_window(cfg, S)
    cache: dict = {"len": _counter(S, x.device)}
    kv = _PrefillKV(cfg, n_layers // cfg.attn_every
                    if cfg.family == "hybrid" else n_layers, S)
    convs, states, cross = [], [], []
    enc_out = _run_encoder(cfg, params, frames) \
        if cfg.family == "audio" else None

    def attn_layer(lp, x):
        h = apply_norm(x, lp["norm1"], cfg.norm)
        a, (k, v) = _attn_block(cfg, lp["attn"], h, positions,
                                window=window, return_kv=True)
        kv.add(k, v)
        x = x + a
        if enc_out is not None:
            cross.append(_encode_cross_kv(cfg, lp["xattn"], enc_out))
            h = apply_norm(x, lp["norm_x"], cfg.norm)
            x = x + _cross_attn_block(cfg, lp["xattn"], h, cross[-1])
        h = apply_norm(x, lp["norm2"], cfg.norm)
        out, _ = _ffn(cfg, lp, h)
        return x + out

    for i in range(n_layers):
        lp = tree_map(lambda t: t[i], layers)
        if cfg.family in ("ssm", "hybrid"):
            h = apply_norm(x, lp["norm1"], cfg.norm)
            y, conv, st = _ssm_prefill_block(cfg, lp["ssm"], h)
            x = x + y
            convs.append(conv)
            states.append(st)
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                x = attn_layer(params["shared"], x)
        else:
            x = attn_layer(lp, x)
    if convs:
        cache["conv"] = torch.stack(convs)
        cache["ssm"] = torch.stack(states)
    if cfg.family != "ssm":
        cache.update(kv.cache())
    if cross:
        cache["xk"] = torch.stack([k for k, _ in cross])
        cache["xv"] = torch.stack([v for _, v in cross])
    x = apply_norm(x[:, -1:], params["final_norm"], cfg.norm)
    logits = (x @ params["lm_head"])[:, 0]
    return logits, cache
