"""Transformer zoo (``repro.models.transformer``): the decoder LM of the
``dense`` family, the Mamba2 stack of the ``ssm`` family and the
Zamba2 stack of the ``hybrid`` family (Mamba2 layers with one shared
attention + MLP block after every ``attn_every`` of them), their init
and their forward.

    params = init_lm(cfg, generator)                 # leaves on its device
    logits, aux = lm_forward(cfg, params, tokens)    # serve (predict)

Layers are stacked on a leading [L, ...] dim, as in the JAX package, so
its params map onto these one to one (``checkpoint.convert``); the
forward walks the stack in a Python loop where the JAX package scans.
The JAX package's ``pshard.constrain`` sharding hints have no
single-GPU counterpart and are dropped, as is ``jax.checkpoint``
rematerialization (a forward-only path keeps no activations).

Every other family raises ``NotImplementedError`` naming the ROADMAP
item that ports it, as do the loss, prefill and decode paths.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import blocked_attention
from repro_torch.models.layers import (apply_norm, apply_rope, dense_init,
                                       embed_init, init_device, norm_param,
                                       rms_norm)
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.ssm import mamba2_apply
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

# the ROADMAP "Next" item that ports each family the port lacks
_LATER = {"moe": "MoE", "vlm": "audio and VLM", "audio": "audio and VLM"}
# the families the port runs
_PORTED = ("dense", "ssm", "hybrid")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP, Next: "
                               f"{item})")


def _require_ported(cfg: ArchConfig) -> None:
    family = "moe" if cfg.n_experts else cfg.family
    if family not in _PORTED:
        raise not_ported(f"the {family!r} family ({cfg.name})",
                         _LATER.get(family, family))


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


def _init_decoder_layer(g, cfg: ArchConfig, dt):
    dev = init_device(g)
    return {"norm1": norm_param(cfg.norm, cfg.d_model, dt, dev),
            "attn": _init_attn(g, cfg, dt),
            "norm2": norm_param(cfg.norm, cfg.d_model, dt, dev),
            "mlp": _init_mlp(g, cfg, dt)}


def _stack(fn, n: int):
    """``n`` draws of a param subtree stacked on a leading dim, written
    layer by layer into the stacked leaves (no list of layers held)."""
    first = fn()
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        tree_map(lambda dst, src: dst[i].copy_(src), out,
                 first if i == 0 else fn())
    return out


def init_lm(cfg: ArchConfig, generator: torch.Generator | None) -> PyTree:
    """Random params of a dense decoder LM, a Mamba2 stack or a Zamba2
    stack (the Mamba2 layers, and one ``shared`` attention + MLP block),
    in the config's dtype (``dt_bias`` and ``A_log`` in float32, as in
    the JAX package), drawn from ``generator`` on its own device (a CUDA
    generator draws on the card, each leaf in fp32 and cast, one layer
    at a time). With no generator the leaves lie on the meta device: the
    tree's keys, shapes and dtypes, with no data."""
    _require_ported(cfg)
    dt = _dtype(cfg)
    V, d = cfg.padded_vocab, cfg.d_model
    dev = init_device(generator)

    def layer():
        if cfg.family in ("ssm", "hybrid"):
            return {"norm1": norm_param(cfg.norm, d, dt, dev),
                    "ssm": _init_ssm_block(generator, cfg, dt)}
        return _init_decoder_layer(generator, cfg, dt)

    params = {
        "embed": embed_init(generator, (V, d), dt, dev),
        "final_norm": norm_param(cfg.norm, d, dt, dev),
        "lm_head": dense_init(generator, (d, V), dt, dev),
        "layers": _stack(layer, cfg.n_layers),
    }
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
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_block(cfg: ArchConfig, p, x, positions, *, window=None):
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = blocked_attention(q, k, v, causal=True, window=window)
    return out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]


def _ffn(cfg: ArchConfig, lp, h):
    if cfg.n_experts:
        raise not_ported("moe_apply", _LATER["moe"])
    return mlp_apply(lp["mlp"], h, cfg.activation, cfg.gated_mlp), 0.0


def _decoder_block(cfg: ArchConfig, lp, x, positions, window):
    h = apply_norm(x, lp["norm1"], cfg.norm)
    x = x + _attn_block(cfg, lp["attn"], h, positions, window=window)
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


def _embed(cfg: ArchConfig, params, tokens):
    return params["embed"][tokens]


def _check_stages(cfg: ArchConfig, n_layers: int) -> None:
    """The hybrid runs stages of ``attn_every`` Mamba2 layers, each
    followed by the shared block. The JAX package reshapes the layer
    stack into stages, which fails on a depth that is not a multiple of
    ``attn_every``; so does this."""
    if cfg.attn_every < 1 or n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: n_layers={n_layers} is not a "
                         f"multiple of attn_every={cfg.attn_every}")


def lm_forward(cfg: ArchConfig, params: PyTree, tokens, frames=None):
    """Forward of a dense decoder LM, a Mamba2 stack or a Zamba2 stack
    over every position. The hybrid runs ``n_layers // attn_every``
    stages, each ``attn_every`` Mamba2 layers and then the one shared
    attention + MLP block, whose tensors every stage reads.

    tokens: integer [B, S] on the params' device. Returns (logits
    [B, S, padded_vocab] in the config's dtype, aux_loss: a float32
    zero, the MoE load-balance loss of the families to come).
    """
    _require_ported(cfg)
    B, S = tokens.shape
    layers = params["layers"]
    n_layers = tree_leaves(layers)[0].shape[0]
    if cfg.family == "hybrid":
        _check_stages(cfg, n_layers)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    window = _effective_window(cfg, S)
    for i in range(n_layers):
        lp = tree_map(lambda t: t[i], layers)
        if cfg.family in ("ssm", "hybrid"):
            x = _ssm_block(cfg, lp, x)
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                x, _ = _decoder_block(cfg, params["shared"], x, positions,
                                      window)
        else:
            x, _ = _decoder_block(cfg, lp, x, positions, window)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    logits = x @ params["lm_head"]
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
