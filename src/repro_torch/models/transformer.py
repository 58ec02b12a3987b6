"""Transformer zoo, dense half (``repro.models.transformer``): the
decoder LM of the ``dense`` family, its init and its forward.

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
                                       embed_init, norm_param, rms_norm)
from repro_torch.models.mlp import mlp_apply
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

# the ROADMAP "Next" item that ports each family the port lacks
_LATER = {"ssm": "SSD with Mamba2-370M", "hybrid": "Zamba2",
          "moe": "MoE", "vlm": "audio and VLM", "audio": "audio and VLM"}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP, Next: "
                               f"{item})")


def _require_dense(cfg: ArchConfig) -> None:
    family = "moe" if cfg.n_experts else cfg.family
    if family != "dense":
        raise not_ported(f"the {family!r} family ({cfg.name})",
                         _LATER.get(family, family))


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ==========================================================================
# Parameter construction
# ==========================================================================

def _init_attn(g, cfg: ArchConfig, dt):
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    dev = g.device
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
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": dense_init(g, (d, f), dt, g.device),
         "w2": dense_init(g, (f, d), dt, g.device)}
    if cfg.gated_mlp:
        p["w3"] = dense_init(g, (d, f), dt, g.device)
    return p


def _init_decoder_layer(g, cfg: ArchConfig, dt):
    return {"norm1": norm_param(cfg.norm, cfg.d_model, dt, g.device),
            "attn": _init_attn(g, cfg, dt),
            "norm2": norm_param(cfg.norm, cfg.d_model, dt, g.device),
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


def init_lm(cfg: ArchConfig, generator: torch.Generator) -> PyTree:
    """Random params of a dense decoder LM, in the config's dtype, drawn
    from ``generator`` on its own device (a CUDA generator draws on the
    card, each leaf in fp32 and cast, one layer at a time)."""
    _require_dense(cfg)
    dt = _dtype(cfg)
    V, d = cfg.padded_vocab, cfg.d_model
    dev = generator.device
    return {
        "embed": embed_init(generator, (V, d), dt, dev),
        "final_norm": norm_param(cfg.norm, d, dt, dev),
        "lm_head": dense_init(generator, (d, V), dt, dev),
        "layers": _stack(lambda: _init_decoder_layer(generator, cfg, dt),
                         cfg.n_layers),
    }


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


def lm_forward(cfg: ArchConfig, params: PyTree, tokens, frames=None):
    """Forward of a dense decoder LM over every position.

    tokens: integer [B, S] on the params' device. Returns (logits
    [B, S, padded_vocab] in the config's dtype, aux_loss: a float32
    zero, the MoE load-balance loss of the families to come).
    """
    _require_dense(cfg)
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    window = _effective_window(cfg, S)
    layers = params["layers"]
    for i in range(tree_leaves(layers)[0].shape[0]):
        x, _ = _decoder_block(cfg, tree_map(lambda t: t[i], layers), x,
                              positions, window)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    logits = x @ params["lm_head"]
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
