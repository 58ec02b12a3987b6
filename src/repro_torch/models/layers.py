"""Shared building blocks of the port's models: inits, norms, rotary
embeddings, activations (``repro.models.layers``).

Inits draw from an explicit ``torch.Generator`` on the generator's own
device, then cast and move: a CPU generator gives the same weights on
every device (the paper LSTM); a CUDA generator draws a large model on
the card, with no copy of it on the host. The two give different
numbers from one seed.
"""

from __future__ import annotations

import torch


# -------------------------------------------------------------------------
# Initializers
# -------------------------------------------------------------------------

def init_device(generator: torch.Generator | None) -> torch.device:
    """Where an init puts its leaves: on the generator's device, or on
    the meta device (shapes and dtypes, no data) with no generator."""
    return torch.device("meta") if generator is None else generator.device


def _normal(generator: torch.Generator | None, shape, std: float, dtype,
            device):
    if generator is None:                       # the meta device: no draw
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    w = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    # scaled in place: one fp32 copy of the leaf at a time, beside the
    # stacked tree of a model that nearly fills the card
    return w.mul_(std).to(dtype=dtype, device=device)


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               device="cpu", scale: float | None = None):
    """LeCun-normal-ish init: std = scale / sqrt(fan_in), drawn in fp32
    on the generator's device, then cast to ``dtype`` on ``device``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = (scale if scale is not None else 1.0) / (fan_in ** 0.5)
    return _normal(generator, shape, std, dtype, device)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32,
               device="cpu", std: float = 0.02):
    return _normal(generator, shape, std, dtype, device)


# -------------------------------------------------------------------------
# Norms (computed in fp32, returned in the input's dtype)
# -------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, p["w"])
    return layer_norm(x, p["w"], p.get("b"))


def norm_param(kind: str, dim: int, dtype, device="cpu"):
    if kind == "rmsnorm":
        return {"w": torch.ones((dim,), dtype=dtype, device=device)}
    return {"w": torch.ones((dim,), dtype=dtype, device=device),
            "b": torch.zeros((dim,), dtype=dtype, device=device)}


# -------------------------------------------------------------------------
# Activations
# -------------------------------------------------------------------------

def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def relu2(x):
    """Squared ReLU (nemotron-4)."""
    r = torch.clamp_min(x, 0.0)
    return r * r


ACTIVATIONS = {
    "silu": silu,
    "gelu": gelu,
    "relu2": relu2,
}


# -------------------------------------------------------------------------
# Rotary position embeddings
# -------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 1e4, device="cpu"):
    """[head_dim // 2] inverse frequencies (fp32). theta is filled on
    ``device``, not copied from the host: on the card a copy would make
    every call wait for the work queued before it."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exponent)


def apply_rope(x, positions, theta: float = 1e4):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] integers.

    Rotates pairs (x[2i], x[2i+1]), the interleaved convention (not the
    rotate-half of HF checkpoints), in fp32, returned in x's dtype.
    """
    inv_freq = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    cos = torch.cos(angles)[..., None, :]     # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    out = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Pad vocab to a multiple of 256 (logits over padding ids are never
    produced as labels)."""
    return ((vocab + multiple - 1) // multiple) * multiple

