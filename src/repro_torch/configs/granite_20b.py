"""Granite-20B (code) [arXiv:2405.04324].

GPT-BigCode-style deep-narrow decoder with multi-query attention
(n_kv_heads=1) and non-gated GELU MLP (d_ff = 4 * d_model).
The same config as ``repro.configs.granite_20b``.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    activation="gelu",
    gated_mlp=False,
    norm="layernorm",
    train_microbatches=16,
    source="arXiv:2405.04324",
))
