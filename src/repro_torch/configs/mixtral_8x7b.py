"""Mixtral-8x7B — sparse MoE, 8 experts top-2, sliding-window attention
(window 4096) [arXiv:2401.04088]. GQA kv=8, gated SiLU experts.

Native SWA means long_500k runs with its own window (no variant
needed). The same config as ``repro.configs.mixtral_8x7b``.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    n_experts=8,
    top_k=2,
    window=4096,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    train_microbatches=8,
    source="arXiv:2401.04088",
))
