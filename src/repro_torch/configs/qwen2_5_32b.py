"""Qwen2.5-32B [hf:Qwen/Qwen2.5-0.5B family scaling].

GQA (kv=8), QKV bias, gated SiLU MLP, RMSNorm, large vocab (152064).
The same config as ``repro.configs.qwen2_5_32b``.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=1e6,
    train_microbatches=16,
    source="hf:Qwen/Qwen2.5-0.5B",
))
