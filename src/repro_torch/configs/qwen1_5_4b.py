"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family scaling].

MHA (kv=20 == heads), QKV bias, gated SiLU MLP. The same config as
``repro.configs.qwen1_5_4b``.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    train_microbatches=8,
    source="hf:Qwen/Qwen1.5-0.5B",
))
