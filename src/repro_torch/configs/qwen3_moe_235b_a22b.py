"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family scaling].

94 layers, 128 experts top-8 (expert d_ff=1536), GQA kv=4 with qk-norm,
head_dim=128 (q_dim 8192 != d_model 4096). 235B total / ~22B active
params. The same config as ``repro.configs.qwen3_moe_235b_a22b``.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    n_experts=128,
    top_k=8,
    qk_norm=True,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=1e6,
    train_microbatches=16,
    adam_moment_dtype="bfloat16",
    source="hf:Qwen/Qwen3-30B-A3B",
))
