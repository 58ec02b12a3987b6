"""Zamba2-2.7B — hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]. 54 Mamba2 layers (d_model=2560, ssm_state=64) with a
single *shared* full-attention+MLP block (tied weights, 32 MHA heads,
d_ff=10240) applied every 6 SSM layers.
The same config as ``repro.configs.zamba2_2_7b``.

Runs long_500k natively (SSM backbone); the shared attention block uses
the long-context sliding window for that shape.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    activation="gelu",
    gated_mlp=False,
    norm="rmsnorm",
    source="arXiv:2411.15242",
))
