"""Mamba2-370M — attention-free SSM with state-space duality
[arXiv:2405.21060]. 48 layers, d_model=1024, expand=2 (d_inner=2048),
head_dim=64 (32 SSM heads), ssm_state=128, depthwise conv width 4.
The same config as ``repro.configs.mamba2_370m``.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    norm="rmsnorm",
    source="arXiv:2405.21060",
))
