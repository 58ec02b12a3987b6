"""Nemotron-4-15B [arXiv:2402.16819].

GQA (kv=8), squared-ReLU non-gated MLP, 256k vocab.
The same config as ``repro.configs.nemotron_4_15b``.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=256000,
    activation="relu2",
    gated_mlp=False,
    norm="layernorm",
    train_microbatches=8,
    source="arXiv:2402.16819",
))
