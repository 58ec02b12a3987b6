"""Chameleon-34B — early-fusion VLM decoder [arXiv:2405.09818].

Text + VQ image tokens share one vocabulary (65536 incl. 8192 image codes);
the transformer backbone is a llama-style decoder with qk-norm for
stability. The VQ image tokenizer is a stub, as in the JAX package:
the model takes token ids that include image-token spans. The same
config as ``repro.configs.chameleon_34b``; its family, ``vlm``, runs
through the dense decoder.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    train_microbatches=16,
    source="arXiv:2405.09818",
))
