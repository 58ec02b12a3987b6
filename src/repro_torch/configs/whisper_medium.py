"""Whisper-medium, encoder-decoder ASR [arXiv:2212.04356].

24 + 24 layers, d_model 1024, 16 MHA heads of 64, GELU, LayerNorm, QKV
bias. The mel-spectrogram and conv frontend is a stub, as in the JAX
package: the encoder takes precomputed frame embeddings [batch, 1500,
1024]. Decode is the text decoder with a self-attention KV cache and
cross-attention to the encoder's output. The same config as
``repro.configs.whisper_medium``.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    encoder_layers=24,
    n_frames=1500,
    qkv_bias=True,
    activation="gelu",
    gated_mlp=False,
    norm="layernorm",
    source="arXiv:2212.04356",
))
