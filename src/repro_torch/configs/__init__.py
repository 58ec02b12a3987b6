"""Model configurations of the port: the paper LSTM
(``paper_lstm.CONFIG``) and the zoo architectures whose family the port
runs so far, the dense Qwen1.5-4B, Nemotron-4-15B, Granite-20B and
Qwen2.5-32B, the VLM Chameleon-34B (a dense decoder over text and image
tokens), the MoE Mixtral-8x7B and Qwen3-MoE-235B-A22B, the SSM
Mamba2-370M, the hybrid Zamba2-2.7B and the audio encoder-decoder
Whisper-medium (``get_config`` / ``list_archs``; importing this package
registers them)."""

from repro_torch.configs import (chameleon_34b, granite_20b,  # noqa: F401
                                 mamba2_370m, mixtral_8x7b, nemotron_4_15b,
                                 qwen1_5_4b, qwen2_5_32b,
                                 qwen3_moe_235b_a22b, whisper_medium,
                                 zamba2_2_7b)
from repro_torch.configs.base import (ARCHS, ArchConfig, get_config,
                                      list_archs, register)

__all__ = ["ARCHS", "ArchConfig", "get_config", "list_archs", "register"]
