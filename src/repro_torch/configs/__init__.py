"""Model configurations of the port: the paper LSTM
(``paper_lstm.CONFIG``) and the zoo architectures whose family the port
runs so far, the dense Qwen1.5-4B, the SSM Mamba2-370M and the hybrid
Zamba2-2.7B (``get_config`` / ``list_archs``; importing this package
registers them)."""

from repro_torch.configs import (mamba2_370m, qwen1_5_4b,  # noqa: F401
                                 zamba2_2_7b)
from repro_torch.configs.base import (ARCHS, ArchConfig, get_config,
                                      list_archs, register)

__all__ = ["ARCHS", "ArchConfig", "get_config", "list_archs", "register"]
