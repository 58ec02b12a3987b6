"""Model configurations of the port: the paper LSTM
(``paper_lstm.CONFIG``) and the zoo architectures whose family the port
runs so far (``get_config`` / ``list_archs``; importing this package
registers them)."""

from repro_torch.configs import qwen1_5_4b  # noqa: F401
from repro_torch.configs.base import (ARCHS, ArchConfig, get_config,
                                      list_archs, register)

__all__ = ["ARCHS", "ArchConfig", "get_config", "list_archs", "register"]
