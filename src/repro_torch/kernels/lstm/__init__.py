from repro_torch.kernels.lstm.ops import lstm_cell, lstm_layer

__all__ = ["lstm_cell", "lstm_layer"]
