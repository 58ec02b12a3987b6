from repro_torch.kernels.lstm.ops import lstm_cell

__all__ = ["lstm_cell"]
