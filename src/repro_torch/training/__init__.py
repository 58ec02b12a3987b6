"""Training loops (``loop``) and prediction metrics (``metrics``) for the
paper's stock-prediction experiments."""

from repro_torch.training.loop import (TrainResult, train_rnn_local_sgd,
                                       train_rnn_serial)
from repro_torch.training.metrics import extreme_event_metrics, mse, rmse

__all__ = ["TrainResult", "extreme_event_metrics", "mse", "rmse",
           "train_rnn_local_sgd", "train_rnn_serial"]
