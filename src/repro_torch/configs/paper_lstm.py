"""The paper's own model: 2-layer LSTM + 3 FC layers, window 20, OHLCV
features (Table I + footnote)."""

from repro_torch.models.rnn import RNNConfig

CONFIG = RNNConfig(input_dim=5, hidden=64, num_layers=2, fc_dims=(32, 16),
                   window=20, evl_head=True)
