"""The port's models: so far the paper's 2 x LSTM + 3 x FC (``rnn``)."""
