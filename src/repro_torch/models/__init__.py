"""The port's models: the paper's 2 x LSTM + 3 x FC (``rnn``) and the
zoo's dense decoder LM (``transformer``, ``model_zoo``)."""
