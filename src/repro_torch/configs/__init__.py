"""Model configurations of the port (so far the paper LSTM)."""
