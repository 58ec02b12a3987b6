"""Streaming forecast serving on the card: the paper LSTM and the zoo's
dense LMs behind one forecaster interface (``forecaster``),
device-resident decode slots and session cache (``sessions``), a
versioned model registry (``registry``), the micro-batching engine
(``engine``) and its telemetry (``telemetry``)."""

from repro_torch.serving.engine import (BatcherConfig, EngineShard,
                                        ServingEngine)
from repro_torch.serving.forecaster import (DecodeSlots, LSTMForecaster,
                                            ZooForecaster,
                                            build_lstm_forecaster,
                                            build_zoo_forecaster)
from repro_torch.serving.registry import ModelRegistry, RegistryEntry
from repro_torch.serving.sessions import (RecurrentSessionRunner,
                                          SessionCache)
from repro_torch.serving.telemetry import Telemetry

__all__ = [
    "BatcherConfig",
    "DecodeSlots",
    "EngineShard",
    "LSTMForecaster",
    "ModelRegistry",
    "RecurrentSessionRunner",
    "RegistryEntry",
    "ServingEngine",
    "SessionCache",
    "Telemetry",
    "ZooForecaster",
    "build_lstm_forecaster",
    "build_zoo_forecaster",
]
