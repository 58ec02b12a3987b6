"""Streaming forecast serving on the card: the paper LSTM and the zoo's
dense LMs behind one forecaster interface (``forecaster``),
device-resident decode slots and session cache (``sessions``), a
versioned model registry (``registry``), the micro-batching engine
(``engine``), its telemetry (``telemetry``) and the online-learning
bridge that publishes each training round's average into the live
registry (``hotswap``)."""

from repro_torch.serving.engine import (BatcherConfig, EngineShard,
                                        ServingEngine)
from repro_torch.serving.forecaster import (DecodeSlots, LSTMForecaster,
                                            ZooForecaster,
                                            build_lstm_forecaster,
                                            build_zoo_forecaster)
from repro_torch.serving.hotswap import WeightPublisher, stop_the_world_swap
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
    "WeightPublisher",
    "ZooForecaster",
    "build_lstm_forecaster",
    "build_zoo_forecaster",
    "stop_the_world_swap",
]
