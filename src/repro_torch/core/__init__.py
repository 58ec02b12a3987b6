"""The paper's technique: asynchronous local SGD with linearly increasing
sample sequences and model-exchange aggregation.

- ``SampleSchedule`` / ``ConstantSchedule`` / ``StepSizeSchedule``: Table I.
- ``AsyncLocalSGD``: the round loop over worker-stacked params.
- ``sync_step``: the synchronous minibatch SGD baseline.
- ``AsyncSimulator`` / ``SimConfig``: the event-driven simulator of
  the paper's experiment (Table II's speedups).
- ``ConstantDelay`` / ``SqrtLogDelay`` / ``NetworkDelay``: delay
  models tau(t) (Definition 1).
"""

from repro_torch.core.async_local_sgd import (AsyncLocalSGD, LocalSGDConfig,
                                              local_sgd_round, sync_step)
from repro_torch.core.delay import (ConstantDelay, NetworkDelay,
                                    SqrtLogDelay, check_consistent)
from repro_torch.core.schedules import (ConstantSchedule, SampleSchedule,
                                        StepSizeSchedule,
                                        communication_rounds_constant,
                                        round_step_sizes)
from repro_torch.core.simulator import AsyncSimulator, SimConfig

__all__ = ["AsyncLocalSGD", "AsyncSimulator", "ConstantDelay",
           "ConstantSchedule", "LocalSGDConfig", "NetworkDelay",
           "SampleSchedule", "SimConfig", "SqrtLogDelay", "StepSizeSchedule",
           "check_consistent", "communication_rounds_constant",
           "local_sgd_round", "round_step_sizes", "sync_step"]
