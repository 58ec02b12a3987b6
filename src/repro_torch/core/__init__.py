"""The paper's technique: asynchronous local SGD with linearly increasing
sample sequences and model-exchange aggregation.

- ``SampleSchedule`` / ``ConstantSchedule`` / ``StepSizeSchedule``: Table I.
- ``AsyncLocalSGD``: the round loop over worker-stacked params.
- ``sync_step``: the synchronous minibatch SGD baseline.

The event-driven simulator and the delay models of ``repro.core`` wait
for a later slice of the port.
"""

from repro_torch.core.async_local_sgd import (AsyncLocalSGD, LocalSGDConfig,
                                              local_sgd_round, sync_step)
from repro_torch.core.schedules import (ConstantSchedule, SampleSchedule,
                                        StepSizeSchedule,
                                        communication_rounds_constant,
                                        round_step_sizes)

__all__ = ["AsyncLocalSGD", "ConstantSchedule", "LocalSGDConfig",
           "SampleSchedule", "StepSizeSchedule",
           "communication_rounds_constant", "local_sgd_round",
           "round_step_sizes", "sync_step"]
