from repro_torch.engine.engine import (EngineConfig,  # noqa: F401
                                       InferenceEngine)
from repro_torch.engine.request import (Request, RequestState,  # noqa: F401
                                        SamplingParams)
from repro_torch.engine.runner import ModelRunner  # noqa: F401
from repro_torch.engine.slot_engine import (SlotEngine,  # noqa: F401
                                            SlotEngineConfig)
from repro_torch.engine.scheduler import (EngineMetrics,  # noqa: F401
                                          ScheduleOutput, Scheduler,
                                          SchedulerConfig)
