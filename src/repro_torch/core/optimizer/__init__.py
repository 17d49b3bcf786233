from repro_torch.core.optimizer.gpu_optimizer import (GPUOptimizer, LoadMonitor,  # noqa: F401
                                                RoleSplit, homogeneous_cost,
                                                split_roles)
from repro_torch.core.optimizer.profiles import (DEVICES, PerfModel,  # noqa: F401
                                           ProfileTable, WorkloadBucket)
