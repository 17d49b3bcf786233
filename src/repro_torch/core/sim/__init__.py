from repro_torch.core.sim.cluster_sim import ClusterConfig, ServingCluster  # noqa: F401
from repro_torch.core.sim.events import EventLoop, SimClock  # noqa: F401
from repro_torch.core.sim.sim_engine import SimEngine, SimEngineConfig  # noqa: F401
from repro_torch.core.sim import workloads  # noqa: F401
