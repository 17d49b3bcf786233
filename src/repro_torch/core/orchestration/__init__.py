from repro_torch.core.orchestration.cluster import (ClusterManager, EngineGroup,  # noqa: F401
                                              GroupSpec, Pod, PodState)
from repro_torch.core.orchestration.pools import (AttainmentRebalancer,  # noqa: F401
                                            Migration, RebalanceConfig,
                                            RolePoolManager,
                                            parse_role_spec)
