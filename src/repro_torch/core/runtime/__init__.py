from repro_torch.core.runtime.sidecar import (AIRuntime, ColdStartManager,  # noqa: F401
                                        ModelArtifact, load_time_s)
