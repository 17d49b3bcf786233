from repro_torch.core.autoscaler.metrics import MetricStore, SlidingWindow  # noqa: F401
from repro_torch.core.autoscaler.policies import (APA, AUTOSCALERS, HPA, KPA,  # noqa: F401
                                            make_autoscaler)
