from repro_torch.core.gateway.gateway import Gateway, RateLimit  # noqa: F401
from repro_torch.core.gateway.router import POLICIES, make_policy  # noqa: F401
