from repro_torch.models.config import ModelConfig, reduced  # noqa: F401
from repro_torch.models import model  # noqa: F401
