"""The model zoo's dense decoder: the port of ``repro.models``."""
from repro_torch.models.registry import Model, build_model  # noqa: F401
