"""The model zoo (the dense, SSM and hybrid decoders): the port of
``repro.models``."""
from repro_torch.models.registry import Model, build_model  # noqa: F401
