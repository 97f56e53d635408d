"""Model configs: the port of ``repro.configs`` (every architecture of
the reference)."""
from repro_torch.configs.base import (EncDecConfig, MLAConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, RGLRUConfig,
                                      SSMConfig, padded_vocab)
from repro_torch.configs.registry import (ARCHS, PENDING,  # noqa: F401
                                          get_config, list_archs)
