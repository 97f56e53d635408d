"""Model configs: the port of ``repro.configs`` (the dense family so far)."""
from repro_torch.configs.base import (EncDecConfig, MLAConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, padded_vocab)
from repro_torch.configs.registry import (ARCHS, PENDING,  # noqa: F401
                                          get_config, list_archs)
