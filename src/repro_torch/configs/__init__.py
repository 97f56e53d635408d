"""Model configs: the port of ``repro.configs`` (the dense, SSM and hybrid
families so far)."""
from repro_torch.configs.base import (EncDecConfig, MLAConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, RGLRUConfig,
                                      SSMConfig, padded_vocab)
from repro_torch.configs.registry import (ARCHS, PENDING,  # noqa: F401
                                          get_config, list_archs)
