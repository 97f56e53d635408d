"""CoCoA and the paper's two baselines on one card: the GLM objective,
the partitioner, the local solvers, the drivers and the trainers, and
the framework-overhead profiles of the H trade-off (the port of
``repro.core``)."""
from repro_torch.core.glm import (GLMProblem, primal_from_state,  # noqa: F401
                                  primal_objective, ridge_exact,
                                  suboptimality)
from repro_torch.core.cocoa import (CoCoAConfig, CoCoATrainer,  # noqa: F401
                                    History, UniformIndices)
from repro_torch.core.distributed import (COMM_TRANSPORTS,  # noqa: F401
                                          EXCHANGE_MODES, STRAGGLER_KINDS,
                                          CommScheme,
                                          ExchangeConfig, ExchangeMode,
                                          MembershipSchedule,
                                          StragglerProfile,
                                          dequantize_update,
                                          quantize_update)
from repro_torch.core.baselines import (MinibatchSCD,  # noqa: F401
                                        MinibatchSGD, SGDConfig,
                                        UniformRows)
from repro_torch.core.overheads import OverheadProfile, PROFILES  # noqa: F401
