"""CoCoA and the paper's two baselines on one card: the GLM objective,
the partitioner, the local solvers, the virtual driver and the trainers
(the port of ``repro.core`` for the virtual driver)."""
from repro_torch.core.glm import (GLMProblem, primal_objective,  # noqa: F401
                                  ridge_exact, suboptimality)
from repro_torch.core.cocoa import (CoCoAConfig, CoCoATrainer,  # noqa: F401
                                    History, UniformIndices)
from repro_torch.core.distributed import (COMM_TRANSPORTS,  # noqa: F401
                                          EXCHANGE_MODES, CommScheme,
                                          ExchangeConfig, ExchangeMode,
                                          MembershipSchedule,
                                          StragglerProfile)
from repro_torch.core.baselines import (MinibatchSCD,  # noqa: F401
                                        MinibatchSGD, SGDConfig,
                                        UniformRows)
