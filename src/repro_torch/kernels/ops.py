"""Public wrapper around kernel K1 (the port of ``repro.kernels.ops``).

``scd_steps_kernel`` has the contract of the plain solver
``repro_torch.core.solvers.scd_steps`` — ``(delta_v, alpha_new)`` with
``delta_v = (rho - w)/sigma`` — so the two are interchangeable as CoCoA
local solvers (``CoCoAConfig.solver``). Unlike the reference's wrapper
it gathers nothing: the kernel reads each visited column from the
column-major ``A_T`` itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.scd import scd_solve


def scd_steps_kernel(A_T: torch.Tensor, col_sq: torch.Tensor,
                     alpha: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                     *, sigma: float, lam: float, eta: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """H SCD steps on each of K workers through K1 (its plain version
    for CPU tensors). Shapes as ``scd_steps``."""
    return scd_solve(A_T, col_sq, alpha, w, idx.to(torch.int32),
                     sigma=sigma, lam=lam, eta=eta)
