"""Generalized linear model objectives for the paper's workload (the
port of ``repro.core.glm``).

The paper trains elastic-net-regularized least squares (ridge for eta=1):

    P(alpha) = 1/2 ||A alpha - b||^2
               + lam * ( eta/2 ||alpha||^2 + (1-eta) ||alpha||_1 )

with the data matrix ``A`` partitioned **column-wise** across workers.

Every function here takes tensors and works on their device. The
reference solves the n x n ridge system on the host in numpy; at the
sizes the card runs (n = 32768) that is an 8.6 GB f64 matrix, so the
port solves on the tensors' device, through the smaller of the two
Gram matrices (see ``ridge_exact``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.utils.device import full_f32_matmul


@dataclass(frozen=True)
class GLMProblem:
    """An elastic-net regression problem instance."""
    lam: float = 1.0         # regularization strength
    eta: float = 1.0         # 1.0 => pure ridge; 0.0 => pure lasso

    def regularizer(self, alpha: torch.Tensor) -> torch.Tensor:
        """Over the last axis: a leading K axis gives one value per
        worker."""
        l2 = 0.5 * self.eta * torch.sum(alpha * alpha, dim=-1)
        l1 = (1.0 - self.eta) * torch.sum(torch.abs(alpha), dim=-1)
        return self.lam * (l2 + l1)

    def loss(self, residual: torch.Tensor) -> torch.Tensor:
        """f(v) = 1/2 ||v - b||^2 expressed on the residual w = v - b."""
        return 0.5 * torch.sum(residual * residual)


def primal_objective(problem: GLMProblem, A: torch.Tensor, b: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    full_f32_matmul()
    r = A @ alpha - b
    return problem.loss(r) + problem.regularizer(alpha)


def primal_from_state(problem: GLMProblem, w: torch.Tensor,
                      reg_sum: torch.Tensor) -> torch.Tensor:
    """The objective from the shared residual ``w = A alpha - b`` and the
    regularizer's value (summed over the workers): what the master can
    evaluate without gathering alpha (the persistent-local-memory
    scheme)."""
    return problem.loss(w) + reg_sum


def ridge_exact(A: torch.Tensor, b: torch.Tensor, lam: float) -> torch.Tensor:
    """Closed-form ridge solution (eta=1), float64, on ``A``'s device.

    The reference's precision steps are kept: the Gram matrix of the f32
    matrix is formed in f32, and the system is solved in f64. For
    m >= n that is the reference's own system
    ``(A^T A + lam I) alpha = A^T b``. For m < n the port solves the
    m x m push-through form ``alpha = A^T (A A^T + lam I)^-1 b``, which
    has the same solution; it differs from the reference only in which
    f32 Gram is rounded, and ``p_star`` is flat to first order in
    ``alpha`` at the optimum, so the objective agrees to f32 rounding.
    The m x m form is what makes the solve fit: n = 32768 would need an
    8.6 GB f64 matrix and ~1e13 host operations.
    """
    full_f32_matmul()
    m, n = A.shape
    if m < n:
        G = (A @ A.T).to(torch.float64)
        G.diagonal().add_(lam)
        y = torch.linalg.solve(G, b.to(torch.float64))
        return A.T.to(torch.float64) @ y
    G = (A.T @ A).to(torch.float64)
    G.diagonal().add_(lam)
    return torch.linalg.solve(G, (A.T @ b).to(torch.float64))


def optimal_objective(problem: GLMProblem, A: torch.Tensor, b: torch.Tensor,
                      n_iters: int = 200_000) -> float:
    """High-precision P* — closed form for ridge, else proximal gradient
    (FISTA, f32, as the reference runs it)."""
    if problem.eta == 1.0:
        alpha = ridge_exact(A, b, problem.lam)
        return float(primal_objective(problem, A, b, alpha.to(A.dtype)))
    full_f32_matmul()
    L = float(torch.linalg.matrix_norm(A, ord=2)) ** 2 \
        + problem.lam * problem.eta
    thresh = problem.lam * (1.0 - problem.eta) / L
    n = A.shape[1]
    alpha = torch.zeros(n, dtype=A.dtype, device=A.device)
    y = torch.zeros_like(alpha)
    t = torch.ones((), dtype=A.dtype, device=A.device)
    for _ in range(min(n_iters, 20000)):
        grad = A.T @ (A @ y - b) + problem.lam * problem.eta * y
        z = y - grad / L
        alpha_new = torch.sign(z) * torch.clamp(torch.abs(z) - thresh, min=0.0)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = alpha_new + (t - 1.0) / t_new * (alpha_new - alpha)
        alpha, t = alpha_new, t_new
    return float(primal_objective(problem, A, b, alpha))


def suboptimality(p_now: float, p_star: float, p_zero: float) -> float:
    """Normalized suboptimality in [0, 1]:  (P - P*) / (P(0) - P*)."""
    denom = max(p_zero - p_star, 1e-30)
    return max(p_now - p_star, 0.0) / denom
