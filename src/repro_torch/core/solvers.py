"""Local sub-problem solvers in plain PyTorch (the port of
``repro.core.solvers``), batched over a leading worker axis K.

The CoCoA local subproblem on worker k (elastic net, Appendix A) is
solved by H steps of stochastic coordinate descent with *immediate local
updates*. The closed-form single-coordinate update, with local residual
state ``rho = w + sigma * A dalpha``:

    z_tilde = (sigma*||c_j||^2 * a_j - rho^T c_j) / (sigma*||c_j||^2 + lam*eta)
    z       = soft_threshold(z_tilde, lam*(1-eta)/(sigma*||c_j||^2 + lam*eta))
    rho    += sigma * c_j * (z - a_j)

Layout: the port stores each worker's column block column-major, as
``A_T`` of shape (K, n_pad, m), so column ``j`` of worker ``k`` is the
contiguous row ``A_T[k, j]``. All K workers advance together: step
``s`` visits column ``idx[k, s]`` on every worker ``k`` at once, which
is the reference's ``vmap`` over workers written out.

``scd_steps`` is the plain version of kernel K1
(``repro_torch.kernels.scd``): the kernel holds to it at rtol 1e-4,
atol 1e-5, because it sums each dot product per slab of rows (one slab
a CTA of the worker's cluster) and then over the slabs in rank order.

``scd_steps_fixed_point`` is mini-batch SCD's solve as a loop of H
steps (the reference's op for op); ``scd_steps_fixed_point_batched`` is
its exact batched form, which ``solver="scd_fixed"`` runs on every
device: the reference computes this solve in jnp, not in a kernel.

Coordinate indices are pre-sampled by the caller, so that the plain
version, the kernel and the reference agree given the same index
stream.
"""
from __future__ import annotations

import torch


def soft_threshold(z: torch.Tensor, tau) -> torch.Tensor:
    return torch.sign(z) * torch.clamp(torch.abs(z) - tau, min=0.0)


def _scalars(w: torch.Tensor, sigma: float, lam: float, eta: float):
    """sigma, lam*eta and lam*(1-eta) as f32 tensors on ``w``'s device,
    rounded from the Python products as the reference rounds them."""
    def f32(x):
        return torch.tensor(x, dtype=w.dtype, device=w.device)
    return f32(sigma), f32(lam * eta), f32(lam * (1.0 - eta))


def scd_steps(A_T: torch.Tensor, col_sq: torch.Tensor, alpha: torch.Tensor,
              w: torch.Tensor, idx: torch.Tensor, *, sigma: float,
              lam: float, eta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Run H = idx.shape[1] sequential SCD steps on each of K workers.

    Args:
      A_T:    (K, n_pad, m) column-major local blocks (zero columns ok).
      col_sq: (K, n_pad) squared column norms.
      alpha:  (K, n_pad) local coordinates of alpha.
      w:      (m,) shared residual ``w = A alpha - b`` at round start.
      idx:    (K, H) integer coordinate indices to visit.

    Returns:
      (delta_v (K, m), alpha_new (K, n_pad)): each worker's m-vector
      update ``A_k @ dalpha`` to be all-reduced, and its new block.
    """
    sig, lam_eta, lam_l1 = _scalars(w, sigma, lam, eta)
    K = A_T.shape[0]
    rows = torch.arange(K, device=A_T.device)
    idx = idx.long()
    alpha = alpha.clone()
    rho = w.expand(K, -1).clone()
    for s in range(idx.shape[1]):
        j = idx[:, s]
        c = A_T[rows, j]                                  # (K, m)
        csq = col_sq[rows, j]
        a = alpha[rows, j]
        denom = sig * csq + lam_eta
        # Zero (padded) column -> denom reduces to lam_eta; the guard
        # makes the step an exact no-op instead of a shrinkage of a.
        z_tilde = (sig * csq * a - torch.sum(rho * c, dim=1)) / denom
        z = soft_threshold(z_tilde, lam_l1 / denom)
        z = torch.where(csq > 0, z, a)
        alpha[rows, j] = z
        rho = rho + (sig * (z - a))[:, None] * c
    delta_v = (rho - w) / sig
    return delta_v, alpha


def scd_steps_fixed_point(A_T: torch.Tensor, col_sq: torch.Tensor,
                          alpha: torch.Tensor, w: torch.Tensor,
                          idx: torch.Tensor, *, sigma: float, lam: float,
                          eta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Mini-batch SCD (SDCA-style) — the same coordinate rule WITHOUT
    immediate local updates: every step sees the round-start residual.
    This is the paper's mini-batch baseline; aggregation across the
    batch is damped by 1/sigma at the caller. Same shapes as
    ``scd_steps``."""
    sig, lam_eta, lam_l1 = _scalars(w, sigma, lam, eta)
    K = A_T.shape[0]
    rows = torch.arange(K, device=A_T.device)
    idx = idx.long()
    alpha = alpha.clone()
    dv = torch.zeros((K, w.shape[0]), dtype=w.dtype, device=w.device)
    for s in range(idx.shape[1]):
        j = idx[:, s]
        c = A_T[rows, j]
        csq = col_sq[rows, j]
        a = alpha[rows, j]
        denom = sig * csq + lam_eta
        z_tilde = (sig * csq * a - torch.sum(c * w, dim=1)) / denom  # fixed w
        z = soft_threshold(z_tilde, lam_l1 / denom)
        z = torch.where(csq > 0, z, a)
        alpha[rows, j] = z
        dv = dv + (z - a)[:, None] * c
    return dv, alpha


def scd_steps_fixed_point_batched(A_T: torch.Tensor, col_sq: torch.Tensor,
                                  alpha: torch.Tensor, w: torch.Tensor,
                                  idx: torch.Tensor, *, sigma: float,
                                  lam: float, eta: float
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``scd_steps_fixed_point`` in a batched exact form, with the same
    signature and shapes; the step loop stays as its plain version.

    Every step reads the round-start ``w``, so step ``s`` depends on the
    earlier steps only through ``alpha[k, j_s]``, and a column visited
    again gets the same map again:

        f_j(a) = where(csq_j > 0,
                       soft_threshold((sigma*csq_j*a - d_j) / den_j,
                                      lam*(1-eta) / den_j), a)

    with ``d_j = c_j . w`` and ``den_j = sigma*csq_j + lam*eta``. Hence
    ``alpha_new[k, j] = f_j^cnt[k, j](alpha[k, j])``, where ``cnt`` counts
    the visits of ``j`` in ``idx[k]``: one product ``A_T @ w``, ``max(cnt)``
    elementwise passes over (K, n_pad), and one product of the change
    in alpha with ``A_T`` for Delta v. Each pass takes the loop's ops in
    the loop's order, so alpha is the loop's wherever the dots agree;
    Delta v sums each column once instead of once a visit. Both products
    go through ``kernels.bmv``, whose order is fixed per worker, so a
    worker's block gives the same bits alone (the sharded driver) as in
    the stack. Reading ``max(cnt)`` waits for the device."""
    from repro_torch.kernels.bmv import batched_matvec, batched_vecmat
    sig, lam_eta, lam_l1 = _scalars(w, sigma, lam, eta)
    idx = idx.long()
    cnt = torch.zeros(col_sq.shape, dtype=torch.int32, device=idx.device)
    cnt.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    passes = int(cnt.max())
    d = batched_matvec(A_T, w)                            # (K, n_pad)
    sig_csq = sig * col_sq
    denom = sig_csq + lam_eta
    tau = lam_l1 / denom
    live = col_sq > 0
    a = alpha
    for r in range(passes):
        z = soft_threshold((sig_csq * a - d) / denom, tau)
        a = torch.where(live & (cnt > r), z, a)
    dv = batched_vecmat(a - alpha, A_T)
    return dv, a
