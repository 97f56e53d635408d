"""A plain CoCoA round (ridge regression over K column blocks: H local
SCD steps a worker, the int8 exchange of the updates, the residual
apply), the primal objective, the balanced partition and P*.

For ridge (eta = 1) the H sequential coordinate steps of one worker are
a lower-triangular linear system in the steps' moves. Step s visits
column c_s (norm q_s) and moves its coordinate by

    d_s = -(rho_s . c_s + lam a_s) / (sigma q_s + lam),
    rho_s = w + sigma sum_{r<s} c_r d_r,   a_s = alpha[j_s] + sum_{r<s, j_r = j_s} d_r,

so (diag(sigma q + lam) + sigma tril(G, -1) + lam E) d = -(C w + lam alpha[j])
with G = C C^T the visited columns' Gram matrix and E the strictly lower
"same column" indicator. One Gram product and one triangular solve a
worker give the moves that H sequential steps give, each to rounding;
the worker's update is C^T d. The reference computes in float64; the
control (``tf32=True``) computes the same in float32 with every
product's inputs rounded to TF32, as the card's TF32 tensor cores take
them. P* is the ridge optimum in float64 through the n x n system:
P* = (b^T b - c^T (A^T A + lam I)^-1 c) / 2 with c = A^T b.

The matrix is held transposed, ``A_T`` (n, m), so that a worker's
columns are rows.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

INT8_QMAX = 127.0
INT8_EPS = 1e-30
BLOCK = 16384        # rows of A a float64 block of P* takes at once


@dataclass
class Partition:
    owned: list          # per worker: the sorted column ids (int64 tensors)

    @property
    def sizes(self) -> list:
        return [int(o.numel()) for o in self.owned]


def balanced_partition(A_T: torch.Tensor, K: int) -> Partition:
    """Greedy largest-first bin packing of the columns by their nonzero
    counts: each column, most nonzeros first (ties in column order),
    goes to the worker with the least load so far (ties to the lowest
    worker)."""
    nnz = (A_T != 0).sum(dim=1).cpu().numpy().astype(np.int64)
    order = np.argsort(-nnz, kind="stable")
    heap = [(0, k) for k in range(K)]
    buckets = [[] for _ in range(K)]
    for j in order.tolist():
        load, k = heapq.heappop(heap)
        buckets[k].append(j)
        heapq.heappush(heap, (load + int(nnz[j]), k))
    return Partition([torch.tensor(sorted(bk), dtype=torch.int64,
                                   device=A_T.device) for bk in buckets])


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 rounded to TF32's 10 mantissa bits (to nearest,
    ties to even)."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Products:
    """The matrix products of a computation: float64, or (``tf32``)
    float32 on TF32-rounded inputs with TF32 on, as the card runs it."""

    def __init__(self, tf32_on: bool):
        self.tf32 = tf32_on
        self.dtype = torch.float32 if tf32_on else torch.float64

    def cast(self, x):
        return tf32(x) if self.tf32 else x.to(torch.float64)

    def mm(self, a, b):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            return self.cast(a) @ self.cast(b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def ridge_optimum(A_T: torch.Tensor, b: torch.Tensor, lam: float,
                  tf32_on: bool = False) -> float:
    """P* of 1/2 ||A alpha - b||^2 + lam/2 ||alpha||^2: A^T A and A^T b
    formed in blocks of rows of A (float64, or TF32 for the control) and
    the n x n system solved in float64."""
    p = _Products(tf32_on)
    n, m = A_T.shape
    G = torch.zeros((n, n), dtype=torch.float64, device=A_T.device)
    c = torch.zeros((n,), dtype=torch.float64, device=A_T.device)
    for s in range(0, m, BLOCK):
        X = A_T[:, s:s + BLOCK]
        G += p.mm(X, X.T).double()
        c += p.mm(X, b[s:s + BLOCK, None])[:, 0].double()
        del X
    G.diagonal().add_(lam)
    y = torch.linalg.solve(G, c)
    b64 = b.double()
    return float(0.5 * (torch.dot(b64, b64) - torch.dot(c, y)))


def int8_sum(dv: torch.Tensor) -> torch.Tensor:
    """The int8 exchange of a (K, L) stack, in ``dv``'s precision: each
    row quantized to [-127, 127] against its absmax (scale absmax/127 +
    1e-30, 1 for an all-zero row), rounded half to even, and the decoded
    rows summed in worker order."""
    absmax = dv.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / INT8_QMAX + INT8_EPS,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(dv / scale[:, None]), -INT8_QMAX, INT8_QMAX)
    total = q[0] * scale[0]
    for k in range(1, dv.shape[0]):
        total = total + q[k] * scale[k]
    return total


def primal(alpha: torch.Tensor, w: torch.Tensor, lam: float,
           tf32_on: bool = False) -> float:
    """1/2 ||w||^2 + lam/2 ||alpha||^2 with w = A alpha - b the residual:
    float64 sums, or (the control) float32 sums of TF32-rounded
    squares."""
    if tf32_on:
        w, alpha = tf32(w), tf32(alpha).reshape(-1)
        return float(0.5 * torch.sum(w * w) + 0.5 * lam * torch.sum(
            alpha * alpha))
    w, alpha = w.double(), alpha.double().reshape(-1)
    return float(0.5 * torch.dot(w, w) + 0.5 * lam * torch.dot(alpha, alpha))


@dataclass
class Step:
    dalpha: torch.Tensor   # (K, n_pad) the moves, by worker and slot
    total: torch.Tensor    # (m,) the exchanged sum of the updates


def round_from(A_T: torch.Tensor, part: Partition, alpha: torch.Tensor,
               w: torch.Tensor, idx: torch.Tensor, *, lam: float,
               sigma: float, exchange: str = "compressed:int8",
               tf32_on: bool = False) -> Step:
    """One CoCoA round from the state ``alpha`` (K, n_pad: worker k's
    slot j is its column ``part.owned[k][j]``) and residual ``w`` (m,)
    on the (K, H) draw ``idx`` of slots: every worker's H steps, and the
    int8 exchange of their updates (``persistent``: the plain sum)."""
    p = _Products(tf32_on)
    K, H = idx.shape
    dalpha = torch.zeros(alpha.shape, dtype=p.dtype, device=alpha.device)
    dv = torch.empty((K, w.shape[0]), dtype=p.dtype, device=w.device)
    for k in range(K):
        pos = idx[k].long()
        uniq, inv = torch.unique(pos, return_inverse=True)
        U = A_T.index_select(0, part.owned[k][uniq])        # (u, m)
        Gu = p.mm(U, U.T)
        Uw = p.mm(U, w[:, None])[:, 0]
        G = Gu[inv][:, inv]
        same = (pos[:, None] == pos[None, :]).to(p.dtype)
        T = sigma * torch.tril(G, -1) + lam * torch.tril(same, -1)
        T.diagonal().copy_(sigma * Gu.diagonal()[inv] + lam)
        rhs = -(Uw[inv] + lam * p.cast(alpha[k, pos]))
        d = torch.linalg.solve_triangular(T, rhs[:, None], upper=False)[:, 0]
        del T, G, same, Gu
        dsum = torch.zeros((uniq.numel(),), dtype=p.dtype, device=d.device)
        dsum.index_add_(0, inv, d)
        dv[k] = p.mm(dsum[None, :], U)[0]
        dalpha[k].index_add_(0, pos, d)
        del U
    total = int8_sum(dv) if exchange == "compressed:int8" else dv.sum(dim=0)
    return Step(dalpha, total)
