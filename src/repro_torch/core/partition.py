"""Column partitioning of the data matrix across workers: a numpy copy
of ``repro.core.partition`` plus the port's column-major packer.

Two strategies, mirroring the paper:
  * ``block``     — contiguous equal-width column blocks.
  * ``balanced``  — the paper's MPI load-balancing partitioner: greedy
                    bin-packing so that sum_i nnz(c_i) is roughly equal
                    per partition.

``pack_columns`` produces the reference's stacked (K, m, n_pad) layout.
The port's trainer and kernel K1 use ``pack_columns_t`` instead: the
transposed (K, n_pad, m) stack, in which each column is contiguous, so
one SCD step reads its column with coalesced loads and needs no
pre-gather.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Partition:
    K: int
    # index sets: list of np arrays of column ids, one per worker
    owned: tuple
    n_padded: int  # common padded width

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(p) for p in self.owned])


def block_partition(n: int, K: int) -> Partition:
    ids = np.arange(n)
    chunks = np.array_split(ids, K)
    n_pad = max(len(c) for c in chunks)
    return Partition(K=K, owned=tuple(chunks), n_padded=n_pad)


def balanced_partition(nnz_per_col: np.ndarray, K: int) -> Partition:
    """Greedy largest-first bin packing on per-column nonzero counts."""
    n = len(nnz_per_col)
    order = np.argsort(-nnz_per_col, kind="stable")
    loads = np.zeros(K)
    buckets: list[list[int]] = [[] for _ in range(K)]
    for j in order:
        k = int(np.argmin(loads))
        buckets[k].append(int(j))
        loads[k] += nnz_per_col[j]
    owned = tuple(np.array(sorted(bkt), dtype=np.int64) for bkt in buckets)
    n_pad = max(len(b) for b in buckets)
    return Partition(K=K, owned=owned, n_padded=n_pad)


def partition_imbalance(part: Partition, nnz_per_col: np.ndarray) -> float:
    """max/mean per-worker nnz load — 1.0 is perfectly balanced."""
    loads = np.array([nnz_per_col[p].sum() for p in part.owned], dtype=np.float64)
    return float(loads.max() / max(loads.mean(), 1e-12))


def pack_columns(A: np.ndarray, part: Partition) -> tuple[np.ndarray, np.ndarray]:
    """Stack worker column-blocks into (K, m, n_pad) with zero padding.

    Returns (A_stacked, mask) where mask is (K, n_pad) with 1.0 for real
    columns. Zero-padded columns have zero norm; the SCD solvers guard
    against picking them (update is exactly 0 for an all-zero column, and
    the sampling distribution masks them out).
    """
    m, _ = A.shape
    K, n_pad = part.K, part.n_padded
    out = np.zeros((K, m, n_pad), dtype=A.dtype)
    mask = np.zeros((K, n_pad), dtype=A.dtype)
    for k, ids in enumerate(part.owned):
        out[k, :, : len(ids)] = A[:, ids]
        mask[k, : len(ids)] = 1.0
    return out, mask


def pack_columns_t(A: torch.Tensor, part: Partition
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The column-major stack ``(K, n_pad, m)`` and its ``(K, n_pad)``
    mask, built on ``A``'s device: ``pack_columns`` transposed, with
    each worker's real columns first and zero columns after them."""
    m, _ = A.shape
    K, n_pad = part.K, part.n_padded
    out = torch.zeros((K, n_pad, m), dtype=A.dtype, device=A.device)
    mask = torch.zeros((K, n_pad), dtype=A.dtype, device=A.device)
    for k, ids in enumerate(part.owned):
        cols = torch.as_tensor(ids, dtype=torch.int64, device=A.device)
        out[k, : len(ids)] = A.index_select(1, cols).T
        mask[k, : len(ids)] = 1.0
    return out, mask


def unpack_alpha(alpha_stacked: np.ndarray, part: Partition, n: int) -> np.ndarray:
    """Scatter stacked per-worker alpha blocks back to global coordinates."""
    alpha = np.zeros(n, dtype=alpha_stacked.dtype)
    for k, ids in enumerate(part.owned):
        alpha[ids] = alpha_stacked[k, : len(ids)]
    return alpha
