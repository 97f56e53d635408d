"""Synthetic GLM data: a numpy copy of ``repro.data.synthetic``.

``make_glm_data`` stands in for the paper's webspam corpus (350k x 16.6M
sparse trigram features): a dense matrix with Zipfian column scales,
column sparsity, and labels from a sparse ground truth plus noise. The
order of the ``rng`` calls is the reference's exactly, so the same seed
gives ``array_equal`` arrays in both packages.
"""
from __future__ import annotations

import numpy as np


def make_glm_data(m: int = 2048, n: int = 4096, *, density: float = 0.1,
                  zipf_a: float = 1.1, noise: float = 0.1,
                  truth_density: float = 0.05, seed: int = 0,
                  dtype=np.float32) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (A, b, alpha_true) with A of shape (m, n)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(dtype)
    # Zipfian column scales — webspam-like frequency skew.
    ranks = np.arange(1, n + 1, dtype=np.float64)
    scales = (ranks ** (-1.0 / zipf_a))
    scales /= scales.max()
    rng.shuffle(scales)
    A *= scales.astype(dtype)[None, :]
    # Sparsify columns.
    if density < 1.0:
        mask = rng.random((m, n)) < density
        A = np.where(mask, A, 0.0).astype(dtype)
    # Sparse ground truth + noisy labels.
    alpha_true = np.zeros(n, dtype)
    nz = rng.choice(n, size=max(1, int(truth_density * n)), replace=False)
    alpha_true[nz] = rng.standard_normal(len(nz)).astype(dtype)
    b = A @ alpha_true + noise * rng.standard_normal(m).astype(dtype)
    return A, b.astype(dtype), alpha_true
