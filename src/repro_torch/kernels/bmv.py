"""Batched matrix-vector products whose summation order is fixed per
worker, as hand-written CUDA kernels (``csrc/bmv.cu``).

  * ``batched_matvec(M, x)``: ``y[k, i] = sum_j M[k, i, j] * x[k, j]``,
    ``M`` (K, r, c), ``x`` one (c,) vector or (K, c) a row a worker;
  * ``batched_vecmat(y, M)``: ``out[k, j] = sum_i y[k, i] * M[k, i, j]``.

Mini-batch SCD's ``A_T @ w`` and Delta v and mini-batch SGD's ``A_s @
alpha`` and ``resid @ A_s`` run through them on both drivers. They
replace no TPU kernel: the reference computes these as XLA dots
(``src/repro/core/solvers.py:97``, ``src/repro/core/baselines.py:112-113``).
What they add is that a worker's outputs are the same bits whether its
block is reduced alone, as on the sharded driver (K = 1), or in the
virtual driver's (K, r, c) stack, in one launch for all K workers. A
library's batched product promises no such thing: its kernel, and any
split of the reduction, follow the batch size.

The plain versions form each product, rounded, and sum them with
``torch.sum`` over the reduced axis, whose order per output does not
depend on the other outputs; they are what the wrappers run on CPU
tensors. On the card the kernels' order is their own (``csrc/bmv.cu``),
so kernel and plain version agree to rounding, not bit for bit. Each
wrapper's ``.launches`` counts its kernel's launches.

Bound on the H100: bytes, the 4*K*r*c of ``M`` read once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check(M: torch.Tensor, v: torch.Tensor, along: int, what: str
           ) -> tuple[int, int, int]:
    if M.dim() != 3 or min(M.shape) < 1:
        raise ValueError(f"{what}: M must be (K, r, c) with K, r, c >= 1, "
                         f"got {tuple(M.shape)}")
    K, n = M.shape[0], M.shape[along]
    if v.shape[-1] != n or v.dim() not in (1, 2) or (
            v.dim() == 2 and v.shape[0] != K):
        raise ValueError(f"{what}: the vector must be ({n},) or ({K}, {n}) "
                         f"for M {tuple(M.shape)}, got {tuple(v.shape)}")
    return tuple(M.shape)


def _rows(v: torch.Tensor, K: int) -> torch.Tensor:
    return v.expand(K, -1) if v.dim() == 1 else v


def batched_matvec_ref(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain ``M (K, r, c) @ x`` -> (K, r): the rounded products, summed
    over c."""
    K, _, _ = _check(M, x, 2, "batched_matvec_ref")
    return torch.sum(M * _rows(x, K)[:, None, :], dim=2)


def batched_vecmat_ref(y: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Plain ``y (K, r) @ M (K, r, c)`` -> (K, c): the rounded products,
    summed over r."""
    K, _, _ = _check(M, y, 1, "batched_vecmat_ref")
    return torch.stack([yk @ Mk for yk, Mk in zip(_rows(y, K), M)])


def _vector(v: torch.Tensor, device, name: str) -> tuple[torch.Tensor, int]:
    """``v`` as a tensor whose row k starts ``stride`` floats after row
    k - 1 (0 for one vector), its last axis contiguous."""
    if v.dim() == 1 or v.stride(0) == 0:
        v = (v if v.dim() == 1 else v[0]).contiguous()
        stride = 0
    else:
        if v.stride(1) != 1:
            v = v.contiguous()
        stride = v.stride(0)
    if v.device != device or v.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got "
                         f"{v.dtype} on {v.device}")
    return v, stride


def batched_matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``M (K, r, c) @ x`` -> (K, r) through the rows-form kernel on the
    card (the plain version on the CPU); a worker's row does not depend
    on K."""
    if M.device.type == "cpu":
        return batched_matvec_ref(M, x)
    _build.require_cuda(M, "batched_matvec")
    K, r, c = _check(M, x, 2, "batched_matvec")
    _build.require(M, "M", dtype=torch.float32, shape=(K, r, c),
                   device=M.device)
    x, stride = _vector(x, M.device, "x")
    fn = _build.function("bmv_rows_launch", [_P, _P, _P, _I, _I, _I, _L, _P])
    y = torch.empty((K, r), dtype=torch.float32, device=M.device)
    err = fn(M.data_ptr(), x.data_ptr(), y.data_ptr(), K, r, c, stride,
             _build.stream_ptr(M.device))
    _build.check_launch(err, "bmv_rows_launch")
    batched_matvec.launches += 1
    return y


def batched_vecmat(y: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``y (K, r) @ M (K, r, c)`` -> (K, c) through the cols-form kernel
    on the card (the plain version on the CPU); a worker's row does not
    depend on K."""
    if M.device.type == "cpu":
        return batched_vecmat_ref(y, M)
    _build.require_cuda(M, "batched_vecmat")
    K, r, c = _check(M, y, 1, "batched_vecmat")
    _build.require(M, "M", dtype=torch.float32, shape=(K, r, c),
                   device=M.device)
    y, stride = _vector(y, M.device, "y")
    fn = _build.function("bmv_cols_launch", [_P, _P, _P, _I, _I, _I, _L, _P])
    out = torch.empty((K, c), dtype=torch.float32, device=M.device)
    err = fn(y.data_ptr(), M.data_ptr(), out.data_ptr(), K, r, c, stride,
             _build.stream_ptr(M.device))
    _build.check_launch(err, "bmv_cols_launch")
    batched_vecmat.launches += 1
    return out


batched_matvec.launches = 0
batched_vecmat.launches = 0
