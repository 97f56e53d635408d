"""K1: the CoCoA local SCD solve as a hand-written CUDA kernel
(``csrc/scd.cu``), all K workers in one launch.

Replaces the TPU kernel ``repro.kernels.scd.scd_pallas`` (its
``pallas_call`` at ``src/repro/kernels/scd.py:137``, body
``_scd_kernel``). The TPU version streams a pre-gathered (H, m) column
matrix through VMEM on a sequential grid; on Hopper one CTA per worker
runs its H steps in a loop inside the block, reads each visited column
straight from the column-major ``A_T`` (no pre-gather) and keeps the
residual ``rho`` and the worker's ``alpha`` block in shared memory.

Bound on the H100: the serial step dependency, not bytes — each step is
a column load, a block-wide reduction and two barriers, on K of the 132
SMs. The note in ``csrc/scd.cu`` says what the design does about it.

Its plain version is ``repro_torch.core.solvers.scd_steps``, which the
kernel holds to at rtol 1e-4, atol 1e-5 (the dot product is summed in
another order). ``scd_solve`` takes the plain version for a CPU tensor
and launches the kernel for a CUDA tensor; ``scd_solve.launches``
counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.solvers import scd_steps as scd_steps_plain
from repro_torch.kernels import _build

# dynamic shared memory one block may use on Hopper (227 KB)
SHARED_LIMIT = 232448

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def scd_solve(A_T: torch.Tensor, col_sq: torch.Tensor, alpha: torch.Tensor,
              w: torch.Tensor, idx: torch.Tensor, *, sigma: float,
              lam: float, eta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """H = idx.shape[1] SCD steps on each of K workers.

    Shapes as ``scd_steps``: A_T (K, n_pad, m), col_sq (K, n_pad),
    alpha (K, n_pad), w (m,), idx (K, H) int32 with every entry in
    [0, n_pad) -> (delta_v (K, m), alpha_new (K, n_pad)). An index
    outside the block traps the kernel.
    """
    if A_T.device.type == "cpu":
        return scd_steps_plain(A_T, col_sq, alpha, w, idx, sigma=sigma,
                               lam=lam, eta=eta)
    _build.require_cuda(A_T, "scd_solve")
    dev = A_T.device
    if A_T.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"scd_solve: A_T must be (K, n_pad, m) and idx "
                         f"(K, H), got {tuple(A_T.shape)} and "
                         f"{tuple(idx.shape)}")
    K, n_pad, m = A_T.shape
    H = idx.shape[1]
    f32 = torch.float32
    _build.require(A_T, "A_T", dtype=f32, shape=(K, n_pad, m), device=dev)
    _build.require(col_sq, "col_sq", dtype=f32, shape=(K, n_pad), device=dev)
    _build.require(alpha, "alpha", dtype=f32, shape=(K, n_pad), device=dev)
    _build.require(w, "w", dtype=f32, shape=(m,), device=dev)
    _build.require(idx, "idx", dtype=torch.int32, shape=(K, H), device=dev)
    if K < 1 or m < 1 or n_pad < 1:
        raise ValueError(f"scd_solve: empty problem K={K}, n_pad={n_pad}, "
                         f"m={m}")
    smem = _build.function("scd_shared_bytes", [_I, _I],
                           ctypes.c_longlong)(m, n_pad)
    if smem > SHARED_LIMIT:
        raise ValueError(
            f"scd_solve: rho and alpha need {smem} bytes of shared memory "
            f"(4*(m + n_pad) plus scratch at m={m}, n_pad={n_pad}); one "
            f"block may use at most {SHARED_LIMIT} (227 KB) — a larger m "
            f"needs the thread-block-cluster design")
    fn = _build.function("scd_launch", [_P] * 7 + [_I] * 4 + [_F] * 3 + [_P])
    alpha_out = torch.empty((K, n_pad), dtype=f32, device=dev)
    delta_v = torch.empty((K, m), dtype=f32, device=dev)
    err = fn(A_T.data_ptr(), col_sq.data_ptr(), alpha.data_ptr(),
             w.data_ptr(), idx.data_ptr(), alpha_out.data_ptr(),
             delta_v.data_ptr(), K, n_pad, m, H, sigma, lam * eta,
             lam * (1.0 - eta), _build.stream_ptr(dev))
    _build.check_launch(err, "scd_launch")
    scd_solve.launches += 1
    return delta_v, alpha_out


scd_solve.launches = 0
