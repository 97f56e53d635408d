"""K1: the CoCoA local SCD solve as a hand-written CUDA kernel
(``csrc/scd.cu``), all K workers in one launch.

Replaces the TPU kernel ``repro.kernels.scd.scd_pallas`` (its
``pallas_call`` at ``src/repro/kernels/scd.py:137``, body
``_scd_kernel``). The TPU version streams a pre-gathered (H, m) column
matrix through VMEM on a sequential grid. On Hopper each worker is a
thread-block cluster of C CTAs (grid K*C): CTA rank r owns a slab of
the residual ``rho``'s rows, a producer warp copies each visited column's
slab from the column-major ``A_T`` into a ring of P shared-memory stages
ahead of the step (no pre-gather), and the CTAs meet once a step to
exchange their slab's partial dot through distributed shared memory.
Every CTA keeps the worker's whole ``alpha`` block.

Bound on the H100: first the serial chain of steps (step s+1's dot needs
step s's ``rho``), then bytes. The cluster spreads a step over C SMs
and the ring takes the column loads off the chain, so what stays serial
is one CTA reduction and one cluster rendezvous a step; the note in
``csrc/scd.cu`` says how.

``scd_plan`` picks C, the slab length, the ring depth and the shared
bytes a CTA needs: the largest C in (16, 8, 4, 2, 1) whose K clusters
are all resident at once (``cudaOccupancyMaxActiveClusters``, asked once
per process and shape) and whose CTA fits the 227 KB a block may use.

Its plain version is ``repro_torch.core.solvers.scd_steps``, which the
kernel holds to at rtol 1e-4, atol 1e-5: the dot is summed per slab and
then over the slabs in rank order. ``scd_solve`` takes the plain
version for a CPU tensor and launches the kernel for a CUDA tensor (or
raises); ``scd_solve.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.solvers import scd_steps as scd_steps_plain
from repro_torch.kernels import _build

# dynamic shared memory one block may use on Hopper (227 KB)
SHARED_LIMIT = 232448
CLUSTERS = (16, 8, 4, 2, 1)      # cluster sizes, largest first
RING_MAX = 8                     # deepest prefetch ring
RING_MIN = 2
# the kernel's shape (csrc/scd.cu): 8 consumer warps, at most 64 rows of
# rho a thread, two parities of 8 warp and 16 CTA partials
CONSUMERS = 256
SLAB_MAX = 64 * CONSUMERS
_SCRATCH_WORDS = 2 * 8 + 2 * 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong


@dataclass(frozen=True)
class ScdPlan:
    cluster: int        # C, CTAs per worker
    slab: int           # rows of rho per CTA (a multiple of 4)
    ring: int           # P, prefetch stages
    shared_bytes: int   # dynamic shared memory per CTA


def slab_rows(m: int, cluster: int) -> int:
    """ceil(m / cluster) rounded up to 4 floats, so that every slab but
    the ragged last one is 16-byte sized."""
    rows = -(-m // cluster)
    return -(-rows // 4) * 4


def shared_bytes(slab: int, ring: int, n_pad: int) -> int:
    """What ``scd_shared_bytes`` in ``csrc/scd.cu`` computes: the ring,
    the alpha block, the partials, five scalars a stage (4-byte words,
    rounded up to 8 B) and 2*ring + 2 mbarriers of 8 B."""
    words = ring * slab + n_pad + _SCRATCH_WORDS + 5 * ring
    return 4 * (-(-words // 2) * 2) + 8 * (2 * ring + 2)


def scd_layout(m: int, n_pad: int, cluster: int) -> ScdPlan | None:
    """The layout of one CTA for ``cluster`` CTAs a worker, with the
    deepest ring (up to ``RING_MAX``) that fits the 227 KB, or None when
    not even ``RING_MIN`` stages fit or a slab exceeds the kernel's rows
    a CTA."""
    slab = slab_rows(m, cluster)
    if slab > SLAB_MAX:
        return None
    for ring in range(RING_MAX, RING_MIN - 1, -1):
        smem = shared_bytes(slab, ring, n_pad)
        if smem <= SHARED_LIMIT:
            return ScdPlan(cluster, slab, ring, smem)
    return None


def scd_plan(K: int, m: int, n_pad: int,
             max_active_clusters: Callable[[ScdPlan], int],
             cluster: int | None = None) -> ScdPlan:
    """C, slab, ring depth and shared bytes for K workers of m rows and
    n_pad columns. ``max_active_clusters(plan)`` says how many clusters
    of that plan the device holds at once.

    Without ``cluster``: the largest C of ``CLUSTERS`` whose CTA fits
    227 KB, whose every CTA owns at least one row, and whose K clusters
    are all resident at once (clusters that run in two waves double the
    solve's time). With ``cluster``: that C, if it fits and all K
    clusters are resident. Raises ``ValueError`` with the numbers when
    nothing fits.
    """
    if K < 1 or m < 1 or n_pad < 1:
        raise ValueError(f"scd_plan: empty problem K={K}, n_pad={n_pad}, "
                         f"m={m}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"scd_plan: cluster must be one of {CLUSTERS}, "
                         f"got {cluster}")
    tried = []
    for c in (CLUSTERS if cluster is None else (cluster,)):
        plan = scd_layout(m, n_pad, c)
        if plan is None:
            slab = slab_rows(m, c)
            smem = shared_bytes(slab, RING_MIN, n_pad)
            tried.append(f"C={c}: a slab of {slab} rows" if slab > SLAB_MAX
                         else f"C={c}: {smem} B of shared memory at ring "
                              f"{RING_MIN}")
            continue
        if cluster is None and (c - 1) * plan.slab >= m:
            tried.append(f"C={c}: a CTA would own no row")
            continue
        active = max_active_clusters(plan)
        if active >= K:
            return plan
        tried.append(f"C={c}: {active} clusters resident, {K} needed")
    raise ValueError(
        f"scd_solve: no cluster size fits K={K}, m={m}, n_pad={n_pad} "
        f"(one block may use {SHARED_LIMIT} B (227 KB) of shared memory "
        f"and at most {SLAB_MAX} rows): " + "; ".join(tried))


@functools.cache
def _max_active_clusters(device: int, cluster: int, slab: int,
                         smem: int) -> int:
    fn = _build.function("scd_max_active_clusters", [_I, _I, _LL, _P])
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(cluster, slab, smem, ctypes.byref(out))
    _build.check_launch(err, "scd_max_active_clusters")
    return out.value


def max_active_clusters(device: torch.device, plan: ScdPlan) -> int:
    """``cudaOccupancyMaxActiveClusters`` for ``plan`` on ``device``,
    asked once per process for each plan."""
    return _max_active_clusters(device.index or 0, plan.cluster, plan.slab,
                                plan.shared_bytes)


def scd_solve(A_T: torch.Tensor, col_sq: torch.Tensor, alpha: torch.Tensor,
              w: torch.Tensor, idx: torch.Tensor, *, sigma: float,
              lam: float, eta: float, cluster: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """H = idx.shape[1] SCD steps on each of K workers.

    Shapes as ``scd_steps``: A_T (K, n_pad, m), col_sq (K, n_pad),
    alpha (K, n_pad), w (m,), idx (K, H) int32 with every entry in
    [0, n_pad) -> (delta_v (K, m), alpha_new (K, n_pad)). An index
    outside the block traps the kernel. ``cluster`` forces the CTAs a
    worker (for tests and timing); None plans it.
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
    plan = scd_plan(K, m, n_pad, lambda p: max_active_clusters(dev, p),
                    cluster=cluster)
    fn = _build.function("scd_launch", [_P] * 7 + [_I] * 7 + [_LL]
                         + [_F] * 3 + [_P])
    alpha_out = torch.empty((K, n_pad), dtype=f32, device=dev)
    delta_v = torch.empty((K, m), dtype=f32, device=dev)
    err = fn(A_T.data_ptr(), col_sq.data_ptr(), alpha.data_ptr(),
             w.data_ptr(), idx.data_ptr(), alpha_out.data_ptr(),
             delta_v.data_ptr(), K, n_pad, m, H, plan.cluster, plan.slab,
             plan.ring, plan.shared_bytes, sigma, lam * eta,
             lam * (1.0 - eta), _build.stream_ptr(dev))
    _build.check_launch(err, "scd_launch")
    scd_solve.launches += 1
    scd_solve.last_plan = plan
    return delta_v, alpha_out


scd_solve.launches = 0
scd_solve.last_plan = None
