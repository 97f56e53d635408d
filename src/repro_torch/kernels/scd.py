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

``scd_plan`` picks C, the slab length, the ring depth, the shared bytes
a CTA needs and where ``rho`` and ``alpha`` live. First the layout that
holds ``rho``'s slab in registers and ``alpha`` in shared memory: the
largest C in (16, 8, 4, 2, 1) whose K clusters are all resident at once
(``cudaOccupancyMaxActiveClusters``, asked once per process and shape)
and whose CTA fits the 227 KB a block may use. Only where no C of that
layout fits (a slab past 16,384 rows, m > 262,144 at C = 16; or an
``alpha`` block past the shared memory left, n_pad >= 55,995 at
m = 16,384) it takes the next of ``VARIANTS``: ``alpha`` in a private
copy per CTA in device memory; ``rho``'s slab streamed, its column
passed through the ring twice a step (the dot, then the update) in
stages of up to 4096 rows, with the slab in shared memory where it fits
beside two stages, else in device memory.

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
# rho a thread in registers, two parities of 8 warp and 16 CTA partials
CONSUMERS = 256
SLAB_MAX = 64 * CONSUMERS
_SCRATCH_WORDS = 2 * 8 + 2 * 16
# rows a ring stage holds at most when rho is streamed
STAGE_ROWS = 4096
# where rho's slab and alpha live, in the order the plan tries them
VARIANTS = (("registers", "shared"), ("registers", "device"),
            ("shared", "shared"), ("shared", "device"),
            ("device", "shared"), ("device", "device"))
_RHO = {"registers": 0, "shared": 1, "device": 2}
# the kernel indexes rows and columns with int32
INDEX_MAX = 2**31 - 1

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_LAUNCH = [_P] * 8 + [_I] * 9 + [_LL] + [_F] * 3 + [_P]


@dataclass(frozen=True)
class ScdPlan:
    cluster: int        # C, CTAs per worker
    slab: int           # rows of rho per CTA (a multiple of 4)
    ring: int           # P, prefetch stages
    shared_bytes: int   # dynamic shared memory per CTA
    rho: str = "registers"   # or "shared", "device": the slab streamed
    alpha: str = "shared"    # or "device": a private copy per CTA

    @property
    def stage(self) -> int:
        """Rows a ring stage holds: the slab when rho is in registers,
        else up to ``STAGE_ROWS``."""
        return self.slab if self.rho == "registers" else min(self.slab,
                                                             STAGE_ROWS)

    @property
    def variant(self) -> str:
        return f"rho in {self.rho}, alpha in {self.alpha}"


def slab_rows(m: int, cluster: int) -> int:
    """ceil(m / cluster) rounded up to 4 floats, so that every slab but
    the ragged last one is 16-byte sized."""
    rows = -(-m // cluster)
    return -(-rows // 4) * 4


def shared_bytes(stage: int, ring: int, n_alpha: int, n_rho: int = 0
                 ) -> int:
    """What ``scd_shared_bytes`` in ``csrc/scd.cu`` computes: the ring of
    ``ring`` stages of ``stage`` rows, ``n_alpha`` floats of alpha (the
    worker's n_pad, or 0 when alpha lives in device memory), ``n_rho`` of
    rho (the slab when it lives in shared memory), the partials, five
    scalars a stage (4-byte words, rounded up to 8 B) and 2*ring + 2
    mbarriers of 8 B."""
    words = ring * stage + n_alpha + n_rho + _SCRATCH_WORDS + 5 * ring
    return 4 * (-(-words // 2) * 2) + 8 * (2 * ring + 2)


def scd_layout(m: int, n_pad: int, cluster: int, rho: str = "registers",
               alpha: str = "shared") -> ScdPlan | None:
    """The layout of one CTA for ``cluster`` CTAs a worker with ``rho``
    and ``alpha`` where they say, with the deepest ring (up to
    ``RING_MAX``) that fits the 227 KB, or None when not even
    ``RING_MIN`` stages fit or (rho in registers) a slab exceeds the
    kernel's rows a CTA."""
    slab = slab_rows(m, cluster)
    if rho == "registers" and slab > SLAB_MAX:
        return None
    plan = ScdPlan(cluster, slab, RING_MIN, 0, rho, alpha)
    n_alpha = n_pad if alpha == "shared" else 0
    n_rho = slab if rho == "shared" else 0
    for ring in range(RING_MAX, RING_MIN - 1, -1):
        smem = shared_bytes(plan.stage, ring, n_alpha, n_rho)
        if smem <= SHARED_LIMIT:
            return ScdPlan(cluster, slab, ring, smem, rho, alpha)
    return None


def scd_plan(K: int, m: int, n_pad: int,
             max_active_clusters: Callable[[ScdPlan], int],
             cluster: int | None = None) -> ScdPlan:
    """C, slab, ring depth, shared bytes and variant for K workers of m
    rows and n_pad columns. ``max_active_clusters(plan)`` says how many
    clusters of that plan the device holds at once.

    The variants are tried in the order of ``VARIANTS``, each at every
    C, so a later one is taken only where no C of the earlier ones fits.
    Without ``cluster``: the largest C of ``CLUSTERS`` whose CTA fits
    227 KB, whose every CTA owns at least one row, and whose K clusters
    are all resident at once (clusters that run in two waves double the
    solve's time). With ``cluster``: that C, if it fits and all K
    clusters are resident. Raises ``ValueError`` with the numbers when
    nothing fits (then it is residency) or m or n_pad passes int32.
    """
    if K < 1 or m < 1 or n_pad < 1:
        raise ValueError(f"scd_plan: empty problem K={K}, n_pad={n_pad}, "
                         f"m={m}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"scd_plan: cluster must be one of {CLUSTERS}, "
                         f"got {cluster}")
    if max(m, n_pad) > INDEX_MAX:
        raise ValueError(f"scd_solve: m={m} and n_pad={n_pad} must each be "
                         f"at most {INDEX_MAX} (the kernel's int32 indices)")
    tried = []
    for rho, alpha in VARIANTS:
        for c in (CLUSTERS if cluster is None else (cluster,)):
            plan = scd_layout(m, n_pad, c, rho, alpha)
            name = f"C={c} (rho in {rho}, alpha in {alpha})"
            if plan is None:
                slab = slab_rows(m, c)
                tried.append(
                    f"{name}: a slab of {slab} rows"
                    if rho == "registers" and slab > SLAB_MAX else
                    f"{name}: over {SHARED_LIMIT} B of shared memory at "
                    f"ring {RING_MIN}")
                continue
            if cluster is None and (c - 1) * plan.slab >= m:
                tried.append(f"{name}: a CTA would own no row")
                continue
            active = max_active_clusters(plan)
            if active >= K:
                return plan
            tried.append(f"{name}: {active} clusters resident, {K} needed")
    raise ValueError(
        f"scd_solve: no cluster size fits K={K}, m={m}, n_pad={n_pad} "
        f"(one block may use {SHARED_LIMIT} B (227 KB) of shared memory "
        f"and hold at most {SLAB_MAX} rows in registers): "
        + "; ".join(tried))


@functools.cache
def _max_active_clusters(device: int, cluster: int, slab: int, rho: int,
                         alpha_dev: int, smem: int) -> int:
    fn = _build.function("scd_max_active_clusters",
                         [_I, _I, _I, _I, _LL, _P])
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(cluster, slab, rho, alpha_dev, smem, ctypes.byref(out))
    _build.check_launch(err, "scd_max_active_clusters")
    return out.value


def max_active_clusters(device: torch.device, plan: ScdPlan) -> int:
    """``cudaOccupancyMaxActiveClusters`` for ``plan`` on ``device``,
    asked once per process for each plan."""
    return _max_active_clusters(device.index or 0, plan.cluster, plan.slab,
                                _RHO[plan.rho], int(plan.alpha == "device"),
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
    fn = _build.function("scd_launch", _LAUNCH)
    alpha_out = torch.empty((K, n_pad), dtype=f32, device=dev)
    delta_v = torch.empty((K, m), dtype=f32, device=dev)
    # alpha in device memory: each CTA's private copy of its worker's block
    priv = (torch.empty((K * plan.cluster, n_pad), dtype=f32, device=dev)
            if plan.alpha == "device" else None)
    err = fn(A_T.data_ptr(), col_sq.data_ptr(), alpha.data_ptr(),
             w.data_ptr(), idx.data_ptr(), alpha_out.data_ptr(),
             delta_v.data_ptr(), None if priv is None else priv.data_ptr(),
             K, n_pad, m, H, plan.cluster, plan.slab, plan.stage, plan.ring, _RHO[plan.rho], plan.shared_bytes, sigma, lam * eta,
             lam * (1.0 - eta), _build.stream_ptr(dev))
    _build.check_launch(err, "scd_launch")
    scd_solve.launches += 1
    scd_solve.last_plan = plan
    return delta_v, alpha_out


scd_solve.launches = 0
scd_solve.last_plan = None
