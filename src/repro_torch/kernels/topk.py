"""K4: top-k by magnitude of the (K, L) update stack for the ``topk``
codec's encode, as a hand-written CUDA kernel (``csrc/topk.cu``), a
thread-block cluster per row.

Replaces the TPU kernel ``repro.kernels.topk.topk_select`` (its
``pallas_call`` at ``src/repro/kernels/topk.py:83``, body
``_topk_kernel``), which the reference runs once per worker under
``vmap`` as k argmax+mask sweeps over a row in VMEM. Here the K rows go
in one launch, and each row is a cluster of C CTAs, each CTA a slab of
the row: a radix select of the k-th largest magnitude whose histograms
the CTAs push into each other's shared memory, a stable choice of the
ties across the slabs, and the order from each CTA's sorted survivors
ranked against its peers' by binary search (a survivor's position is
the number of the row's survivors ranked above it); ``csrc/topk.cu``
says how. ``topk_plan`` picks C, the slab and the shared bytes.

Bound on the H100: bytes, K*(4L + 8k + 4) of them; at the main path's
K = 8, L = 16384, k = 2048 that is 655,392 B (0.2 us at 3.35 TB/s); the
four passes' exchanges, the local sort and the searches dominate.

The plain version ``topk_select_ref`` is a stable descending
``torch.sort`` of ``|x|``: it keeps ``lax.top_k``'s order (ties to the
lowest index), which ``torch.topk`` does not promise. The kernel is
bit-identical to it. ``topk_select`` takes the plain version for a CPU
tensor and launches the kernel for a CUDA tensor; its ``.launches``
counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

# dynamic shared memory one block may use on Hopper (227 KB)
SHARED_LIMIT = 232448
CLUSTERS = (16, 8, 4, 2, 1)      # cluster sizes, largest first
# elements a CTA should own before a wider cluster pays: each radix pass
# pushes a histogram to every peer, and 16 CTAs of 1024 elements ran
# slower than 8 of 2048 on an H100
SLAB_MIN = 2048
# the kernel's shape (csrc/topk.cu): keys gathered at a time, histogram
# bins, scratch words
GATHER = 4096
BINS = 256
MISC_WORDS = 128

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LAUNCH = [_P] * 4 + [_I] * 5 + [_LL, _P]


@dataclass(frozen=True)
class TopkPlan:
    cluster: int        # C, CTAs per row
    slab: int           # elements of the row per CTA (a multiple of 4)
    shared_bytes: int   # dynamic shared memory per CTA


def slab_len(L: int, cluster: int) -> int:
    """ceil(L / cluster) rounded up to 4, so that every slab starts on
    16 bytes when L is a multiple of 4."""
    n = -(-L // cluster)
    return -(-n // 4) * 4


def shared_bytes(slab: int, k: int, cluster: int) -> int:
    """What ``Layout`` in ``csrc/topk.cu`` computes: the slab's patterns,
    overlaid later by up to ``GATHER`` gathered keys and one count a
    survivor; the CTA's survivor keys as compacted and as sorted (a power
    of two of them, for the sort); the histograms received from the
    ``cluster`` CTAs, two parities; its own two histograms; the
    scratch."""
    own = max(2, 1 << (min(slab, k) - 1).bit_length())   # a power of two
    gathered = -(-min(k, GATHER) // 2) * 2
    first = max(4 * slab, 8 * gathered + 4 * (-(-own // 4) * 4))
    return (first + 2 * 8 * own + 4 * 2 * cluster * BINS + 4 * 2 * BINS
            + 4 * MISC_WORDS)


def topk_plan(K: int, L: int, k: int, cluster: int | None = None
              ) -> TopkPlan:
    """C, slab and shared bytes for K rows of L elements keeping k.

    Without ``cluster``: the largest C of ``CLUSTERS`` whose slab holds
    at least ``SLAB_MIN`` elements (C = 1 for a short row). With
    ``cluster``: that C. Raises ``ValueError`` with the numbers when a
    CTA would need more than the 227 KB of shared memory a block may use.
    """
    if K < 1 or L < 1:
        raise ValueError(f"topk_plan: empty stack K={K}, L={L}")
    if not 1 <= k <= L:
        raise ValueError(f"topk_plan: need 1 <= k <= L, got k={k}, L={L}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"topk_plan: cluster must be one of {CLUSTERS}, "
                         f"got {cluster}")
    if cluster is None:
        cluster = next((c for c in CLUSTERS
                        if slab_len(L, c) >= SLAB_MIN), 1)
    slab = slab_len(L, cluster)
    plan = TopkPlan(cluster, slab, shared_bytes(slab, k, cluster))
    if plan.shared_bytes > SHARED_LIMIT:
        raise ValueError(
            f"topk_select: a row of L={L} keeping k={k} at C={cluster} "
            f"CTAs needs {plan.shared_bytes} bytes of shared memory a CTA "
            f"(a slab of {slab}: 4 B a pattern, 8 B a survivor key, up "
            f"to {GATHER} gathered keys); one block may use at most "
            f"{SHARED_LIMIT} (227 KB)")
    return plan


def _rows(x: torch.Tensor, k: int, what: str) -> torch.Tensor:
    if x.dim() not in (1, 2) or x.shape[-1] < 1:
        raise ValueError(f"{what}: expected (L,) or (K, L) with L >= 1, got "
                         f"{tuple(x.shape)}")
    if not 1 <= k <= x.shape[-1]:
        raise ValueError(f"{what}: need 1 <= k <= L, got k={k}, "
                         f"L={x.shape[-1]}")
    return x if x.dim() == 2 else x[None]


def _out(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
         thr: torch.Tensor):
    return (vals, idx, thr) if x.dim() == 2 else (vals[0], idx[0], thr[0])


def topk_select_ref(x: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain top-k of each row by magnitude: ``(values f32 (..., k),
    indices int32 (..., k), threshold f32 (...))``, the values read out
    exactly in descending-|x| order with ties to the lowest index, the
    threshold the k-th magnitude."""
    rows = _rows(x, k, "topk_select_ref").float()
    mags, order = torch.sort(torch.abs(rows), dim=1, descending=True,
                             stable=True)
    idx = order[:, :k]
    return _out(x, torch.gather(rows, 1, idx), idx.to(torch.int32),
                mags[:, k - 1])


def topk_select(x: torch.Tensor, k: int, cluster: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k by magnitude of a (L,) update or a (K, L) stack of them,
    through K4 on the card (the plain version on the CPU); bit-identical
    to ``TopKCodec.encode_ref``. ``cluster`` forces the CTAs a row (for
    tests and timing); None plans it."""
    if x.device.type == "cpu":
        return topk_select_ref(x, k)
    _build.require_cuda(x, "topk_select")
    rows = _rows(x, k, "topk_select")
    K, L = rows.shape
    _build.require(rows, "x", dtype=torch.float32, shape=(K, L),
                   device=x.device)
    plan = topk_plan(K, L, k, cluster)
    fn = _build.function("topk_launch", _LAUNCH)
    vals = torch.empty((K, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((K, k), dtype=torch.int32, device=x.device)
    thr = torch.empty((K,), dtype=torch.float32, device=x.device)
    err = fn(rows.data_ptr(), vals.data_ptr(), idx.data_ptr(), thr.data_ptr(),
             K, L, k, plan.cluster, plan.slab, plan.shared_bytes,
             _build.stream_ptr(x.device))
    _build.check_launch(err, "topk_launch")
    topk_select.launches += 1
    return _out(x, vals, idx, thr)


topk_select.launches = 0
