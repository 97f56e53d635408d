"""K4: top-k by magnitude of the (K, L) update stack for the ``topk``
codec's encode, as hand-written CUDA kernels: a thread-block cluster per
row (``csrc/topk.cu``), or for long rows a grid of CTAs per row
(``csrc/topk_grid.cu``).

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
says how. ``topk_plan`` picks C, the slab and the shared bytes: the
widest C whose K clusters are all resident at once
(``cudaOccupancyMaxActiveClusters``, asked once per process and plan).

Bound on the H100: bytes, K*(4L + 8k + 4) of them; at the main path's
K = 8, L = 16384, k = 2048 that is 655,392 B (0.2 us at 3.35 TB/s); the
four passes' exchanges, the local sort and the searches dominate.

Where a CTA would need more than the 227 KB of shared memory a block may
use (past about 6k survivors, or a slab past about 56k elements), the
plan moves the survivors, their sorted run and their counts to a scratch
block the wrapper allocates (``scratch_words`` 8-byte words a CTA), and
where that is not enough the slab's patterns as well, which are then
read again from ``x`` on each pass; ``csrc/topk.cu`` says how. The
shared form stays where it fits: forced into the device form, the main
path's stack took 24.4 us on an H100 against the shared form's 18.3-18.5
(PERF.md).

A long row takes the **grid form** (``csrc/topk_grid.cu``): every pass
over the row runs on G CTAs a row (about 4,224 in all), the state
across CTAs in device memory: a radix select over the whole 63-bit key
(pattern, then index: the tie rule with no scan) whose first digit's
histogram and filter are the only two reads of x for most rows, the k
survivors sorted by 4096-key tiles and rounds of merge path. It is
several launches on the caller's stream with no host read; the wrapper
gives it one scratch block (``grid_layout``). ``topk_plan`` takes it by
the rule in its docstring.

The plain version ``topk_select_ref`` is a stable descending
``torch.sort`` of ``|x|``: it keeps ``lax.top_k``'s order (ties to the
lowest index), which ``torch.topk`` does not promise. Every form is
bit-identical to it. ``topk_select`` takes the plain version for a CPU
tensor and launches a form for a CUDA tensor; its ``.launches`` counts
one a stack, however many CUDA launches the form makes.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.kernels import _build

# dynamic shared memory one block may use on Hopper (227 KB)
SHARED_LIMIT = 232448
CLUSTERS = (16, 8, 4, 2, 1)      # cluster sizes, largest first
# elements a CTA should own before a wider cluster pays: each radix pass
# pushes a histogram to every peer, and 16 CTAs of 1024 elements ran
# slower than 8 of 2048 on an H100
SLAB_MIN = 2048
# the kernel's shape (csrc/topk.cu): keys gathered at a time, keys of
# the device form's sort tile, histogram bins, scratch words
GATHER = 4096
TILE = 8192
BINS = 256
MISC_WORDS = 128
# the kernel indexes a row with int32, and a CTA sorts at most 2^30 keys
INDEX_MAX = 2**31 - 1
SURVIVORS_MAX = 2**30
# the grid form's rows are its grids' second dimension
GRID_ROWS_MAX = 65535
# the grid form from this row length on, and from the second on when k
# reaches the third (takes_grid)
GRID_MIN_LEN = 2**21
GRID_MIN_LEN_K = 350000
GRID_MIN_K = 43750

# the grid form's shape (csrc/topk_grid.cu): elements of x a pass's CTA
# takes at a time, the CTAs of a pass in all, histogram bins and stages,
# a row's state words, the candidate buffers' cap, keys a sort tile
GRID_TILE = 4096
GRID_CTAS = 4224
GRID_BINS = 2048
GRID_STAGES = 6
GRID_STATE_WORDS = 64
GRID_CAP = 1 << 22
SORT_TILE = 4096

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LAUNCH = [_P] * 4 + [_I] * 5 + [_LL, _P, _I, _P]
_GRID_LAUNCH = [_P] * 4 + [_I] * 4 + [_P, _LL, _P]


@dataclass(frozen=True)
class TopkPlan:
    cluster: int        # C, CTAs per row (0: the grid form)
    slab: int           # elements of the row per CTA (a multiple of 4)
    shared_bytes: int   # dynamic shared memory per CTA
    survivors: str = "shared"   # or "device": in a scratch block
    patterns: str = "shared"    # or "device": read again from x
    scratch_words: int = 0      # 8-byte words of device scratch a CTA
    form: str = "cluster"       # or "grid" (csrc/topk_grid.cu)
    ctas: int = 0               # grid form: a pass's CTAs a row
    cap: int = 0                # grid form: candidates a buffer holds
    merges: int = 0             # grid form: merge rounds of the sort
    scratch_bytes: int = 0      # grid form: its one scratch block

    @property
    def variant(self) -> str:
        if self.form == "grid":
            return f"grid of {self.ctas} CTAs a row"
        return f"survivors in {self.survivors}, patterns in {self.patterns}"


def _up(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


def grid_layout(K: int, L: int, k: int) -> TopkPlan:
    """The grid form's plan for K rows of L keeping k, as
    ``GridLayout`` in ``csrc/topk_grid.cu`` computes it: G, the CTAs of
    a pass a row (the row's 4096-element tiles, at most
    ceil(``GRID_CTAS`` / K)); the cap, min(L, 2^22) candidates a buffer;
    the merge rounds, ceil(log2(ceil(k / 4096))); and the scratch, in
    256-byte-aligned parts: every row's state and six histograms (4 *
    (64 + 6 * 2048) B a row), its k survivor keys (8k B) and its work
    space of max(k, 2 * cap) keys (the two candidate buffers, then the
    sort's second buffer), that is about K * (8k + 8 * max(k, 2 * cap))
    bytes."""
    ctas = min(-(-L // GRID_TILE), -(-GRID_CTAS // K))
    cap = min(L, GRID_CAP)
    merges, w = 0, SORT_TILE
    while w < k:
        merges, w = merges + 1, 2 * w
    meta = 4 * K * (GRID_STATE_WORDS + GRID_STAGES * GRID_BINS)
    total = _up(meta) + _up(8 * K * k) + _up(8 * K * max(k, 2 * cap))
    return TopkPlan(cluster=0, slab=0, shared_bytes=0, survivors="device",
                    patterns="device", form="grid", ctas=ctas, cap=cap,
                    merges=merges, scratch_bytes=total)


def slab_len(L: int, cluster: int) -> int:
    """ceil(L / cluster) rounded up to 4, so that every slab starts on
    16 bytes when L is a multiple of 4."""
    n = -(-L // cluster)
    return -(-n // 4) * 4


def _survivor_slots(slab: int, k: int) -> int:
    """The power of two at or above min(slab, k) (at least 2): a CTA's
    survivor slots, for the sort."""
    return max(2, 1 << (min(slab, k) - 1).bit_length())


def shared_bytes(slab: int, k: int, cluster: int,
                 survivors: str = "shared", patterns: str = "shared"
                 ) -> int:
    """What ``Layout`` in ``csrc/topk.cu`` computes. Shared form: the
    slab's patterns, overlaid later by up to ``GATHER`` gathered keys and
    one count a survivor; the CTA's survivor keys as compacted and as
    sorted (a power of two of them, for the sort); the histograms
    received from the ``cluster`` CTAs, two parities; its own two
    histograms; the scratch. Survivors in device memory: the patterns
    (none when they too are in device memory), overlaid later by a count
    for each of up to ``TILE`` survivors, then a sort tile of up to
    ``TILE`` keys, the histograms and the scratch.
    """
    own = _survivor_slots(slab, k)
    gathered = -(-min(k, GATHER) // 2) * 2
    if survivors == "device":
        tile = min(own, TILE)
        pats = 4 * slab if patterns == "shared" else 0
        first = max(pats, 4 * (-(-tile // 4) * 4)) + 8 * tile
    else:
        first = max(4 * slab, 8 * gathered + 4 * (-(-own // 4) * 4))
        first += 2 * 8 * own
    return (first + 4 * 2 * cluster * BINS + 4 * 2 * BINS
            + 4 * MISC_WORDS)


def _plan_at(L: int, k: int, cluster: int, survivors: str | None
             ) -> TopkPlan:
    """The form and layout of a CTA at ``cluster`` CTAs a row: the first
    form that fits (of those with the survivors where ``survivors`` says,
    if it says)."""
    slab = slab_len(L, cluster)
    if min(slab, k) > SURVIVORS_MAX:
        raise ValueError(f"topk_select: a row of L={L} keeping k={k} at "
                         f"C={cluster} CTAs gives a CTA up to "
                         f"{min(slab, k)} survivors to sort; at most "
                         f"{SURVIVORS_MAX}")
    own = _survivor_slots(slab, k)
    forms = [(s, p) for s, p in (("shared", "shared"), ("device", "shared"),
                                 ("device", "device"))
             if survivors in (None, s)]
    for surv, patterns in forms:
        smem = shared_bytes(slab, k, cluster, surv, patterns)
        if smem <= SHARED_LIMIT:
            break
    else:
        raise ValueError(f"topk_select: a row of L={L} keeping k={k} at "
                         f"C={cluster} CTAs needs {smem} B of shared memory "
                         f"a CTA with its survivors in shared memory; at "
                         f"most {SHARED_LIMIT}")
    return TopkPlan(cluster, slab, smem, surv, patterns,
                    2 * own + own // 2 if surv == "device" else 0)


def takes_grid(K: int, L: int, k: int) -> bool:
    """Whether the plan takes the grid form for K rows of L keeping k:
    from L = ``GRID_MIN_LEN`` (2^21) on, and from L = ``GRID_MIN_LEN_K``
    (webspam's 350,000) on where k >= ``GRID_MIN_K`` (43,750, webspam's
    ``topk(r=0.125)``); elsewhere the cluster forms.

    The rule rests on ``src/repro_torch/bench/codec_grid.py`` (NVIDIA H100
    80GB HBM3, 700.00 W; ms a call by CUDA events, grid / cluster form,
    x ~ N(0, 1) * 1e-3; PR 28), at k = ceil(r L):

    ==========  ====  ==============  ==============  ==============
    L           r     K = 1           K = 4           K = 8
    ==========  ====  ==============  ==============  ==============
    350,000     0.01  0.121 / 0.084   0.094 / 0.084   0.154 / 0.135
    350,000     1/8   0.143 / 0.170   0.159 / 0.168   0.196 / 0.244
    1,000,000   0.01  0.173 / 0.143   0.121 / 0.136   0.174 / 0.201
    1,000,000   1/8   0.157 / 0.387   0.162 / 0.387   0.289 / 0.774
    2,097,152   0.01  0.119 / 0.219   0.168 / 0.275   0.244 / 0.569
    2,097,152   1/8   0.166 / 1.394   0.315 / 1.481   0.527 / 2.846
    4,194,304   0.01  0.188 / 0.420   0.277 / 0.587   0.340 / 1.079
    16,777,216  0.01  0.273 / 2.309   0.494 / 2.360   0.797 / 4.561
    253,755,392 0.01  1.538 / 42.58   5.439 / 48.27   10.60 / 83.19
    ==========  ====  ==============  ==============  ==============

    From 2^21 the grid form won at every K and r measured; at 350,000
    and 10^6 it won wherever k >= 43,750; at k = 3,500 it lost at every
    K and at k = 10,000 at K = 1 (ten launches for little work), winning
    by 11-13% at 10^6 for K = 4 and 8. The main path's (8, 16384, k =
    2048) keeps the cluster form (18.5 us)."""
    return L >= GRID_MIN_LEN or (L >= GRID_MIN_LEN_K and k >= GRID_MIN_K)


def topk_plan(K: int, L: int, k: int, cluster: int | None = None,
              max_active_clusters: Callable[[TopkPlan], int] | None = None,
              survivors: str | None = None, grid: bool | None = None
              ) -> TopkPlan:
    """C, slab, shared bytes and form for K rows of L elements keeping k.

    The grid form (``grid_layout``) where ``grid`` is True, or, with
    ``grid``, ``cluster`` and ``survivors`` all None, where
    ``takes_grid`` says so; ``cluster=`` or ``survivors=`` force the
    cluster forms below, and ``grid=False`` keeps them.

    Without ``cluster``: the largest C of ``CLUSTERS`` whose slab holds
    at least ``SLAB_MIN`` elements (C = 1 for a short row) and whose K
    clusters are all resident at once, as ``max_active_clusters(plan)``
    says (clusters past that wait for a second wave); where no C's are,
    the narrowest. None counts every cluster as resident (the pure plan).
    With ``cluster``: that C. The shared form where its CTA fits the
    227 KB of shared memory a block may use, else the survivors in device
    memory, else the patterns too; ``survivors="device"`` forces the
    device-memory forms (for timing them against the shared form). Raises ``ValueError`` with the numbers
    when L passes int32 or a CTA would sort more than 2^30 survivors.
    """
    if K < 1 or L < 1:
        raise ValueError(f"topk_plan: empty stack K={K}, L={L}")
    if not 1 <= k <= L:
        raise ValueError(f"topk_plan: need 1 <= k <= L, got k={k}, L={L}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"topk_plan: cluster must be one of {CLUSTERS}, "
                         f"got {cluster}")
    if survivors not in (None, "shared", "device"):
        raise ValueError(f"topk_plan: survivors must be 'shared' or "
                         f"'device', got {survivors!r}")
    if L > INDEX_MAX:
        raise ValueError(f"topk_select: a row of L={L} keeping k={k} is "
                         f"past the kernel's int32 indices (at most "
                         f"{INDEX_MAX})")
    if grid and (cluster is not None or survivors is not None):
        raise ValueError(f"topk_plan: grid=True takes no cluster or "
                         f"survivors, got cluster={cluster}, "
                         f"survivors={survivors!r}")
    if grid is None and cluster is None and survivors is None:
        grid = takes_grid(K, L, k)
    if grid:
        if K > GRID_ROWS_MAX:
            raise ValueError(f"topk_plan: the grid form takes at most "
                             f"{GRID_ROWS_MAX} rows, got K={K}")
        return grid_layout(K, L, k)
    if cluster is not None:
        return _plan_at(L, k, cluster, survivors)
    wide = [c for c in CLUSTERS if slab_len(L, c) >= SLAB_MIN] or [1]
    for c in wide:
        plan = _plan_at(L, k, c, survivors)
        if max_active_clusters is None or max_active_clusters(plan) >= K:
            break
    return plan


@functools.cache
def _max_active_clusters(device: int, cluster: int, dev: int,
                         smem: int) -> int:
    fn = _build.function("topk_max_active_clusters", [_I, _I, _LL, _P])
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(cluster, dev, smem, ctypes.byref(out))
    _build.check_launch(err, "topk_max_active_clusters")
    return out.value


def max_active_clusters(device: torch.device, plan: TopkPlan) -> int:
    """``cudaOccupancyMaxActiveClusters`` for ``plan`` on ``device``,
    asked once per process for each plan."""
    return _max_active_clusters(device.index or 0, plan.cluster,
                                int(plan.survivors == "device"),
                                plan.shared_bytes)


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


def topk_select(x: torch.Tensor, k: int, cluster: int | None = None,
                survivors: str | None = None, grid: bool | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k by magnitude of a (L,) update or a (K, L) stack of them,
    through K4 on the card (the plain version on the CPU); bit-identical
    to ``TopKCodec.encode_ref``. ``cluster`` forces the CTAs a row,
    ``survivors`` where the survivors live and ``grid=True`` the grid
    form (for tests and timing); None plans them."""
    if x.device.type == "cpu":
        return topk_select_ref(x, k)
    _build.require_cuda(x, "topk_select")
    rows = _rows(x, k, "topk_select")
    K, L = rows.shape
    _build.require(rows, "x", dtype=torch.float32, shape=(K, L),
                   device=x.device)
    plan = topk_plan(K, L, k, cluster,
                     lambda p: max_active_clusters(x.device, p), survivors,
                     grid)
    vals = torch.empty((K, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((K, k), dtype=torch.int32, device=x.device)
    thr = torch.empty((K,), dtype=torch.float32, device=x.device)
    if plan.form == "grid":
        fn = _build.function("topk_grid_launch", _GRID_LAUNCH)
        scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8,
                              device=x.device)
        err = fn(rows.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                 thr.data_ptr(), K, L, k, plan.ctas, scratch.data_ptr(),
                 plan.scratch_bytes, _build.stream_ptr(x.device))
        _build.check_launch(err, "topk_grid_launch")
    else:
        fn = _build.function("topk_launch", _LAUNCH)
        # survivors, runs and counts in device memory: a block a CTA
        scratch = (torch.empty((K * plan.cluster, plan.scratch_words),
                               dtype=torch.int64, device=x.device)
                   if plan.survivors == "device" else None)
        err = fn(rows.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                 thr.data_ptr(), K, L, k, plan.cluster, plan.slab,
                 plan.shared_bytes,
                 None if scratch is None else scratch.data_ptr(),
                 int(plan.patterns == "device"), _build.stream_ptr(x.device))
        _build.check_launch(err, "topk_launch")
    topk_select.launches += 1
    topk_select.last_plan = plan
    return _out(x, vals, idx, thr)


topk_select.launches = 0
topk_select.last_plan = None
