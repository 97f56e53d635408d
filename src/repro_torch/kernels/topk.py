"""K4: top-k by magnitude of the (K, L) update stack for the ``topk``
codec's encode, as a hand-written CUDA kernel (``csrc/topk.cu``), one CTA
per row.

Replaces the TPU kernel ``repro.kernels.topk.topk_select`` (its
``pallas_call`` at ``src/repro/kernels/topk.py:83``, body
``_topk_kernel``), which the reference runs once per worker under
``vmap`` as k argmax+mask sweeps over a row in VMEM. Here the K rows go
in one launch, and each row is a radix select of the k-th largest
magnitude, a stable compaction of the k survivors and a bitonic sort of
them by (magnitude descending, index ascending); ``csrc/topk.cu`` says
how.

Bound on the H100: bytes, K*(4L + 8k + 4) of them; at the main path's
K = 8, L = 16384, k = 2048 that is 655,392 B (0.2 us at 3.35 TB/s), and
the block-wide barriers of the select and the sort dominate.

The plain version ``topk_select_ref`` is a stable descending
``torch.sort`` of ``|x|``: it keeps ``lax.top_k``'s order (ties to the
lowest index), which ``torch.topk`` does not promise. The kernel is
bit-identical to it. ``topk_select`` takes the plain version for a CPU
tensor and launches the kernel for a CUDA tensor; its ``.launches``
counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# dynamic shared memory one block may use on Hopper (227 KB)
SHARED_LIMIT = 232448

_P, _I = ctypes.c_void_p, ctypes.c_int


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


def topk_select(x: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k by magnitude of a (L,) update or a (K, L) stack of them,
    through K4 on the card (the plain version on the CPU); bit-identical
    to ``TopKCodec.encode_ref``."""
    if x.device.type == "cpu":
        return topk_select_ref(x, k)
    _build.require_cuda(x, "topk_select")
    rows = _rows(x, k, "topk_select")
    K, L = rows.shape
    _build.require(rows, "x", dtype=torch.float32, shape=(K, L),
                   device=x.device)
    smem = _build.function("topk_shared_bytes", [_I, _I],
                           ctypes.c_longlong)(L, k)
    if smem > SHARED_LIMIT:
        raise ValueError(
            f"topk_select: a row needs {smem} bytes of shared memory "
            f"(4*L of magnitudes plus 8*pow2(k) of sort keys at L={L}, "
            f"k={k}); one block may use at most {SHARED_LIMIT} (227 KB) — "
            f"a longer row needs the multi-block select")
    fn = _build.function("topk_launch", [_P] * 4 + [_I] * 3 + [_P])
    vals = torch.empty((K, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((K, k), dtype=torch.int32, device=x.device)
    thr = torch.empty((K,), dtype=torch.float32, device=x.device)
    err = fn(rows.data_ptr(), vals.data_ptr(), idx.data_ptr(), thr.data_ptr(),
             K, L, k, _build.stream_ptr(x.device))
    _build.check_launch(err, "topk_launch")
    topk_select.launches += 1
    return _out(x, vals, idx, thr)


topk_select.launches = 0
