"""K3: int8 decode + reduce of the gathered (K, L) payload as a
hand-written CUDA kernel (``csrc/dequant.cu``).

Replaces the TPU kernel ``repro.kernels.dequant.decode_reduce_int8``
(its ``pallas_call`` at ``src/repro/kernels/dequant.py:123``, body
``_dec8_kernel``). A 1-D grid over L; each thread adds its element's K
decoded codes in worker order k = 0..K-1 and, for the mean, multiplies
by the f32-rounded 1/K — the reduction-order contract of
``decode_reduce_ref`` (``src/repro/comm/codec.py:247-260``), so the
kernel is bit-identical to it. No (K, L) f32 stack is ever formed.

Bound on the H100: bytes, K*(L + 4) + 4L of them; at the main path's
K = 8, L = 16384 that is 0.2 MB, and the launch latency dominates.

The plain version ``decode_reduce_int8_ref`` replays the same op
sequence in eager PyTorch, one op at a time, so nothing can fuse the
multiply into the add. ``decode_reduce_int8`` takes the plain version
for CPU tensors and launches the kernel for CUDA tensors;
``decode_reduce_int8.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_shapes(q: torch.Tensor, scales: torch.Tensor, length: int,
                  what: str) -> tuple[int, int]:
    if q.dim() != 2 or q.shape[0] < 1 or q.shape[1] != length or length < 1:
        raise ValueError(f"{what}: payload must be (K, length) with K >= 1 "
                         f"and length={length} >= 1, got {tuple(q.shape)}")
    if tuple(scales.shape) != (q.shape[0],):
        raise ValueError(f"{what}: scales must be ({q.shape[0]},), got "
                         f"{tuple(scales.shape)}")
    return q.shape[0], length


def decode_reduce_int8_ref(q: torch.Tensor, scales: torch.Tensor,
                           length: int, *, mean: bool) -> torch.Tensor:
    """Plain decode+reduce: ``(K, L)`` int8 + ``(K,)`` f32 scales ->
    the ``(L,)`` f32 sum (or mean), accumulated row by row in worker
    order."""
    K, _ = _check_shapes(q, scales, length, "decode_reduce_int8_ref")
    acc = q[0].to(torch.float32) * scales[0]
    for k in range(1, K):
        acc = acc + q[k].to(torch.float32) * scales[k]
    if mean:
        acc = acc * torch.tensor(1.0 / K, dtype=torch.float32,
                                 device=acc.device)
    return acc


def decode_reduce_int8(q: torch.Tensor, scales: torch.Tensor, length: int,
                       *, mean: bool = True) -> torch.Tensor:
    """Decode+reduce of a gathered int8 payload through K3 on the card
    (the plain version on the CPU); bit-identical to
    ``decode_stacked_ref('int8', ...)``."""
    if q.device.type == "cpu":
        return decode_reduce_int8_ref(q, scales, length, mean=mean)
    _build.require_cuda(q, "decode_reduce_int8")
    K, L = _check_shapes(q, scales, length, "decode_reduce_int8")
    _build.require(q, "q", dtype=torch.int8, shape=(K, L), device=q.device)
    _build.require(scales, "scales", dtype=torch.float32, shape=(K,),
                   device=q.device)
    fn = _build.function("dequant_int8_launch",
                         [_P, _P, _P, _I, _I, _I, _F, _P])
    out = torch.empty((L,), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), K, L,
             int(mean), 1.0 / K, _build.stream_ptr(q.device))
    _build.check_launch(err, "dequant_int8_launch")
    decode_reduce_int8.launches += 1
    return out


decode_reduce_int8.launches = 0
