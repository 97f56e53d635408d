"""K3: decode + reduce of the gathered (K, wire) payload of the int8,
int4 and int2 codecs, as hand-written CUDA kernels (``csrc/dequant.cu``).

Replaces the TPU kernels of ``repro.kernels.dequant``:

  * ``decode_reduce_int8`` — ``pallas_call`` at
    ``src/repro/kernels/dequant.py:123``, body ``_dec8_kernel``;
  * ``decode_reduce_int4`` — ``pallas_call`` at ``:144``, body
    ``_dec4_kernel``: (K, ceil(L/2)) packed nibbles, code − 8;
  * ``decode_reduce_int2`` — ``pallas_call`` at ``:165``, body
    ``_dec2_kernel``: (K, ceil(L/4)) packed 2-bit codes, code − 2.

Each thread owns 16 outputs on long rows (4 on short ones, so that the
main path's rows spread over the SMs), the consecutive payload bytes of
every row that pack them, loads the K rows' bytes 8 rows at a time, all
in flight before the adds (as one load a row where the row stride
allows), and adds each output over the K workers in order k = 0..K-1
and, for the mean,
multiplies by the f32-rounded 1/K — the reduction-order contract of
``decode_reduce_ref`` (``src/repro/comm/codec.py:247-260``), so each
kernel is bit-identical to it. No (K, L) f32 stack is ever formed.

Bound on the H100: bytes, K*(payload + 4) + 4L of them; at the main
path's K = 8, L = 16384 that is 0.10-0.20 MB, and the launch latency
dominates; at L = 350,000 it is 2.1-4.2 MB (0.63-1.25 us).

The plain versions ``decode_reduce_int{8,4,2}_ref`` replay the same op
sequence in eager PyTorch, one op at a time, so nothing can fuse the
multiply into the add. Each wrapper takes the plain version for CPU
tensors and launches its kernel for CUDA tensors; its ``.launches``
counts the kernel launches. ``decode_mean_int{8,4,2}`` are the
reference's entries for ``decode_reduce_int*(..., mean=True)``
(``src/repro/kernels/dequant.py:181-193``).
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch.comm.codec import unpack_codes
from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_shapes(q: torch.Tensor, scales: torch.Tensor, length: int,
                  per_byte: int, what: str) -> int:
    width = -(-length // per_byte)
    if q.dim() != 2 or q.shape[0] < 1 or q.shape[1] != width or length < 1:
        raise ValueError(f"{what}: payload must be (K, {width}) with K >= 1 "
                         f"for length={length} >= 1, got {tuple(q.shape)}")
    if tuple(scales.shape) != (q.shape[0],):
        raise ValueError(f"{what}: scales must be ({q.shape[0]},), got "
                         f"{tuple(scales.shape)}")
    return q.shape[0]


def _reduce_rows(row: Callable[[int], torch.Tensor], K: int, mean: bool
                 ) -> torch.Tensor:
    """Sum the K decoded rows in worker order; the mean is the sum times
    the f32-rounded 1/K."""
    acc = row(0)
    for k in range(1, K):
        acc = acc + row(k)
    if mean:
        acc = acc * torch.tensor(1.0 / K, dtype=torch.float32,
                                 device=acc.device)
    return acc


def decode_reduce_int8_ref(q: torch.Tensor, scales: torch.Tensor,
                           length: int, *, mean: bool) -> torch.Tensor:
    """Plain decode+reduce: ``(K, L)`` int8 + ``(K,)`` f32 scales ->
    the ``(L,)`` f32 sum (or mean), accumulated row by row in worker
    order."""
    K = _check_shapes(q, scales, length, 1, "decode_reduce_int8_ref")
    return _reduce_rows(lambda k: q[k].to(torch.float32) * scales[k], K, mean)


def decode_reduce_int4_ref(packed: torch.Tensor, scales: torch.Tensor,
                           length: int, *, mean: bool) -> torch.Tensor:
    """Plain decode+reduce: ``(K, ceil(L/2))`` uint8 + ``(K,)`` f32
    scales -> the ``(L,)`` f32 sum (or mean), in worker order."""
    K = _check_shapes(packed, scales, length, 2, "decode_reduce_int4_ref")
    return _reduce_rows(
        lambda k: unpack_codes(packed[k], length, 4) * scales[k], K, mean)


def decode_reduce_int2_ref(packed: torch.Tensor, scales: torch.Tensor,
                           length: int, *, mean: bool) -> torch.Tensor:
    """Plain decode+reduce: ``(K, ceil(L/4))`` uint8 + ``(K,)`` f32
    scales -> the ``(L,)`` f32 sum (or mean), in worker order."""
    K = _check_shapes(packed, scales, length, 4, "decode_reduce_int2_ref")
    return _reduce_rows(
        lambda k: unpack_codes(packed[k], length, 2) * scales[k], K, mean)


def _launch(q: torch.Tensor, scales: torch.Tensor, length: int, mean: bool,
            what: str, launcher: str, dtype: torch.dtype, per_byte: int
            ) -> torch.Tensor:
    """Validate the payload and scales, allocate the ``(L,)`` output,
    launch ``launcher`` on the current stream and raise if it was
    refused."""
    _build.require_cuda(q, what)
    K = _check_shapes(q, scales, length, per_byte, what)
    _build.require(q, "payload", dtype=dtype, shape=tuple(q.shape),
                   device=q.device)
    _build.require(scales, "scales", dtype=torch.float32, shape=(K,),
                   device=q.device)
    fn = _build.function(launcher, [_P, _P, _P, _I, _I, _I, _F, _P])
    out = torch.empty((length,), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), K, length,
             int(mean), 1.0 / K, _build.stream_ptr(q.device))
    _build.check_launch(err, launcher)
    return out


def decode_reduce_int8(q: torch.Tensor, scales: torch.Tensor, length: int,
                       *, mean: bool = True) -> torch.Tensor:
    """Decode+reduce of a gathered int8 payload through K3 on the card
    (the plain version on the CPU); bit-identical to
    ``decode_stacked_ref('int8', ...)``."""
    if q.device.type == "cpu":
        return decode_reduce_int8_ref(q, scales, length, mean=mean)
    out = _launch(q, scales, length, mean, "decode_reduce_int8",
                  "dequant_int8_launch", torch.int8, 1)
    decode_reduce_int8.launches += 1
    return out


def decode_reduce_int4(packed: torch.Tensor, scales: torch.Tensor,
                       length: int, *, mean: bool = True) -> torch.Tensor:
    """Decode+reduce of a gathered packed-int4 payload through K3's int4
    kernel on the card (the plain version on the CPU); bit-identical to
    ``decode_stacked_ref('int4', ...)``."""
    if packed.device.type == "cpu":
        return decode_reduce_int4_ref(packed, scales, length, mean=mean)
    out = _launch(packed, scales, length, mean, "decode_reduce_int4",
                  "dequant_int4_launch", torch.uint8, 2)
    decode_reduce_int4.launches += 1
    return out


def decode_reduce_int2(packed: torch.Tensor, scales: torch.Tensor,
                       length: int, *, mean: bool = True) -> torch.Tensor:
    """Decode+reduce of a gathered packed-int2 payload through K3's int2
    kernel on the card (the plain version on the CPU); bit-identical to
    ``decode_stacked_ref('int2', ...)``."""
    if packed.device.type == "cpu":
        return decode_reduce_int2_ref(packed, scales, length, mean=mean)
    out = _launch(packed, scales, length, mean, "decode_reduce_int2",
                  "dequant_int2_launch", torch.uint8, 4)
    decode_reduce_int2.launches += 1
    return out


decode_reduce_int8.launches = 0
decode_reduce_int4.launches = 0
decode_reduce_int2.launches = 0


def decode_mean_int8(q: torch.Tensor, scales: torch.Tensor, length: int
                     ) -> torch.Tensor:
    """``decode_reduce_int8(..., mean=True)``: the reference's bench-cell
    entry."""
    return decode_reduce_int8(q, scales, length, mean=True)


def decode_mean_int4(packed: torch.Tensor, scales: torch.Tensor,
                     length: int) -> torch.Tensor:
    """``decode_reduce_int4(..., mean=True)``."""
    return decode_reduce_int4(packed, scales, length, mean=True)


def decode_mean_int2(packed: torch.Tensor, scales: torch.Tensor,
                     length: int) -> torch.Tensor:
    """``decode_reduce_int2(..., mean=True)``."""
    return decode_reduce_int2(packed, scales, length, mean=True)
