"""K2: int8 absmax quantize of the (K, L) update stack as a hand-written
CUDA kernel (``csrc/quant.cu``), one CTA per row.

Replaces the TPU kernel ``repro.kernels.quant.quantize_pack_int8`` (its
``pallas_call`` at ``src/repro/kernels/quant.py:90``, body
``_quant_int8_kernel``), which the reference runs once per worker under
``vmap``; here the K rows go in one launch.

Bound on the H100: bytes, K*(5L + 4) of them; at the main path's
K = 8, L = 16384 that is 0.66 MB, and the launch latency dominates.

The plain version ``quantize_pack_int8_ref`` is the port's copy of
``Int8Codec.encode_ref``, and the kernel is bit-identical to it. It
divides by a tensor, never by a Python number: PyTorch's CUDA division
by a CPU scalar multiplies by the reciprocal instead, which is not the
IEEE quotient the reference takes.

``quantize_pack_int8`` takes the plain version for a CPU tensor and
launches the kernel for a CUDA tensor; ``quantize_pack_int8.launches``
counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.comm.codec import INT8_EPS, INT8_QMAX
from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


def _rows(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dim() not in (1, 2) or x.shape[-1] < 1:
        raise ValueError(f"{what}: expected (L,) or (K, L) with L >= 1, got "
                         f"{tuple(x.shape)}")
    return x if x.dim() == 2 else x[None]


def quantize_pack_int8_ref(x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain int8 encode of each row: ``(q int8, scale f32)`` with
    ``q`` shaped like ``x`` and one scale per row (a 0-dim scale for a
    1-D ``x``)."""
    rows = _rows(x, "quantize_pack_int8_ref").float()
    absmax = torch.amax(torch.abs(rows), dim=1)
    scale = torch.where(absmax > 0,
                        absmax / torch.full_like(absmax, INT8_QMAX)
                        + torch.full_like(absmax, INT8_EPS),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(rows / scale[:, None]), -INT8_QMAX,
                    INT8_QMAX).to(torch.int8)
    return (q, scale) if x.dim() == 2 else (q[0], scale[0])


def quantize_pack_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 encode of a (L,) update or a (K, L) stack of them, through
    K2 on the card (the plain version on the CPU); bit-identical to
    ``Int8Codec.encode_ref``."""
    if x.device.type == "cpu":
        return quantize_pack_int8_ref(x)
    _build.require_cuda(x, "quantize_pack_int8")
    rows = _rows(x, "quantize_pack_int8")
    K, L = rows.shape
    _build.require(rows, "x", dtype=torch.float32, shape=(K, L),
                   device=x.device)
    fn = _build.function("quant_int8_launch", [_P, _P, _P, _I, _I, _P])
    q = torch.empty((K, L), dtype=torch.int8, device=x.device)
    scale = torch.empty((K,), dtype=torch.float32, device=x.device)
    err = fn(rows.data_ptr(), q.data_ptr(), scale.data_ptr(), K, L,
             _build.stream_ptr(x.device))
    _build.check_launch(err, "quant_int8_launch")
    quantize_pack_int8.launches += 1
    return (q, scale) if x.dim() == 2 else (q[0], scale[0])


quantize_pack_int8.launches = 0
