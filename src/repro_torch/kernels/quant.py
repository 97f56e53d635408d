"""K2: absmax quantize of the (K, L) update stack for the int8, int4 and
int2 codecs, as one hand-written CUDA kernel in three widths
(``csrc/quant.cu``), a thread-block cluster per row.

Replaces the TPU kernels of ``repro.kernels.quant``, which the reference
runs once per worker under ``vmap``; here the K rows go in one launch:

  * ``quantize_pack_int8`` — ``pallas_call`` at
    ``src/repro/kernels/quant.py:90``, body ``_quant_int8_kernel``;
  * ``quantize_pack_int4`` — ``pallas_call`` at ``:110``, body
    ``_quant_int4_kernel``: scale absmax/7.5, codes clip(rint(x/s), ±7)
    + 8, packed ``lo | hi << 4`` under split-half pairing (element ``i``
    with ``i + ceil(L/2)``);
  * ``quantize_pack_int2`` — ``pallas_call`` at ``:130``, body
    ``_quant_int2_kernel``: scale absmax·f32(2/3), codes clip(rint(x/s),
    ±1) + 2, four to a byte under split-quarter pairing (element ``i``
    with ``i + q``, ``i + 2q``, ``i + 3q``, ``q = ceil(L/4)``).

Bound on the H100: bytes, K*(4L + payload + 4) of them; at the main
path's K = 8, L = 16384 that is 0.56-0.66 MB (about 0.2 us), and latency
dominates. Each row is a cluster of C CTAs: CTA rank r packs the output
bytes ``[r*span, (r+1)*span)`` (cut at the row's byte count) from the
elements they pair, read once into registers, and each CTA pushes its
absmax to every peer's shared memory (``st.async``), so the row's absmax
costs one push and one local wait. ``quant_plan`` picks C, and, for a
CTA past 128 elements a thread (a row past 524,288 at C = 16), the
streaming form, which reads the CTA's elements twice: an absmax pass,
then a quantize pass whose reads are mostly L2 hits.

The plain versions ``quantize_pack_int{8,4,2}_ref`` are the port's
copies of ``Int{8,4,2}Codec.encode_ref`` run op by op, and each kernel is
bit-identical to its plain version. They divide by a tensor, never by a
Python number: PyTorch's CUDA division by a CPU scalar multiplies by the
reciprocal instead, which is not the IEEE quotient the reference takes.
(Under ``jax.jit`` the reference itself rewrites ``absmax / 7.5`` as such
a multiply, so its jitted int4 scale can sit one ulp from the eager one;
the port holds the eager reference.)

Each wrapper takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; its ``.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.comm.codec import (INT2_QMAX, INT2_SCALE_MUL, INT4_QMAX,
                                    INT4_SCALE_DIV, INT8_EPS, INT8_QMAX)
from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH = [_P, _P, _P] + [_I] * 6 + [_P]

CLUSTERS = (16, 8, 4, 2, 1)      # cluster sizes, largest first
THREADS = 256                    # a CTA (csrc/quant.cu kThreads)
# elements a CTA holds in registers at most (128 a thread); past it the
# CTA streams its elements twice
SLAB_MAX = 128 * THREADS
# the kernel indexes a row with int32
INDEX_MAX = 2**31 - 1
# elements a CTA should read before a wider cluster pays: the row's
# absmax costs a push to every peer, and 16 CTAs of 1024 elements ran
# slower than 8 of 2048 on an H100
SLAB_MIN = 2048


@dataclass(frozen=True)
class QuantPlan:
    cluster: int        # C, CTAs per row
    span: int           # output bytes per CTA, a multiple of 4
    slab: int           # elements a CTA reads: span * (8 // bits)
    variant: str = "registers"   # or "stream": past SLAB_MAX, read twice


def byte_span(n_bytes: int, cluster: int) -> int:
    """ceil(n_bytes / cluster) rounded up to 4, so that every CTA but the
    last stores whole 4-byte words."""
    span = -(-n_bytes // cluster)
    return -(-span // 4) * 4


def quant_plan(K: int, L: int, bits: int, cluster: int | None = None
               ) -> QuantPlan:
    """C, the bytes and elements of one CTA and its variant for K rows of
    L elements at ``bits`` bits a code.

    Without ``cluster``: the largest C of ``CLUSTERS`` whose CTAs each
    read at least ``SLAB_MIN`` elements (C = 1 for a short row). With
    ``cluster``: that C. A CTA of at most ``SLAB_MAX`` elements holds
    them in registers; a larger one streams them twice. Raises
    ``ValueError`` with the numbers when L passes int32.
    """
    if K < 1 or L < 1:
        raise ValueError(f"quant_plan: empty stack K={K}, L={L}")
    if bits not in (8, 4, 2):
        raise ValueError(f"quant_plan: bits must be 8, 4 or 2, got {bits}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"quant_plan: cluster must be one of {CLUSTERS}, "
                         f"got {cluster}")
    if L > INDEX_MAX:
        raise ValueError(f"quantize_pack_int{bits}: a row of L={L} is past "
                         f"the kernel's int32 indices (at most {INDEX_MAX})")
    per = 8 // bits
    W = -(-L // per)
    if cluster is None:
        cluster = next((c for c in CLUSTERS
                        if byte_span(W, c) * per >= SLAB_MIN), 1)
    span = byte_span(W, cluster)
    slab = span * per
    return QuantPlan(cluster, span, slab,
                     "registers" if slab <= SLAB_MAX else "stream")


def _rows(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dim() not in (1, 2) or x.shape[-1] < 1:
        raise ValueError(f"{what}: expected (L,) or (K, L) with L >= 1, got "
                         f"{tuple(x.shape)}")
    return x if x.dim() == 2 else x[None]


def _absmax(rows: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(rows), dim=1)


def _codes(rows: torch.Tensor, scale: torch.Tensor, qmax: float
           ) -> torch.Tensor:
    """clip(round(x / scale), -qmax, qmax) of each row, as int32."""
    return torch.clamp(torch.round(rows / scale[:, None]), -qmax,
                       qmax).to(torch.int32)


def _pad(rows: torch.Tensor, parts: int) -> torch.Tensor:
    """The rows zero-padded to a multiple of ``parts``; reshaped to
    ``(K, parts, W)``, element ``i`` of a row pairs with ``i + W``,
    ``i + 2W``, ... (split-half for 2 parts, split-quarter for 4)."""
    return torch.nn.functional.pad(rows, (0, -rows.shape[1] % parts))


def _out(x: torch.Tensor, payload: torch.Tensor, scale: torch.Tensor):
    return (payload, scale) if x.dim() == 2 else (payload[0], scale[0])


def quantize_pack_int8_ref(x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain int8 encode of each row: ``(q int8, scale f32)`` with
    ``q`` shaped like ``x`` and one scale per row (a 0-dim scale for a
    1-D ``x``)."""
    rows = _rows(x, "quantize_pack_int8_ref").float()
    absmax = _absmax(rows)
    scale = torch.where(absmax > 0,
                        absmax / torch.full_like(absmax, INT8_QMAX)
                        + torch.full_like(absmax, INT8_EPS),
                        torch.ones_like(absmax))
    return _out(x, _codes(rows, scale, INT8_QMAX).to(torch.int8), scale)


def quantize_pack_int4_ref(x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain int4 encode of each row: ``(packed uint8 (..., ceil(L/2)),
    scale f32)``, the zero pad of an odd L packed as the biased zero
    nibble 8."""
    rows = _rows(x, "quantize_pack_int4_ref").float()
    absmax = _absmax(rows)
    scale = torch.where(absmax > 0,
                        absmax / torch.full_like(absmax, INT4_SCALE_DIV),
                        torch.ones_like(absmax))
    q = (_codes(_pad(rows, 2), scale, INT4_QMAX) + 8).reshape(
        rows.shape[0], 2, -1)
    return _out(x, (q[:, 0] | (q[:, 1] << 4)).to(torch.uint8), scale)


def quantize_pack_int2_ref(x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain int2 encode of each row: ``(packed uint8 (..., ceil(L/4)),
    scale f32)``, the zero pad packed as the biased zero code 2."""
    rows = _rows(x, "quantize_pack_int2_ref").float()
    absmax = _absmax(rows)
    scale = torch.where(absmax > 0,
                        absmax * torch.full_like(absmax, INT2_SCALE_MUL),
                        torch.ones_like(absmax))
    q = (_codes(_pad(rows, 4), scale, INT2_QMAX) + 2).reshape(
        rows.shape[0], 4, -1)
    packed = q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
    return _out(x, packed.to(torch.uint8), scale)


def _launch(x: torch.Tensor, what: str, bits: int, dtype: torch.dtype,
            cluster: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Validate ``x``, plan, allocate the payload and scales, launch the
    kernel on the current stream and raise if it was refused."""
    _build.require_cuda(x, what)
    rows = _rows(x, what)
    K, L = rows.shape
    _build.require(rows, "x", dtype=torch.float32, shape=(K, L),
                   device=x.device)
    plan = quant_plan(K, L, bits, cluster)
    fn = _build.function("quant_launch", _LAUNCH)
    payload = torch.empty((K, -(-L // (8 // bits))), dtype=dtype,
                          device=x.device)
    scale = torch.empty((K,), dtype=torch.float32, device=x.device)
    err = fn(rows.data_ptr(), payload.data_ptr(), scale.data_ptr(), K, L,
             bits, plan.cluster, plan.span, int(plan.variant == "stream"),
             _build.stream_ptr(x.device))
    _build.check_launch(err, "quant_launch")
    return _out(x, payload, scale)


def quantize_pack_int8(x: torch.Tensor, cluster: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 encode of a (L,) update or a (K, L) stack of them, through
    K2 on the card (the plain version on the CPU); bit-identical to
    ``Int8Codec.encode_ref``."""
    if x.device.type == "cpu":
        return quantize_pack_int8_ref(x)
    out = _launch(x, "quantize_pack_int8", 8, torch.int8, cluster)
    quantize_pack_int8.launches += 1
    return out


def quantize_pack_int4(x: torch.Tensor, cluster: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """int4 encode of a (L,) update or a (K, L) stack of them, through
    K2's int4 kernel on the card (the plain version on the CPU);
    bit-identical to the eager ``Int4Codec.encode_ref``."""
    if x.device.type == "cpu":
        return quantize_pack_int4_ref(x)
    out = _launch(x, "quantize_pack_int4", 4, torch.uint8, cluster)
    quantize_pack_int4.launches += 1
    return out


def quantize_pack_int2(x: torch.Tensor, cluster: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """int2 encode of a (L,) update or a (K, L) stack of them, through
    K2's int2 kernel on the card (the plain version on the CPU);
    bit-identical to ``Int2Codec.encode_ref``."""
    if x.device.type == "cpu":
        return quantize_pack_int2_ref(x)
    out = _launch(x, "quantize_pack_int2", 2, torch.uint8, cluster)
    quantize_pack_int2.launches += 1
    return out


quantize_pack_int8.launches = 0
quantize_pack_int4.launches = 0
quantize_pack_int2.launches = 0
