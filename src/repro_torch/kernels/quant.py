"""K2: absmax quantize of the (K, L) update stack for the int8, int4 and
int2 codecs, as hand-written CUDA kernels in three widths
(``csrc/quant.cu``): a thread-block cluster per row, or for long rows
two grids of CTAs per row.

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

A long row takes the **grid form** (also ``csrc/quant.cu``): an absmax
kernel over a grid of G CTAs a row, whose CTAs combine their maxima of
the |x| bit patterns per row with an integer ``atomicMax`` (exact in any
order), then a quantize-and-pack kernel over its own grid, each CTA
tiles of 4096 output bytes with the same pairing, scale rules and IEEE
quotient as the cluster form; three launches (a zeroing one first) on
the caller's stream, a K-word scratch from the wrapper. ``quant_plan``
takes it by the rule in its docstring.

The plain versions ``quantize_pack_int{8,4,2}_ref`` are the port's
copies of ``Int{8,4,2}Codec.encode_ref`` run op by op, and each kernel is
bit-identical to its plain version. They divide by a tensor, never by a
Python number: PyTorch's CUDA division by a CPU scalar multiplies by the
reciprocal instead, which is not the IEEE quotient the reference takes.
(Under ``jax.jit`` the reference itself rewrites ``absmax / 7.5`` as such
a multiply, so its jitted int4 scale can sit one ulp from the eager one;
the port holds the eager reference.)

Each wrapper takes the plain version for a CPU tensor and launches a
form for a CUDA tensor; its ``.launches`` counts one a stack, however
many CUDA launches the form makes.
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
_GRID_LAUNCH = [_P] * 4 + [_I] * 5 + [_P]

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
# the grid form (csrc/quant.cu): elements (absmax) or output bytes (pack)
# a CTA takes at a time, and a grid's CTAs in all (4 waves of 8 a SM)
GRID_TILE = 4096
GRID_CTAS = 4224
# the grid form's rows are its grids' second dimension
GRID_ROWS_MAX = 65535
# the grid form from this row length on (takes_grid)
GRID_MIN_LEN = 2**22


@dataclass(frozen=True)
class QuantPlan:
    cluster: int        # C, CTAs per row (0: the grid form)
    span: int           # output bytes a CTA (grid: a tile), a multiple of 4
    slab: int           # elements a CTA (a tile) reads: span * (8 // bits)
    variant: str = "registers"   # or "stream": past SLAB_MAX, read twice;
                                 # or "grid"
    ctas_absmax: int = 0         # grid form: the absmax kernel's CTAs a row
    ctas_pack: int = 0           # grid form: the pack kernel's CTAs a row


def grid_ctas(K: int, n: int) -> int:
    """G of a grid-form kernel over n elements or bytes a row: its
    4096-wide tiles, at most ceil(``GRID_CTAS`` / K) (``grid_ctas`` in
    ``csrc/quant.cu``)."""
    return min(-(-n // GRID_TILE), -(-GRID_CTAS // K))


def takes_grid(K: int, L: int) -> bool:
    """Whether the plan takes the grid form for K rows of L elements:
    from L = ``GRID_MIN_LEN`` (2^22) on, in every width.

    The rule rests on ``src/repro_torch/bench/codec_grid.py`` (NVIDIA H100
    80GB HBM3, 700.00 W; ms a call by CUDA events, grid / cluster form,
    int8, x ~ N(0, 1) * 1e-3; PR 28):

    ===========  ==============  ==============  ==============
    L            K = 1           K = 4           K = 8
    ===========  ==============  ==============  ==============
    350,000      0.097 / 0.102   0.073 / 0.091   0.090 / 0.073
    1,000,000    0.082 / 0.052   0.091 / 0.051   0.100 / 0.081
    2,097,152    0.060 / 0.070   0.061 / 0.111   0.096 / 0.148
    4,194,304    0.097 / 0.127   0.086 / 0.213   0.139 / 0.250
    16,777,216   0.088 / 0.723   0.232 / 0.784   0.434 / 0.903
    253,755,392  0.784 / 10.49   3.155 / 11.30   6.221 / 13.10
    ===========  ==============  ==============  ==============

    From 2^22 the grid form won at every K in every width (int4 and int2
    there: 0.077-0.126 / 0.095-0.212 ms); below it the host's two extra
    launches (~20-40 us) lose or tie against one, although the grid
    form's device time is mostly the lower from 350,000 on."""
    return L >= GRID_MIN_LEN


def byte_span(n_bytes: int, cluster: int) -> int:
    """ceil(n_bytes / cluster) rounded up to 4, so that every CTA but the
    last stores whole 4-byte words."""
    span = -(-n_bytes // cluster)
    return -(-span // 4) * 4


def quant_plan(K: int, L: int, bits: int, cluster: int | None = None,
               grid: bool | None = None) -> QuantPlan:
    """C, the bytes and elements of one CTA and its variant for K rows of
    L elements at ``bits`` bits a code.

    The grid form where ``grid`` is True, or, with ``grid`` and
    ``cluster`` None, where ``takes_grid`` says so: the absmax kernel's
    and the pack kernel's CTAs a row (``grid_ctas`` of L elements and of
    the row's ceil(L / (8 // bits)) bytes), each CTA taking the
    4096-element or 4096-byte tiles g, g + G, ... of its row (``span``
    and ``slab`` are a pack tile's bytes and elements). ``cluster``
    forces the cluster form, and ``grid=False`` keeps it.

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
    if grid and cluster is not None:
        raise ValueError(f"quant_plan: grid=True takes no cluster, got "
                         f"cluster={cluster}")
    if grid is None and cluster is None:
        grid = takes_grid(K, L)
    if grid:
        if K > GRID_ROWS_MAX:
            raise ValueError(f"quant_plan: the grid form takes at most "
                             f"{GRID_ROWS_MAX} rows, got K={K}")
        return QuantPlan(0, GRID_TILE, GRID_TILE * per, "grid",
                         grid_ctas(K, L), grid_ctas(K, W))
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
            cluster: int | None, grid: bool | None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Validate ``x``, plan, allocate the payload and scales, launch the
    planned form on the current stream and raise if it was refused."""
    _build.require_cuda(x, what)
    rows = _rows(x, what)
    K, L = rows.shape
    _build.require(rows, "x", dtype=torch.float32, shape=(K, L),
                   device=x.device)
    plan = quant_plan(K, L, bits, cluster, grid)
    payload = torch.empty((K, -(-L // (8 // bits))), dtype=dtype,
                          device=x.device)
    scale = torch.empty((K,), dtype=torch.float32, device=x.device)
    if plan.variant == "grid":
        fn = _build.function("quant_grid_launch", _GRID_LAUNCH)
        amax = torch.empty((K,), dtype=torch.int32, device=x.device)
        err = fn(rows.data_ptr(), payload.data_ptr(), scale.data_ptr(),
                 amax.data_ptr(), K, L, bits, plan.ctas_absmax,
                 plan.ctas_pack, _build.stream_ptr(x.device))
        _build.check_launch(err, "quant_grid_launch")
    else:
        fn = _build.function("quant_launch", _LAUNCH)
        err = fn(rows.data_ptr(), payload.data_ptr(), scale.data_ptr(), K,
                 L, bits, plan.cluster, plan.span,
                 int(plan.variant == "stream"), _build.stream_ptr(x.device))
        _build.check_launch(err, "quant_launch")
    return _out(x, payload, scale)


def quantize_pack_int8(x: torch.Tensor, cluster: int | None = None,
                       grid: bool | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 encode of a (L,) update or a (K, L) stack of them, through
    K2 on the card (the plain version on the CPU); bit-identical to
    ``Int8Codec.encode_ref``. ``cluster`` or ``grid=True`` force a form
    (for tests and timing); None plans it."""
    if x.device.type == "cpu":
        return quantize_pack_int8_ref(x)
    out = _launch(x, "quantize_pack_int8", 8, torch.int8, cluster, grid)
    quantize_pack_int8.launches += 1
    return out


def quantize_pack_int4(x: torch.Tensor, cluster: int | None = None,
                       grid: bool | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """int4 encode of a (L,) update or a (K, L) stack of them, through
    K2's int4 kernel on the card (the plain version on the CPU);
    bit-identical to the eager ``Int4Codec.encode_ref``."""
    if x.device.type == "cpu":
        return quantize_pack_int4_ref(x)
    out = _launch(x, "quantize_pack_int4", 4, torch.uint8, cluster, grid)
    quantize_pack_int4.launches += 1
    return out


def quantize_pack_int2(x: torch.Tensor, cluster: int | None = None,
                       grid: bool | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """int2 encode of a (L,) update or a (K, L) stack of them, through
    K2's int2 kernel on the card (the plain version on the CPU);
    bit-identical to ``Int2Codec.encode_ref``."""
    if x.device.type == "cpu":
        return quantize_pack_int2_ref(x)
    out = _launch(x, "quantize_pack_int2", 2, torch.uint8, cluster, grid)
    quantize_pack_int2.launches += 1
    return out


quantize_pack_int8.launches = 0
quantize_pack_int4.launches = 0
quantize_pack_int2.launches = 0
