"""Update codecs: what one worker's update vector looks like on the wire
(the port of ``repro.comm.codec``: the ``f32``, ``int8``, ``int4``,
``int2`` and ``topk(r=..)`` codecs and the ``ef:`` error-feedback
wrapper).

An :class:`UpdateCodec` turns f32 updates into a tuple of *wire
tensors* (``encode``), reconstructs f32 from a stacked ``(K, ...)``
gather of those tensors (``decode_stacked``) or reduces the gather
straight to the ``(L,)`` aggregate (``decode_stacked_sum`` /
``decode_stacked_mean``), and prices the per-worker payload
(``wire_bytes``).

The port's ``encode`` takes one update ``(L,)`` or the whole ``(K, L)``
stack of them — the reference's ``vmap`` over workers written out as a
leading axis — and returns one scale per row.

  * ``f32``  — identity: the update travels as-is (4 bytes/element).
  * ``int8`` — absmax quantization to [-127, 127] with one f32 scale per
    worker (1 byte/element + 4).
  * ``int4`` — absmax quantization to [-7, 7] (``scale = absmax/7.5``),
    biased nibbles packed two to a byte under split-half pairing:
    element ``i`` with ``i + ceil(L/2)`` (``ceil(L/2)`` bytes + 4).
  * ``int2`` — absmax ternary quantization to {-1, 0, 1} (``scale =
    absmax * f32(2/3)``), biased 2-bit codes packed four to a byte under
    split-quarter pairing: element ``i`` with ``i + q``, ``i + 2q``,
    ``i + 3q``, ``q = ceil(L/4)`` (``ceil(L/4)`` bytes + 4).
  * ``topk(r=..)`` — magnitude sparsification: the ``k = min(L, max(1,
    ceil(r*L)))`` largest-|.| entries as f32 values and int32 indices,
    plus the k-th magnitude as a threshold (``8k + 4`` bytes).

On the card the quantized codecs' ``encode`` launches kernel K2
(``repro_torch.kernels.quant``) and their stacked reductions launch
kernel K3 (``repro_torch.kernels.dequant``); on the CPU both run their
plain versions. Both are bit-identical to the reference's eager
``encode_ref`` and ``decode_reduce_ref``: the reduction adds the K
decoded rows in worker order and the mean is the sum times the
f32-rounded 1/K. The topk encode launches kernel K4
(``repro_torch.kernels.topk``) on the card and is bit-identical to the
reference's ``lax.top_k``; its decode is plain PyTorch (a scatter per
row, the rows added in worker order), as it is jnp outside any kernel
in the reference.

The ``ef:<base>`` wrapper adds *error feedback*: it encodes ``dv +
residual`` with the lossy base codec and keeps ``(dv + residual) -
decode(encode(dv + residual))`` as per-worker codec *state*, so what the
grid rounds away this round re-enters the sum next round. It is
``stateful``: ``init_state(L)`` is the round-0 residual and
``encode_with_state`` returns ``(wire parts, new state)``. Stateless
codecs expose the same surface with a zero-length placeholder. The
residual is plain PyTorch, as it is jnp in the reference.

Zero is a fixed point of every codec: an all-zero update gets scale 1
(top-k: threshold 0) and decodes to exact zeros.
"""
from __future__ import annotations

import functools
import math
import re
from typing import Protocol, runtime_checkable

import torch

FP_ITEMSIZE = 4        # every dense array in the system is float32
SCALE_BYTES = 4        # one f32 absmax scale per worker per round

INT8_QMAX = 127.0      # int8 grid: 255 levels across [-absmax, absmax]
INT8_EPS = 1e-30       # added to absmax/127, as the reference has always done
INT4_QMAX = 7.0        # int4 grid: 15 levels, q in [-7, 7]
INT4_SCALE_DIV = 7.5   # scale = absmax/7.5: steps of 2*absmax/15
INT2_QMAX = 1.0        # int2 grid: 3 levels {-1, 0, 1}
INT2_SCALE_MUL = 2.0 / 3.0  # scale = absmax * f32(2/3), a multiply as in
#                             the reference (its division by 1.5 was one
#                             ulp apart between its two paths)

TOPK_DEFAULT_R = 0.01  # bare "topk" keeps 1% of the entries

_TOPK_RE = re.compile(r"topk(?:\((?P<arg>[^)]*)\))?")


@runtime_checkable
class UpdateCodec(Protocol):
    """What a codec plugs into the comm schemes and the byte model.

    ``encode``         a (L,) update or a (K, L) stack -> tuple of wire
                       tensors (payload first; a per-worker f32 scale
                       follows when the codec has one — by convention
                       the scale is always the LAST wire part).
    ``decode``         the wire tuple of ONE worker -> the f32 vector.
    ``decode_stacked`` the gathered ``(K, ...)`` wire tuple -> the
                       ``(K, L)`` f32 stack.
    ``decode_stacked_sum`` / ``decode_stacked_mean``
                       the gathered wire tuple -> the ``(L,)`` reduced
                       aggregate directly — the call the exchanges make.
    ``wire_bytes``     per-worker payload bytes for a length-L update.

    Stateful codecs (``stateful = True``, the ``ef:`` wrapper) carry a
    per-worker state vector between rounds: ``init_state(L)`` is one
    worker's round-0 state and ``encode_with_state(dv, state)`` returns
    ``(wire parts, new state)`` for a (L,) update or a (K, L) stack.
    Stateless codecs expose the same surface with a zero-length
    placeholder. ``lossless`` marks a codec whose round trip is exact
    (only ``f32``), which has no error to feed back.
    """
    name: str
    stateful: bool
    lossless: bool

    def encode(self, dv: torch.Tensor) -> tuple[torch.Tensor, ...]: ...

    def decode(self, parts, length: int) -> torch.Tensor: ...

    def decode_stacked(self, parts, length: int) -> torch.Tensor: ...

    def decode_stacked_sum(self, parts, length: int) -> torch.Tensor: ...

    def decode_stacked_mean(self, parts, length: int) -> torch.Tensor: ...

    def wire_bytes(self, length: int) -> int: ...

    def init_state(self, length: int, device=None) -> torch.Tensor: ...

    def encode_with_state(self, dv: torch.Tensor, state: torch.Tensor
                          ) -> tuple[tuple[torch.Tensor, ...],
                                     torch.Tensor]: ...


def unpack_codes(packed: torch.Tensor, length: int, bits: int
                 ) -> torch.Tensor:
    """``(..., ceil(L/(8/bits)))`` packed bytes -> the ``(..., L)`` f32
    grid values: code ``r`` of byte ``j`` (bits ``[bits*r,
    bits*(r+1))``) is element ``j + r*W``, biased by ``2**(bits-1)``;
    the padded tail is sliced off."""
    p = packed.to(torch.int32)
    mask, bias = (1 << bits) - 1, 1 << (bits - 1)
    q = torch.cat([(p >> (bits * r)) & mask for r in range(8 // bits)],
                  dim=-1) - bias
    return q[..., :length].to(torch.float32)


class StatelessCodec:
    """Base for history-free codecs: the per-worker codec state is a
    zero-length placeholder and ``encode_with_state`` is ``encode``.

    The base ``decode_stacked_sum`` / ``decode_stacked_mean`` reduce the
    decoded stack with ``torch.sum`` / ``torch.mean`` — right for a
    codec whose stack is already f32 wire data (``f32``); the quantized
    codecs override them with the fused sequential reduction, ``topk``
    with a sum of its scattered rows in worker order."""
    stateful = False
    lossless = False

    def init_state(self, length: int, device=None) -> torch.Tensor:
        return torch.zeros((0,), dtype=torch.float32, device=device)

    def encode_with_state(self, dv: torch.Tensor, state: torch.Tensor):
        return self.encode(dv), state

    def decode_stacked_sum(self, parts, length: int) -> torch.Tensor:
        return torch.sum(self.decode_stacked(parts, length), dim=0)

    def decode_stacked_mean(self, parts, length: int) -> torch.Tensor:
        return torch.mean(self.decode_stacked(parts, length), dim=0)


class F32Codec(StatelessCodec):
    """Identity codec: the f32 update IS the wire format."""
    name = "f32"
    lossless = True

    def encode(self, dv: torch.Tensor) -> tuple[torch.Tensor]:
        return (dv,)

    def decode(self, parts, length: int) -> torch.Tensor:
        return parts[0]

    def decode_stacked(self, parts, length: int) -> torch.Tensor:
        return parts[0]

    def wire_bytes(self, length: int) -> int:
        return length * FP_ITEMSIZE


class _QuantCodec(StatelessCodec):
    """An absmax codec with one f32 scale per worker and ``bits``-bit
    codes, ``8 // bits`` to a byte. ``encode`` is kernel K2 and the
    stacked reductions kernel K3 on the card, their plain versions on
    the CPU; ``encode_ref`` and ``decode_reduce_ref`` are always the
    plain versions (the kernels' bit-exact oracles)."""
    bits: int

    def _kernel(self, fn: str):
        """``repro_torch.kernels.{quant,dequant}.<fn>`` for this codec,
        imported late: the kernel modules import this module."""
        from repro_torch.kernels import dequant, quant
        mod = quant if fn.startswith("quantize") else dequant
        return getattr(mod, fn.format(self.name))

    def encode(self, dv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """K2 on the card, its plain version on the CPU."""
        return self._kernel("quantize_pack_{}")(dv)

    def encode_ref(self, dv: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The plain path (and kernel K2's bit-exact oracle)."""
        return self._kernel("quantize_pack_{}_ref")(dv)

    def _grid(self, payload: torch.Tensor, length: int) -> torch.Tensor:
        """The wire payload as f32 grid values (before the scale)."""
        return unpack_codes(payload, length, self.bits)

    def decode(self, parts, length: int) -> torch.Tensor:
        payload, scale = parts
        return self._grid(payload, length) * scale

    def decode_stacked(self, parts, length: int) -> torch.Tensor:
        payload, scale = parts               # (K, wire), (K,)
        return self._grid(payload, length) * scale[:, None]

    def decode_reduce_ref(self, parts, length: int, *, mean: bool
                          ) -> torch.Tensor:
        """The plain sequential reduction (and kernel K3's oracle)."""
        return self._kernel("decode_reduce_{}_ref")(
            parts[0], parts[1], length, mean=mean)

    def decode_stacked_sum(self, parts, length: int) -> torch.Tensor:
        return self._kernel("decode_reduce_{}")(
            parts[0], parts[1], length, mean=False)

    def decode_stacked_mean(self, parts, length: int) -> torch.Tensor:
        return self._kernel("decode_reduce_{}")(
            parts[0], parts[1], length, mean=True)

    def wire_bytes(self, length: int) -> int:
        return -(-length // (8 // self.bits)) + SCALE_BYTES


class Int8Codec(_QuantCodec):
    """Absmax int8 quantization with a per-worker f32 scale — byte for
    byte the reference's quantizer (``scale = absmax/127 + 1e-30``, 1
    for an all-zero update)."""
    name = "int8"
    bits = 8

    def _grid(self, payload: torch.Tensor, length: int) -> torch.Tensor:
        return payload.to(torch.float32)


class Int4Codec(_QuantCodec):
    """Absmax int4 quantization, two elements per byte: ``q =
    clip(round(dv / scale), -7, 7)`` with ``scale = absmax/7.5``, stored
    as ``q + 8`` and packed ``lo | hi << 4`` under split-half pairing."""
    name = "int4"
    bits = 4


class Int2Codec(_QuantCodec):
    """Absmax ternary quantization, four elements per byte: ``q =
    clip(round(dv / scale), -1, 1)`` with ``scale = absmax * 2/3``,
    stored as ``q + 2`` and packed ``q0 | q1<<2 | q2<<4 | q3<<6`` under
    split-quarter pairing. Alone the 3-level grid is too coarse to
    converge; it is meant for ``ef:int2``."""
    name = "int2"
    bits = 2


class TopKCodec(StatelessCodec):
    """Magnitude sparsification: ship only the ``k = min(L, max(1,
    ceil(r*L)))`` largest-|.| entries.

    Wire tuple: ``(values f32 (..., k), indices int32 (..., k),
    threshold f32 (...))``; the threshold, last like every codec's
    scale, is the k-th largest magnitude. ``encode`` is kernel K4 on the
    card and its plain version on the CPU; ``encode_ref`` is always the
    plain version. The decode scatters each row into zeros after
    ``_enforce``, so the threshold is consumed as in the reference, and
    the stacked sum adds the K scattered rows one at a time in worker
    order. The indices of one row are distinct, so a plain ``scatter_``
    per row is exact; no accumulating scatter (``index_add_``), whose
    CUDA atomics add in no fixed order, is used."""

    def __init__(self, r: float):
        self.r = float(r)
        self.name = f"topk(r={self.r:g})"

    def _k(self, length: int) -> int:
        return min(int(length), max(1, math.ceil(self.r * length)))

    def encode(self, dv: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """K4 on the card, its plain version on the CPU."""
        from repro_torch.kernels.topk import topk_select
        return topk_select(dv, self._k(dv.shape[-1]))

    def encode_ref(self, dv: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The plain path (and kernel K4's bit-exact oracle)."""
        from repro_torch.kernels.topk import topk_select_ref
        return topk_select_ref(dv, self._k(dv.shape[-1]))

    @staticmethod
    def _enforce(values: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
        """Drop anything below the advertised threshold: the identity on
        honestly encoded values (``|v| >= thr`` for each of them), kept
        so that the decode reads the threshold as the reference's does."""
        return torch.where(torch.abs(values) >= thr, values,
                           torch.zeros_like(values))

    def decode(self, parts, length: int) -> torch.Tensor:
        values, idx, thr = parts
        out = torch.zeros((length,), dtype=torch.float32, device=values.device)
        return out.scatter_(0, idx.long(), self._enforce(values, thr))

    def decode_stacked(self, parts, length: int) -> torch.Tensor:
        values, idx, thr = parts             # (K, k), (K, k), (K,)
        out = torch.zeros((values.shape[0], length), dtype=torch.float32,
                          device=values.device)
        return out.scatter_(1, idx.long(),
                            self._enforce(values, thr[:, None]))

    def decode_stacked_sum(self, parts, length: int) -> torch.Tensor:
        rows = self.decode_stacked(parts, length)
        total = rows[0].clone()
        for k in range(1, rows.shape[0]):
            total = total + rows[k]
        return total

    def decode_stacked_mean(self, parts, length: int) -> torch.Tensor:
        """The sum divided by K as a tensor (a true division, as
        ``jnp.mean``'s; PyTorch's CUDA division by a Python number
        multiplies by the reciprocal)."""
        total = self.decode_stacked_sum(parts, length)
        return total / torch.full_like(total, float(parts[0].shape[0]))

    def wire_bytes(self, length: int) -> int:
        return 2 * FP_ITEMSIZE * self._k(length) + SCALE_BYTES


class EFWrapper:
    """Error feedback around a lossy base codec (``ef:<base>``).

    ``encode_with_state`` compresses ``e = dv + residual`` with the base
    codec and returns the new residual ``e - decode(encode(e))``; the
    wire format, the reductions and the bytes are the base codec's. The
    plain ``encode`` encodes with a zero residual, i.e. it is the base
    codec's."""
    stateful = True
    lossless = False

    def __init__(self, base: UpdateCodec):
        self.base = base
        self.name = f"ef:{base.name}"

    def init_state(self, length: int, device=None) -> torch.Tensor:
        return torch.zeros((length,), dtype=torch.float32, device=device)

    def encode(self, dv: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.base.encode(dv)

    def encode_ref(self, dv: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.base.encode_ref(dv)

    def encode_with_state(self, dv: torch.Tensor, state: torch.Tensor):
        e = dv + state
        parts = self.base.encode(e)
        decode = self.base.decode_stacked if e.dim() == 2 else self.base.decode
        return parts, e - decode(parts, e.shape[-1])

    def decode(self, parts, length: int) -> torch.Tensor:
        return self.base.decode(parts, length)

    def decode_stacked(self, parts, length: int) -> torch.Tensor:
        return self.base.decode_stacked(parts, length)

    def decode_stacked_sum(self, parts, length: int) -> torch.Tensor:
        return self.base.decode_stacked_sum(parts, length)

    def decode_stacked_mean(self, parts, length: int) -> torch.Tensor:
        return self.base.decode_stacked_mean(parts, length)

    def wire_bytes(self, length: int) -> int:
        return self.base.wire_bytes(length)


CODECS: dict[str, UpdateCodec] = {
    c.name: c for c in (F32Codec(), Int8Codec(), Int4Codec(), Int2Codec())}


@functools.lru_cache(maxsize=None)
def get_codec(name: str) -> UpdateCodec:
    """Validated codec lookup, cached so that every call site naming the
    same codec shares one object: a named codec, ``topk`` /
    ``topk(r=<float>)`` / ``topk(<float>)`` with ``0 < r <= 1`` (bare
    ``topk`` keeps 1%), or ``ef:<lossy base>``; ``ValueError`` for a bad
    ``topk`` argument, a nested ``ef:ef:``, an ``ef:`` around a lossless
    codec, or an unknown name."""
    if name in CODECS:
        return CODECS[name]
    if name.startswith("ef:"):
        inner = name[len("ef:"):]
        if inner.startswith("ef:"):
            raise ValueError(
                f"bad codec {name!r}: error feedback does not nest — one "
                f"residual per worker; use a single 'ef:' prefix")
        base = get_codec(inner)
        if base.lossless:
            raise ValueError(
                f"bad codec {name!r}: {inner!r} round-trips exactly, so "
                f"there is no quantization error to feed back — drop the "
                f"'ef:' prefix")
        return EFWrapper(base)
    m = _TOPK_RE.fullmatch(name)
    if m is not None:
        arg = m.group("arg")
        if not arg:
            r = TOPK_DEFAULT_R
        else:
            body = arg[2:] if arg.startswith("r=") else arg
            try:
                r = float(body)
            except ValueError:
                raise ValueError(
                    f"bad codec {name!r}: expected topk(r=<float>), got "
                    f"argument {arg!r}") from None
        if not 0.0 < r <= 1.0:
            raise ValueError(
                f"bad codec {name!r}: keep ratio r={r!r} must satisfy "
                f"0 < r <= 1")
        return TopKCodec(r)
    raise ValueError(
        f"unknown update codec {name!r}; known: {tuple(CODECS)} plus "
        f"'topk(r=<float>)' and the 'ef:<lossy base>' wrapper")
