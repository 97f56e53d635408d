"""Update codecs: what one worker's update vector looks like on the wire
(the port of ``repro.comm.codec``, for the ``f32`` and ``int8`` codecs).

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
    worker (1 byte/element + 4). On the card ``encode`` launches kernel
    K2 (``repro_torch.kernels.quant``) and the stacked reductions launch
    kernel K3 (``repro_torch.kernels.dequant``); on the CPU both run
    their plain versions. Both are bit-identical to the reference's
    ``encode_ref`` and ``decode_reduce_ref``: the reduction adds the K
    decoded rows in worker order and the mean is the sum times the
    f32-rounded 1/K.

The reference's ``int4``, ``int2``, ``topk(r=..)`` and ``ef:<base>``
codecs are not ported yet (ROADMAP.md Queue 1 item 5); asking for one
raises ``NotImplementedError``.

Zero is a fixed point of both codecs: an all-zero update gets scale 1
and decodes to exact zeros.
"""
from __future__ import annotations

import functools
import re
from typing import Protocol, runtime_checkable

import torch

FP_ITEMSIZE = 4        # every dense array in the system is float32
SCALE_BYTES = 4        # one f32 absmax scale per worker per round

INT8_QMAX = 127.0      # int8 grid: 255 levels across [-absmax, absmax]
INT8_EPS = 1e-30       # added to absmax/127, as the reference has always done

# names the reference knows and the port does not have yet
_UNPORTED = ("int4", "int2")
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
                       ``(K, L)`` f32 stack (diagnostic/test surface).
    ``decode_stacked_sum`` / ``decode_stacked_mean``
                       the gathered wire tuple -> the ``(L,)`` reduced
                       aggregate directly — the call the exchanges make.
    ``wire_bytes``     per-worker payload bytes for a length-L update.
    """
    name: str
    lossless: bool

    def encode(self, dv: torch.Tensor) -> tuple[torch.Tensor, ...]: ...

    def decode(self, parts, length: int) -> torch.Tensor: ...

    def decode_stacked(self, parts, length: int) -> torch.Tensor: ...

    def decode_stacked_sum(self, parts, length: int) -> torch.Tensor: ...

    def decode_stacked_mean(self, parts, length: int) -> torch.Tensor: ...

    def wire_bytes(self, length: int) -> int: ...


class StatelessCodec:
    """Base for history-free codecs (every codec ported so far; the
    reference's stateful ``ef:`` wrapper comes with ROADMAP.md Queue 1
    item 5).

    The base ``decode_stacked_sum`` / ``decode_stacked_mean`` reduce the
    decoded stack with ``torch.sum`` / ``torch.mean`` — right for a
    codec whose stack is already f32 wire data (``f32``); the quantized
    codecs override them with the fused sequential reduction."""
    lossless = False

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


class Int8Codec(StatelessCodec):
    """Absmax int8 quantization with a per-worker f32 scale — byte for
    byte the reference's quantizer (``scale = absmax/127 + 1e-30``, 1
    for an all-zero update)."""
    name = "int8"

    def encode(self, dv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """K2 on the card, its plain version on the CPU."""
        from repro_torch.kernels.quant import quantize_pack_int8
        return quantize_pack_int8(dv)

    def encode_ref(self, dv: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The plain path (and kernel K2's bit-exact oracle)."""
        from repro_torch.kernels.quant import quantize_pack_int8_ref
        return quantize_pack_int8_ref(dv)

    def decode(self, parts, length: int) -> torch.Tensor:
        q, scale = parts
        return q.to(torch.float32) * scale

    def decode_stacked(self, parts, length: int) -> torch.Tensor:
        q, scale = parts                     # (K, L), (K,)
        return q.to(torch.float32) * scale[:, None]

    def decode_reduce_ref(self, parts, length: int, *, mean: bool
                          ) -> torch.Tensor:
        """The plain sequential reduction (and kernel K3's oracle)."""
        from repro_torch.kernels.dequant import decode_reduce_int8_ref
        return decode_reduce_int8_ref(parts[0], parts[1], length, mean=mean)

    def decode_stacked_sum(self, parts, length: int) -> torch.Tensor:
        from repro_torch.kernels.dequant import decode_reduce_int8
        return decode_reduce_int8(parts[0], parts[1], length, mean=False)

    def decode_stacked_mean(self, parts, length: int) -> torch.Tensor:
        from repro_torch.kernels.dequant import decode_reduce_int8
        return decode_reduce_int8(parts[0], parts[1], length, mean=True)

    def wire_bytes(self, length: int) -> int:
        return length + SCALE_BYTES


CODECS: dict[str, UpdateCodec] = {c.name: c for c in (F32Codec(), Int8Codec())}


@functools.lru_cache(maxsize=None)
def get_codec(name: str) -> UpdateCodec:
    """Validated codec lookup: a ported codec, ``NotImplementedError``
    for a reference codec the port does not have yet, ``ValueError``
    for a name neither package knows."""
    if name in CODECS:
        return CODECS[name]
    if (name in _UNPORTED or name.startswith("ef:")
            or _TOPK_RE.fullmatch(name)):
        raise NotImplementedError(
            f"codec {name!r} is not ported yet: the port has "
            f"{tuple(CODECS)}; int4, int2, topk and ef: are ROADMAP.md "
            f"Queue 1 item 5")
    raise ValueError(
        f"unknown update codec {name!r}; known: {tuple(CODECS)} (the "
        f"reference's int4, int2, 'topk(r=<float>)' and 'ef:<base>' are "
        f"not ported yet)")
