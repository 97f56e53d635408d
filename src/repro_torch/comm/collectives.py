"""The byte model of the exchange fabric (the port of
``repro.comm.collectives``, cost model only).

The virtual driver sums the stacked per-worker updates on one card and
moves no bytes between devices, so the port so far has only what prices
an exchange: ``padded_len`` and the reference's fused (``xla``) backend
formula, ``wire_bytes``, which ``CommScheme.bytes_per_round`` reports,
with the live-worker count of an elastic (``drop:``) round. The
collectives themselves and the explicit ``ring`` fabric come with the
sharded driver (ROADMAP.md Queue 1 item 8).
"""
from __future__ import annotations

from repro_torch.comm.codec import FP_ITEMSIZE, UpdateCodec


def padded_len(length: int, K: int) -> int:
    """The K-padded vector length every reduce-scatter-style exchange
    operates on: ``length`` rounded up to a multiple of ``K``."""
    return -(length // -K) * K


def wire_bytes(transport: str, codec: UpdateCodec, update_len: int, K: int,
               *, local_state_len: int = 0, K_live: int | None = None) -> int:
    """Bytes on the wire per round with one fused collective per
    exchange. Master-centric transports: K workers send their
    codec-encoded update up and receive the aggregate back —
    ``codec.wire_bytes`` per worker each way; ``spark_faithful``
    additionally ships the ``local_state_len`` total elements of
    per-worker persistent state up and down in f32. ``reduce_scatter``
    has no master: each worker moves (K-1)/K of the K-padded update each
    way on the ring — ``2*(K-1)*padded_len*4`` bytes in total.

    ``K_live`` (elastic membership) scales the master-centric volume by
    the live-worker count (a dropped worker ships nothing); the
    ``reduce_scatter`` ring is membership-oblivious. ``None`` means all
    K live."""
    if transport == "reduce_scatter":
        return 2 * (K - 1) * padded_len(update_len, K) * FP_ITEMSIZE
    persistent = transport != "spark_faithful"
    if K_live is None:
        return (2 * K * codec.wire_bytes(update_len)
                + (0 if persistent else 2 * local_state_len * FP_ITEMSIZE))
    v = 2 * K_live * codec.wire_bytes(update_len)
    a = (0 if persistent
         else 2 * (local_state_len // K) * K_live * FP_ITEMSIZE)
    return v + a
