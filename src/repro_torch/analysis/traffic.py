"""Derive per-round wire traffic from a recorded collective log (the
port of ``repro.analysis.traffic``, which reads the compiled HLO).

A :func:`repro_torch.comm.collectives.recording` logs every call the
sharded driver makes into its process group: the op, the operand's
dtype and the operand bytes this rank put in. The reference's rule
turns one rank's calls of one round into the bytes the whole exchange
moved (paper §4's per-algorithm traffic decomposition):

- master-centric transports (``persistent``, ``spark_faithful``,
  ``compressed:*`` on the ``xla`` backend): every worker sends its
  operand up and receives the aggregate back, so derived = 2 x K x the
  operand bytes, leaving out the scalar f32 metric all-reduce (4 bytes),
  a convergence probe, not update traffic;
- ``reduce_scatter``: the ring volume — (K-1) x the reduce-scatter
  operand plus K x (K-1) x the all-gather shard operand;
- ``ring`` backend: K x the send operand bytes (each hop is one send by
  every one of the K ranks).

The log is what every rank moved, whatever the membership schedule: a
dropped worker still ships its zero update, so under ``drop:`` the
derived bytes stay those of all K while the byte model's
``bytes_per_round(K_live=...)`` prices the live workers only.
"""
from __future__ import annotations

# the one scalar f32 convergence-metric all-reduce every round carries
SCALAR_METRIC_BYTES = 4

# wire dtypes a quantizing codec may put on the wire
QUANTIZED_DTYPES = ("int8", "uint8")

# codec name -> the sub-f32 dtype its payload collective must carry
# (None: full-precision f32 is the expected wire format). Packed int4
# and int2 both travel as uint8 bytes (two resp. four codes a byte).
CODEC_WIRE_DTYPE = {"f32": None, "int8": "int8", "int4": "uint8",
                    "int2": "uint8"}

# the ops that move an update's (or a state block's) payload
PAYLOAD_OPS = ("all_gather", "send")


def codec_wire_dtype(codec: str) -> str | None:
    """Expected sub-f32 wire dtype for any codec grammar name. The
    ``ef:`` wrapper changes what gets encoded, not the wire format;
    ``topk(r=..)`` ships f32 values and int32 indices, so it (like
    ``f32``) expects no quantized dtype on the wire."""
    return CODEC_WIRE_DTYPE.get(codec.removeprefix("ef:"))


def _is_metric_all_reduce(call) -> bool:
    return call.op == "all_reduce" and call.nbytes <= SCALAR_METRIC_BYTES


def derived_round_traffic(log, exchange, K: int) -> int:
    """Bytes a round moved, from one rank's logged calls of that round.

    ``exchange`` is a resolved ``ExchangeConfig`` (only ``.backend`` and
    ``.scheme.transport`` are read)."""
    if K < 2:
        return 0
    if exchange.backend == "ring":
        return K * sum(c.nbytes for c in log if c.op == "send")
    if exchange.scheme.transport == "reduce_scatter":
        rs = sum(c.nbytes for c in log if c.op == "reduce_scatter")
        ag = sum(c.nbytes for c in log if c.op == "all_gather")
        return (K - 1) * rs + K * (K - 1) * ag
    return 2 * K * sum(c.nbytes for c in payload_collectives(log))


def all_to_all_bytes(log, K: int) -> int:
    """Bytes this rank's all-to-alls sent to the other ranks: (K-1)/K of
    each logged operand (the chunk addressed to itself stays put)."""
    return sum(c.nbytes * (K - 1) // K for c in log if c.op == "all_to_all")


def quantized_wire_dtypes(log) -> set[str]:
    """Sub-f32 dtypes present in payload-moving calls (all-gathers and
    ring sends): int8 for int8, uint8 for packed int4 and int2."""
    return {c.dtype for c in log
            if c.op in PAYLOAD_OPS and c.dtype in QUANTIZED_DTYPES}


def payload_collectives(log) -> tuple:
    """Calls that move update or state payload (the metric all-reduce
    left out)."""
    return tuple(c for c in log if not _is_metric_all_reduce(c))
