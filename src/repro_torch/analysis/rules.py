"""The cell-scoped lint rules over recorded collective logs (the port of
``repro.analysis.rules``, whose rules read the compiled HLO).

Each rule receives a :class:`repro_torch.analysis.cells.CellContext`
(every rank's log of the cell's run) and returns a (possibly empty)
list of findings; each keeps the reference's id and severity. The
reference's ``f32-intermediate`` and ``single-compile`` read the
compiled graph and the jit cache, which the port does not have, so they
are not registered here.

Importing this module populates the registry in
:mod:`repro_torch.analysis.findings`.
"""
from __future__ import annotations

from repro_torch.analysis.findings import finding, register_rule
from repro_torch.analysis.traffic import (PAYLOAD_OPS, codec_wire_dtype,
                                          derived_round_traffic,
                                          quantized_wire_dtypes)
from repro_torch.comm.collectives import CollectiveLog, padded_len

FP_BYTES = 4                 # the exchanged update is f32
SCALE_BYTES = 4              # one f32 absmax scale per worker payload


def _rounds(ctx):
    """``(rank, round, that round's calls)`` over every rank's log."""
    for r, log in enumerate(ctx.logs):
        log = CollectiveLog(log)
        for t in log.rounds():
            yield r, t, log.of_round(t)


def _in_rounds(log) -> list:
    """The calls a log's rounds made (the run's set-up and its final
    gather of the workers' state are not round traffic)."""
    return [c for c in log if c.round is not None]


@register_rule("bytes-match", "error")
def rule_bytes_match(ctx):
    """Modelled comm_bytes_per_round equals the bytes derived from each
    recorded round's calls (the paper's modelled-vs-actual gap, asserted
    to zero)."""
    out = []
    if ctx.K < 2:
        return out
    modelled = ctx.trainer.comm_bytes_per_round()
    check_rs = (ctx.exchange.scheme.transport == "reduce_scatter"
                and ctx.exchange.backend == "xla")
    expect_rs = padded_len(ctx.update_len, ctx.K) * FP_BYTES
    for r, t, calls in _rounds(ctx):
        derived = derived_round_traffic(calls, ctx.exchange, ctx.K)
        if modelled != derived:
            out.append(finding(
                "bytes-match", ctx.id,
                f"modelled comm_bytes_per_round {modelled} != {derived} "
                f"derived from rank {r}'s calls of round {t} (K={ctx.K})"))
        # the reduce-scatter operand must be the K-padded update vector
        # (the one padded_len owner: repro_torch.comm.collectives)
        rs_bytes = sum(c.nbytes for c in calls if c.op == "reduce_scatter")
        if check_rs and rs_bytes != expect_rs:
            out.append(finding(
                "bytes-match", ctx.id,
                f"rank {r}'s reduce-scatter operand in round {t} is "
                f"{rs_bytes} bytes; padded_len({ctx.update_len}, {ctx.K}) "
                f"models {expect_rs}"))
    return out


@register_rule("wire-dtype", "error")
def rule_wire_dtype(ctx):
    """Codec cells ship only their quantized dtype on the wire (int8 for
    int8, packed uint8 for int4/int2, the same through the ef: wrapper)
    and no f32 payload escapes; topk ships f32 values, so it expects
    (and must show) no quantized dtype."""
    out = []
    if ctx.K < 2:
        return out
    codec = ctx.exchange.scheme.codec.name
    expect_dt = codec_wire_dtype(codec)
    expect = {expect_dt} if expect_dt else set()
    for r, log in enumerate(ctx.logs):
        log = _in_rounds(log)
        seen = quantized_wire_dtypes(log)
        if seen != expect:
            out.append(finding(
                "wire-dtype", ctx.id,
                f"rank {r}'s quantized payload dtypes {sorted(seen) or '{}'} "
                f"do not match codec {codec!r} (expected "
                f"{sorted(expect) or '{}'})"))
        if not expect_dt:
            continue
        # a quantizing codec may move f32 only as per-worker scales
        for c in log:
            if (c.op in PAYLOAD_OPS and c.dtype == "float32"
                    and c.nbytes > SCALE_BYTES):
                out.append(finding(
                    "wire-dtype", ctx.id,
                    f"rank {r}'s {c.op} in round {c.round} ships "
                    f"{c.nbytes} bytes of float32 under the {codec} "
                    f"codec: f32 payload escaped to the wire"))
    return out


def _is_single_ring(pairs, K: int) -> bool:
    if pairs is None or len(pairs) != K:
        return False
    nxt = dict(pairs)
    if len(nxt) != K or set(nxt) != set(range(K)) \
            or set(nxt.values()) != set(range(K)):
        return False
    # follow the permutation from 0: must return to 0 in exactly K hops
    seen, cur = 0, 0
    while True:
        cur = nxt[cur]
        seen += 1
        if cur == 0:
            return seen == K
        if seen > K:
            return False


@register_rule("ring-topology", "error")
def rule_ring_topology(ctx):
    """Every ring-backend hop's (rank, peer) pairs, gathered from all
    ranks' logs, form one closed K-ring (the deadlock/ordering invariant
    per hop)."""
    out = []
    if ctx.exchange.backend != "ring" or ctx.K < 2:
        return out
    sends = [[c for c in _in_rounds(log) if c.op == "send"]
             for log in ctx.logs]
    if not any(sends):
        return [finding("ring-topology", ctx.id,
                        "ring backend logged no sends")]
    if len({len(s) for s in sends}) != 1:
        return [finding("ring-topology", ctx.id,
                        f"the ranks logged {[len(s) for s in sends]} sends: "
                        f"a hop without a partner")]
    for h, hop in enumerate(zip(*sends)):
        pairs = tuple((r, c.peer) for r, c in enumerate(hop))
        if not _is_single_ring(pairs, ctx.K):
            out.append(finding(
                "ring-topology", ctx.id,
                f"hop {h} (round {hop[0].round}) pairs {pairs} are not a "
                f"single closed {ctx.K}-ring"))
    return out


def _signature(log) -> list:
    """A log's per-round sequence of (op, dtype, bytes)."""
    log = CollectiveLog(log)
    return [[(c.op, c.dtype, c.nbytes) for c in log.of_round(t)]
            for t in log.rounds()]


@register_rule("membership-invariant", "error")
def rule_membership_invariant(ctx):
    """Elastic drop: every round of a drop: cell makes the same calls as
    the same spec at full membership, on every rank."""
    if ctx.exchange.membership.empty or ctx.K < 2:
        return []
    from repro_torch.analysis.cells import full_membership_spec
    full_spec = full_membership_spec(ctx.exchange)
    vctx = ctx.run_variant(full_spec)
    bad = [r for r, (a, b) in enumerate(zip(ctx.logs, vctx.logs))
           if _signature(a) != _signature(b)]
    if bad or len(ctx.logs) != len(vctx.logs):
        return [finding(
            "membership-invariant", ctx.id,
            f"ranks {bad}: the calls differ from full membership "
            f"({full_spec!r}): membership masking leaked into the "
            f"collectives")]
    return []
