"""Pluggable collective backends: the exchange *fabric* under the
transport x codec exchange surface (the port of
``repro.comm.collectives``).

The sharded driver runs one process per worker in a
``torch.distributed`` process group. Every call into the group goes
through one :class:`Fabric`, which knows the group's size and this
rank, stages tensors where the group's backend needs them and records
what it moved; :func:`data_fabric` makes one of a data-axis argument
and :func:`pmean` averages over it (the local-update rounds and the
train step's gradient sync). On top of it two backends, under the reference's names
so that every exchange spec parses as it does there:

  * ``xla``   one fused ``torch.distributed`` call per exchange
    (``all_reduce``; ``all_gather`` into one tensor in worker order;
    ``reduce_scatter`` of the K-padded vector, then ``all_gather``).
    The name is the reference's, whose fused collectives are XLA's.
  * ``ring``  explicit neighbour hops with ``batch_isend_irecv``: each
    of the K-1 hops sends to ``rank+1`` and receives from ``rank-1``,
    both posted together (a blocking send on each rank would deadlock
    the ring). Sums run as the classic reduce-scatter ring and then
    the gather ring; gathers fill a canonical ``(K, ...)`` buffer, so a
    ``compressed`` ring decodes and sums the same stacked wire tuple as
    the fused path. Under ``compressed`` the hops carry the encoded
    tuple in its wire dtype (int8, packed uint8, or topk's f32 values
    and int32 indices), never a dequantized f32.

Every backend owns the cost model of its mechanics, formula for
formula the reference's: :meth:`wire_bytes` (bytes on the wire per
round) and :meth:`latency_hops` (sequential per-hop latencies).
``repro_torch.analysis.traffic`` derives the same bytes from a
:func:`recording` of the fabric's calls.

The virtual driver moves no bytes and does not come here.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import torch
import torch.distributed as tdist

from repro_torch.comm.codec import FP_ITEMSIZE, UpdateCodec
from repro_torch.utils import spans
from repro_torch.utils.partitioning import bound_mesh, sub_mesh

COLLECTIVE_BACKENDS = ("xla", "ring")

# torch renamed the fused tensor collectives; take what is installed
_ALL_GATHER = getattr(tdist, "all_gather_single", None) \
    or tdist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(tdist, "reduce_scatter_single", None) \
    or tdist.reduce_scatter_tensor


def padded_len(length: int, K: int) -> int:
    """The K-padded vector length every reduce-scatter-style exchange
    operates on: ``length`` rounded up to a multiple of ``K``."""
    return -(length // -K) * K


# ---------------------------------------------------------------------------
# the one choke point into the process group, and its recording
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LoggedCall:
    """One call into the process group: the op (``all_reduce``,
    ``all_gather``, ``reduce_scatter``, ``all_to_all``, ``send`` or
    ``broadcast``), the
    operand's dtype (``torch`` name: ``float32``, ``int8``, ...), the
    operand bytes this rank put in, whether the operand was copied to
    the host for the group, the 1-based round it belongs to (``None``
    outside a round) and, for a ``send``, the global rank it went to
    (``None`` for every other op)."""
    op: str
    dtype: str
    nbytes: int
    staged: bool
    round: int | None
    peer: int | None = None
    K: int | None = None


class CollectiveLog(list):
    """The :class:`LoggedCall` entries of a :func:`recording`, in call
    order."""

    def of_round(self, t: int) -> list:
        return [c for c in self if c.round == t]

    def rounds(self) -> list:
        return sorted({c.round for c in self if c.round is not None})


_RECORDING: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_collective_log", default=None)


@contextlib.contextmanager
def recording():
    """Record every call any :class:`Fabric` makes while the block runs
    into the yielded :class:`CollectiveLog`."""
    log = CollectiveLog()
    token = _RECORDING.set(log)
    try:
        yield log
    finally:
        _RECORDING.reset(token)


class Fabric:
    """One process group as the exchange sees it: ``K`` ranks, this
    ``rank``, and the only place the exchange calls into the group.

    Host staging: a ``gloo`` group takes host tensors, so a CUDA operand
    is copied to the host and the result back to the operand's device,
    explicitly (a copy to the host waits for the device). An ``nccl``
    group takes device tensors, and a host operand raises. ``round`` is
    the 1-based round the driver is in, which every recorded call
    carries."""

    def __init__(self, group=None):
        if not tdist.is_initialized():
            raise RuntimeError(
                "no torch.distributed process group is initialized; start "
                "the ranks with repro_torch.launch.dist (its CLI or "
                "spawn())")
        self.group = group
        self.K = tdist.get_world_size(group)
        self.rank = tdist.get_rank(group)
        self.backend = str(tdist.get_backend(group))
        self.round: int | None = None

    def _global(self, r: int) -> int:
        return r if self.group is None else tdist.get_global_rank(
            self.group, r)

    def _stage(self, x: torch.Tensor) -> tuple[torch.Tensor, bool]:
        x = x.contiguous()
        if self.backend == "nccl":
            if not x.is_cuda:
                raise ValueError(f"an nccl group takes device tensors; got "
                                 f"a {x.device} tensor")
            return x, False
        if x.is_cuda:
            return x.cpu(), True
        return x, False

    def _record(self, op: str, x: torch.Tensor, staged: bool,
                peer: int | None = None) -> None:
        log = _RECORDING.get()
        if log is not None:
            log.append(LoggedCall(op, str(x.dtype).removeprefix("torch."),
                                  x.numel() * x.element_size(), staged,
                                  self.round, peer, self.K))

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``."""
        h, staged = self._stage(x)
        h = h.clone() if h is x else h
        self._record("all_reduce", h, staged)
        tdist.all_reduce(h, group=self.group)
        return h.to(x.device) if staged else h

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order:
        ``(K * x.shape[0], ...)``, rows ``rank`` of a ``(1, ...)`` part
        in slot ``rank``."""
        h, staged = self._stage(x)
        out = torch.empty((self.K * h.shape[0],) + tuple(h.shape[1:]),
                          dtype=h.dtype, device=h.device)
        self._record("all_gather", h, staged)
        _ALL_GATHER(out, h, group=self.group)
        return out.to(x.device) if staged else out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's segment of the sum of every rank's ``x`` (whose
        length is a multiple of K)."""
        h, staged = self._stage(x)
        out = torch.empty((h.shape[0] // self.K,), dtype=h.dtype,
                          device=h.device)
        self._record("reduce_scatter", h, staged)
        _REDUCE_SCATTER(out, h, group=self.group)
        return out.to(x.device) if staged else out

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """One ring hop: send ``x`` to ``rank+1`` and receive the same
        shape and dtype from ``rank-1``, both posted together. On one
        rank the hop is ``x`` itself, and nothing is sent (gloo cannot
        send to its own rank)."""
        if self.K == 1:
            return x
        h, staged = self._stage(x)
        buf = torch.empty_like(h)
        dst = self._global((self.rank + 1) % self.K)
        ops = [tdist.P2POp(tdist.isend, h, dst, self.group),
               tdist.P2POp(tdist.irecv, buf, self._global((self.rank - 1)
                                                          % self.K),
                           self.group)]
        self._record("send", h, staged, dst)
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        return buf.to(x.device) if staged else buf

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int,
                   tiled: bool = True) -> torch.Tensor:
        """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
        ``x`` split along ``split_axis`` into K equal chunks, chunk ``j``
        sent to rank ``j``, and the K chunks received concatenated along
        ``concat_axis`` in rank order. One ``all_to_all_single`` (gloo
        has it; a CUDA operand is staged through the host), whose
        operand is recorded; a true all-to-all moves (K-1)/K of it
        (``analysis.traffic.all_to_all_bytes``)."""
        if not tiled:
            raise NotImplementedError("Fabric.all_to_all: tiled=True only")
        a, b, K = split_axis % x.ndim, concat_axis % x.ndim, self.K
        if x.shape[a] % K:
            raise ValueError(f"all_to_all: dim {a} of {tuple(x.shape)} is "
                             f"not a multiple of {K}")
        parts = x.reshape(*x.shape[:a], K, x.shape[a] // K,
                          *x.shape[a + 1:]).movedim(a, 0)
        h, staged = self._stage(parts)
        out = torch.empty_like(h)
        self._record("all_to_all", h, staged)
        tdist.all_to_all_single(out, h, group=self.group)
        out = out.to(x.device) if staged else out
        chunk = out.shape[1:]
        return out.movedim(0, b).reshape(*chunk[:b], K * chunk[b],
                                         *chunk[b + 1:])

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank."""
        h, staged = self._stage(x)
        h = h.clone() if h is x else h
        self._record("broadcast", h, staged)
        tdist.broadcast(h, self._global(0), group=self.group)
        return h.to(x.device) if staged else h


def data_fabric(axis_name) -> Fabric | None:
    """The fabric a round exchanges over: ``None`` (no exchange), a
    :class:`Fabric`, a ``torch.distributed`` process group wrapped in
    one, or a mesh-axis name (or a tuple of names) of the mesh that
    ``launch.build.partitioning`` binds: the group of that sub-mesh,
    through this rank. An axis name with no mesh bound raises, as an
    unbound axis name does in the reference."""
    if axis_name is None or isinstance(axis_name, Fabric):
        return axis_name
    if isinstance(axis_name, tdist.ProcessGroup):
        return Fabric(axis_name)
    names = (axis_name,) if isinstance(axis_name, str) else axis_name
    if not (isinstance(names, tuple) and names
            and all(isinstance(n, str) for n in names)):
        raise TypeError(
            f"data axis {axis_name!r}: takes None, a repro_torch.comm."
            f"collectives.Fabric, a torch.distributed process group, or "
            f"mesh-axis names")
    mesh = bound_mesh()
    if mesh is None or not set(names) <= set(mesh.mesh_dim_names):
        raise NameError(f"unbound axis name: {axis_name!r} (no mesh with "
                        f"these axes is bound; bind one with "
                        f"repro_torch.launch.build.partitioning)")
    return Fabric(sub_mesh(mesh, names).get_group())


def pmean(x: torch.Tensor, fabric: Fabric) -> torch.Tensor:
    """The mean of every rank's ``x`` in its own dtype: the all-reduced
    sum divided by K as a tensor (a true quotient on the card)."""
    total = fabric.all_reduce(x)
    return total / torch.full_like(total, float(fabric.K))


# ---------------------------------------------------------------------------
# the backends
# ---------------------------------------------------------------------------
@runtime_checkable
class CollectiveBackend(Protocol):
    """One collective fabric: the primitive collectives the exchange
    transports compose, plus the matching byte/latency cost model.

    ``all_gather`` must stack per-rank values in canonical worker order
    (slot ``j`` holds rank ``j``'s value) so transports that decode +
    sum gathered parts are numerically backend-independent.
    """

    name: str

    def all_reduce(self, x: torch.Tensor, fabric: Fabric) -> torch.Tensor:
        """Sum the per-rank 1-D f32 vector across the ranks."""
        ...

    def all_gather(self, x: torch.Tensor, fabric: Fabric) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0, canonical worker
        order: a ``(1, ...)`` part becomes ``(K, ...)`` with slot ``j`` =
        rank ``j``."""
        ...

    def reduce_scatter_gather(self, x: torch.Tensor, fabric: Fabric
                              ) -> torch.Tensor:
        """All-reduce decomposed as reduce-scatter + all-gather of the
        K-padded vector; returns the summed vector truncated to
        ``len(x)``."""
        ...

    def wire_bytes(self, transport: str, codec: UpdateCodec,
                   update_len: int, K: int, *, local_state_len: int = 0,
                   K_live: int | None = None) -> int:
        """Modelled bytes on the wire per round for one (transport,
        codec) exchange on this fabric."""
        ...

    def latency_hops(self, transport: str, K: int) -> int:
        """Sequential per-hop latencies one exchange pays."""
        ...


class XLABackend:
    """One fused ``torch.distributed`` call per exchange (the
    reference's fused XLA collectives, under their name)."""

    name = "xla"

    def all_reduce(self, x, fabric: Fabric):
        return fabric.all_reduce(x)

    def all_gather(self, x, fabric: Fabric):
        return fabric.all_gather(x)

    def reduce_scatter_gather(self, x, fabric: Fabric):
        # reduce-scatter the (padded) vector so each rank owns one
        # reduced segment, then all-gather the segments back
        L, K = x.shape[0], fabric.K
        Lp = padded_len(L, K)
        if Lp != L:
            x = torch.cat([x, torch.zeros((Lp - L,), dtype=x.dtype,
                                          device=x.device)])
        gathered = fabric.all_gather(fabric.reduce_scatter(x))
        # the truncation is asserted against the same padded_len the
        # byte model charges
        assert gathered.shape[0] == Lp, (gathered.shape, Lp)
        return gathered[:L]

    def wire_bytes(self, transport: str, codec: UpdateCodec,
                   update_len: int, K: int, *, local_state_len: int = 0,
                   K_live: int | None = None) -> int:
        """Master-centric transports: K workers send their codec-encoded
        update up and receive the aggregate back — ``codec.wire_bytes``
        per worker each way; ``spark_faithful`` additionally ships the
        ``local_state_len`` total elements of per-worker persistent
        state up and down in f32. ``reduce_scatter`` has no master: each
        worker moves (K-1)/K of the K-padded update each way on the ring
        — ``2*(K-1)*padded_len*4`` bytes in total.

        ``K_live`` (elastic membership) scales the master-centric volume
        by the live-worker count (a dropped worker ships nothing); the
        ``reduce_scatter`` ring is membership-oblivious. ``None`` means
        all K live."""
        if transport == "reduce_scatter":
            return 2 * (K - 1) * padded_len(update_len, K) * FP_ITEMSIZE
        persistent = transport != "spark_faithful"
        if K_live is None:
            return (2 * K * codec.wire_bytes(update_len)
                    + (0 if persistent
                       else 2 * local_state_len * FP_ITEMSIZE))
        v = 2 * K_live * codec.wire_bytes(update_len)
        a = (0 if persistent
             else 2 * (local_state_len // K) * K_live * FP_ITEMSIZE)
        return v + a

    def latency_hops(self, transport: str, K: int) -> int:
        """One fused collective = one latency, whatever the transport."""
        return 1


class RingBackend:
    """Explicit neighbour hops: gathers fill a canonical ``(K, ...)``
    buffer — hop ``h`` delivers the part of rank ``rank - h (mod K)`` —
    so transports that decode + sum gathered parts are bit-identical to
    the fused path; the sum transports reduce in ring order and differ
    from ``all_reduce`` only in float rounding."""

    name = "ring"

    def _gather(self, x: torch.Tensor, fabric: Fabric) -> torch.Tensor:
        """Canonical-order ring all-gather of ``x`` along dim 0."""
        K, idx, n = fabric.K, fabric.rank, x.shape[0]
        buf = torch.empty((K * n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        buf[idx * n:(idx + 1) * n] = x
        cur = x
        for h in range(1, K):
            cur = fabric.shift(cur)
            src = (idx - h) % K
            buf[src * n:(src + 1) * n] = cur
        return buf

    def all_gather(self, x, fabric: Fabric):
        return self._gather(x, fabric)

    def all_reduce(self, x, fabric: Fabric):
        return self.reduce_scatter_gather(x, fabric)

    def reduce_scatter_gather(self, x, fabric: Fabric):
        """The classic ring all-reduce: K-1 reduce-scatter hops (each
        rank ends owning the fully-reduced segment matching its index),
        then K-1 all-gather hops reassembling the segments in canonical
        order."""
        L, K, idx = x.shape[0], fabric.K, fabric.rank
        if K == 1:
            return x
        Lp = padded_len(L, K)
        if Lp != L:
            x = torch.cat([x, torch.zeros((Lp - L,), dtype=x.dtype,
                                          device=x.device)])
        segs = x.reshape(K, Lp // K)
        # rank i starts with its own contribution to segment (i-1) mod K;
        # each hop forwards the partial sum and adds the local
        # contribution to the segment just received
        acc = segs[(idx - 1) % K]
        for h in range(1, K):
            acc = fabric.shift(acc) + segs[(idx - 1 - h) % K]
        gathered = self._gather(acc, fabric)
        assert gathered.shape[0] == Lp, (gathered.shape, Lp)
        return gathered[:L]

    def wire_bytes(self, transport: str, codec: UpdateCodec,
                   update_len: int, K: int, *, local_state_len: int = 0,
                   K_live: int | None = None) -> int:
        """Ring traffic: every hop, every rank forwards one part.

        * sum transports (``persistent``, ``reduce_scatter``): K-1
          reduce-scatter hops + K-1 all-gather hops of one
          ``padded_len/K`` f32 segment per rank —
          ``2*(K-1)*padded_len*4`` bytes in total.
        * ``compressed``: one gather ring of the codec-encoded wire
          tuple — K ranks x (K-1) hops x ``codec.wire_bytes``.
        * ``spark_faithful``: a full-vector update gather ring plus a
          per-worker state-block gather ring —
          ``K*(K-1)*update_len*4 + (K-1)*local_state_len*4``.

        The ring is membership-oblivious, so ``K_live`` is ignored."""
        del K_live
        if K < 2:
            return 0    # no hops — a 1-rank ring moves nothing
        if transport == "compressed":
            return K * (K - 1) * codec.wire_bytes(update_len)
        if transport == "spark_faithful":
            return (K * (K - 1) * update_len * FP_ITEMSIZE
                    + (K - 1) * local_state_len * FP_ITEMSIZE)
        return 2 * (K - 1) * padded_len(update_len, K) * FP_ITEMSIZE

    def latency_hops(self, transport: str, K: int) -> int:
        """``K-1`` for the single gather ring of ``compressed``,
        ``2*(K-1)`` for the RS+AG sum rings and for ``spark_faithful``'s
        two gather rings."""
        if K < 2:
            return 0
        if transport == "compressed":
            return K - 1
        return 2 * (K - 1)


BACKENDS: dict[str, CollectiveBackend] = {
    "xla": XLABackend(),
    "ring": RingBackend(),
}


def get_backend(backend=None) -> CollectiveBackend:
    """Resolve a backend name (or pass a backend object through);
    ``None`` means the default fused ``xla`` fabric."""
    if backend is None:
        return BACKENDS["xla"]
    if isinstance(backend, str):
        try:
            return BACKENDS[backend]
        except KeyError:
            raise ValueError(
                f"unknown collective backend {backend!r}; known: "
                f"{COLLECTIVE_BACKENDS}") from None
    return backend


def wire_bytes(transport: str, codec: UpdateCodec, update_len: int, K: int,
               *, local_state_len: int = 0, K_live: int | None = None) -> int:
    """The fused (``xla``) backend's byte model."""
    return BACKENDS["xla"].wire_bytes(transport, codec, update_len, K,
                                      local_state_len=local_state_len,
                                      K_live=K_live)


# ---------------------------------------------------------------------------
# the exchange fabric: transport composition over a backend
# ---------------------------------------------------------------------------
def exchange_all_reduce(transport: str, codec: UpdateCodec,
                        update: torch.Tensor, fabric: Fabric, backend=None,
                        state=None):
    """Sum this rank's ``(1, L)`` update row across the ranks under the
    transport's exchange pattern, moved by ``backend``'s collectives;
    returns the ``(L,)`` aggregate.

    ``state`` is this worker's ``(1, ...)`` codec-state carry (the
    error-feedback residual): when given, the encode runs through
    ``codec.encode_with_state`` and the call returns ``(total,
    new_state)``. Only the encode changes; the collectives are those of
    the stateless path."""
    be = get_backend(backend)
    if transport != "compressed" and spans.active():
        spans.count("payload_bytes", update.nbytes)
    if transport == "compressed":
        if state is None:
            parts = codec.encode(update)     # e.g. ((1, L) int8, (1,) scale)
        else:
            parts, state = codec.encode_with_state(update, state)
        if spans.active():
            spans.count("payload_bytes", sum(p.nbytes for p in parts))
        gathered = tuple(be.all_gather(p, fabric) for p in parts)
        # the virtual driver's decode + sum of the (K, ...) stack, in
        # worker order: kernel K3 for the quantized codecs on the card
        total = codec.decode_stacked_sum(gathered, update.shape[1])
    elif transport == "spark_faithful":
        # collected at the master and re-broadcast, not reduced in
        # place: the virtual driver's sum, with the traffic real
        total = torch.sum(be.all_gather(update, fabric), dim=0)
    elif transport == "reduce_scatter":
        total = be.reduce_scatter_gather(update[0], fabric)
    else:
        total = be.all_reduce(update[0], fabric)
    return total if state is None else (total, state)


def exchange_roundtrip_state(state: torch.Tensor, fabric: Fabric,
                             backend=None) -> torch.Tensor:
    """``spark_faithful``'s per-worker persistent-state round trip:
    all-gather through the master, each worker re-slices its own
    ``(1, ...)`` block — the identity, with real collective traffic."""
    gathered = get_backend(backend).all_gather(state, fabric)
    n = state.shape[0]
    return gathered[fabric.rank * n:(fabric.rank + 1) * n]
