"""The distributed-driver layer on one card: the port of
``repro.core.distributed`` for this slice.

  * :class:`CommScheme` — a *transport* composed with an update codec
    (``repro_torch.comm``). All four of the reference's transports
    parse and price their bytes (``bytes_per_round``). On the virtual
    driver every exact transport (``persistent``, ``spark_faithful``,
    ``reduce_scatter``) is one f32 sum over the stacked updates;
    ``compressed:<codec>`` encodes the (K, L) stack and reduces the
    payload with the codec's fused decode+sum (kernels K2 and K3 on the
    card for ``int8``, ``int4`` and ``int2``); under a stateful codec
    (``ef:<base>``) the encode also advances the per-worker residual.
  * :class:`ExchangeMode` — ``sync`` only. ``stale`` waits for ROADMAP.md
    Queue 1 item 6.
  * :class:`ExchangeConfig` — the scheme and mode in one frozen value,
    parsed from and printed as the reference's ``/``-separated spec.
    Any segment this slice does not run (``stale``, ``drop:``,
    ``straggler:``, ``ring``) raises ``NotImplementedError``.
  * :func:`build_virtual_round` — K virtual workers on one device, with
    the reference's ``vmap`` over workers written out as a leading K
    axis: one batched ``local_step`` for all workers, one exchange, one
    apply. Under a stateful codec its ``local`` slot is the
    ``(local, codec_state)`` pair of :func:`wrap_local_state`.

Randomness does not enter here: the caller hands each round its (K, H)
coordinate indices, so a run can replay the reference's index stream
(``repro_torch.carry``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Protocol

import torch

from repro_torch.comm import UpdateCodec, get_codec, wire_bytes

COMM_TRANSPORTS = ("persistent", "spark_faithful", "compressed",
                   "reduce_scatter")
EXCHANGE_MODES = ("sync",)

# reference segments this slice does not run, and where they are queued
_UNPORTED_SEGMENTS = {
    "stale": "ROADMAP.md Queue 1 item 6",
    "straggler": "ROADMAP.md Queue 1 item 6",
    "drop": "ROADMAP.md Queue 1 item 6",
    "ring": "ROADMAP.md Queue 1 item 8",
}

EXCHANGE_GRAMMAR = "<transport>[:<codec>] | sync"


# ---------------------------------------------------------------------------
# communication schemes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CommScheme:
    """One of the paper's communication schemes (§5.3) as transport x
    codec — ``name`` is ``"<transport>"`` or ``"compressed:<codec>"``
    (bare ``"compressed"`` aliases ``compressed:int8``). Carries both
    the exchange over stacked updates and the byte accounting, so
    modelled traffic cannot drift from what is moved."""
    name: str

    @classmethod
    def parse(cls, spec: "CommScheme | str") -> "CommScheme":
        return spec if isinstance(spec, CommScheme) else cls(str(spec))

    def __post_init__(self):
        transport, _, codec = self.name.partition(":")
        if transport not in COMM_TRANSPORTS:
            raise ValueError(f"unknown comm scheme {self.name!r}; "
                             f"known transports: {COMM_TRANSPORTS} "
                             f"(codecs compose as 'compressed:<codec>')")
        if codec:
            if transport != "compressed":
                raise ValueError(
                    f"comm scheme {self.name!r}: only the 'compressed' "
                    f"transport takes a codec suffix ('{transport}' "
                    f"moves exact f32 by construction)")
            get_codec(codec)  # raises on unknown or unported codecs

    @property
    def transport(self) -> str:
        return self.name.partition(":")[0]

    @property
    def codec(self) -> UpdateCodec:
        """The named codec for ``compressed`` (int8 when bare), the f32
        identity for every exact-f32 transport."""
        transport, _, codec = self.name.partition(":")
        if transport == "compressed":
            return get_codec(codec or "int8")
        return get_codec("f32")

    def all_reduce_stacked(self, updates: torch.Tensor, state=None):
        """Sum the (K, L) stacked updates: encode the stack and reduce
        the payload through the codec under ``compressed``, one f32 sum
        for the exact transports. ``state`` is the stacked ``(K, ...)``
        codec-state carry; when given, the encode goes through the
        codec's ``encode_with_state`` and the call returns ``(total,
        new_state)``."""
        if self.transport == "compressed":
            if state is None:
                parts = self.codec.encode(updates)
            else:
                parts, state = self.codec.encode_with_state(updates, state)
            total = self.codec.decode_stacked_sum(parts, updates.shape[1])
        else:
            total = torch.sum(updates, dim=0)
        return total if state is None else (total, state)

    def bytes_per_round(self, update_len: int, K: int,
                        local_state_len: int = 0) -> int:
        """Bytes on the wire per round (paper Fig 1 + §5.3), sized to
        the dtypes the collectives move."""
        return wire_bytes(self.transport, self.codec, update_len, K,
                          local_state_len=local_state_len)


# ---------------------------------------------------------------------------
# exchange modes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExchangeMode:
    """``sync``: the round-``t`` aggregate is applied before round
    ``t+1`` computes. The reference's bounded-staleness ``stale`` mode is
    not ported yet."""
    name: str = "sync"

    @classmethod
    def parse(cls, spec: "ExchangeMode | str") -> "ExchangeMode":
        if isinstance(spec, ExchangeMode):
            return spec
        return cls(str(spec))

    def __post_init__(self):
        if self.name.partition(":")[0] == "stale":
            raise NotImplementedError(
                f"exchange mode {self.name!r} is not ported yet "
                f"({_UNPORTED_SEGMENTS['stale']})")
        if self.name not in EXCHANGE_MODES:
            raise ValueError(f"unknown exchange mode {self.name!r}; "
                             f"known: {EXCHANGE_MODES}")

    @property
    def spec(self) -> str:
        return self.name


# ---------------------------------------------------------------------------
# the exchange configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExchangeConfig:
    """How one run exchanges updates: the comm scheme and the mode.
    Round-trips to/from the reference's spec string for the segments
    this slice runs (``"compressed:int8"``, ``"persistent/sync"``)."""
    scheme: CommScheme = field(default_factory=lambda: CommScheme("persistent"))
    mode: ExchangeMode = field(default_factory=ExchangeMode)

    def __post_init__(self):
        if isinstance(self.scheme, str):
            object.__setattr__(self, "scheme", CommScheme.parse(self.scheme))
        if isinstance(self.mode, str):
            object.__setattr__(self, "mode", ExchangeMode.parse(self.mode))

    @classmethod
    def parse(cls, spec: "ExchangeConfig | CommScheme | ExchangeMode | str | None"
              ) -> "ExchangeConfig":
        """Parse a spec string (or pass through / wrap a typed value);
        ``None`` is the default ``persistent/sync`` exchange. Segments
        may come in any order; duplicates are rejected."""
        if spec is None:
            return cls()
        if isinstance(spec, ExchangeConfig):
            return spec
        if isinstance(spec, CommScheme):
            return cls(scheme=spec)
        if isinstance(spec, ExchangeMode):
            return cls(mode=spec)
        scheme = mode = None
        for seg in str(spec).split("/"):
            head = seg.partition(":")[0]
            if head in _UNPORTED_SEGMENTS:
                raise NotImplementedError(
                    f"exchange spec {spec!r}: segment {seg!r} is not "
                    f"ported yet ({_UNPORTED_SEGMENTS[head]})")
            if head in COMM_TRANSPORTS:
                if scheme is not None:
                    raise ValueError(f"exchange spec {spec!r}: duplicate "
                                     f"comm-scheme segment {seg!r}")
                scheme = CommScheme.parse(seg)
            elif head in EXCHANGE_MODES:
                if mode is not None:
                    raise ValueError(f"exchange spec {spec!r}: duplicate "
                                     f"exchange-mode segment {seg!r}")
                mode = ExchangeMode.parse(seg)
            else:
                raise ValueError(
                    f"unknown exchange spec segment {seg!r} in {spec!r}; "
                    f"the grammar is {EXCHANGE_GRAMMAR}")
        return cls(scheme=scheme or CommScheme("persistent"),
                   mode=mode or ExchangeMode("sync"))

    @property
    def spec(self) -> str:
        """Canonical spec string (default segments elided)."""
        return self.scheme.name

    def __str__(self) -> str:
        return self.spec


# ---------------------------------------------------------------------------
# the codec-state slot
# ---------------------------------------------------------------------------
def wrap_local_state(exchange, local: torch.Tensor, update_len: int,
                     K: int):
    """The driver's ``local`` slot for ``exchange``: the per-worker local
    state as it is under a stateless codec; under a stateful one
    (``ef:``) the pair ``(local, codec_state)`` with the ``(K,
    update_len)`` residual every round's encode reads and rewrites."""
    codec = ExchangeConfig.parse(exchange).scheme.codec
    if not codec.stateful:
        return local
    return local, torch.stack([codec.init_state(update_len,
                                                device=local.device)] * K)


def unwrap_local_state(exchange, local):
    """The bare per-worker local state, without the codec-state slot a
    stateful codec's run carries (the identity for stateless codecs)."""
    codec = ExchangeConfig.parse(exchange).scheme.codec
    return local[0] if codec.stateful else local


# ---------------------------------------------------------------------------
# the algorithm protocol and the virtual driver
# ---------------------------------------------------------------------------
class RoundAlgorithm(Protocol):
    """What one algorithm plugs into the virtual round driver.

    ``data``   tuple of ``(K, ...)`` stacked tensors, partitioned on the
               leading worker axis.
    ``local``  ``(K, L_local)`` per-worker persistent state.
    ``shared`` replicated state (the residual ``w``).
    ``idx``    ``(K, H)`` this round's coordinate indices per worker.
    """

    def local_step(self, data, local, shared, idx, t):
        """All workers' round at once: ``(updates (K, L), local_new)``."""
        ...

    def apply_update(self, shared, total_update, t):
        """New shared state from the reduced update (round ``t``)."""
        ...

    def local_metric(self, data, local, shared_new):
        """Per-worker metric contributions, shape ``(K,)``."""
        ...

    def finalize_metric(self, shared_new, metric_sum):
        """Round metric from the summed per-worker contributions."""
        ...


def build_virtual_round(algo: RoundAlgorithm, exchange, data, *,
                        K: int) -> Callable:
    """K virtual workers on one device, batched along the leading axis.

    Returns ``round_fn(local, shared, idx, t) -> (local_new, shared_new,
    metric)``: every worker's local step in one batched call, the
    exchange of the (K, L) updates, the apply, and the metric of the new
    iterate (a 0-dim tensor, left on the device). Under a stateful codec
    (``ef:``) ``local`` is the ``(local, codec_state)`` pair from
    :func:`wrap_local_state`, and the residual advances at every
    round's encode."""
    ex = ExchangeConfig.parse(exchange)
    comm = ex.scheme
    stateful = comm.codec.stateful

    def round_fn(local, shared, idx, t=1):
        if idx.shape[0] != K:
            raise ValueError(f"round_fn: idx must have K={K} rows, got "
                             f"{tuple(idx.shape)}")
        if stateful:
            local, cstate = local
        upd, local_new = algo.local_step(data, local, shared, idx, t)
        if stateful:
            total, cstate = comm.all_reduce_stacked(upd, cstate)
        else:
            total = comm.all_reduce_stacked(upd)
        shared_new = algo.apply_update(shared, total, t)
        metric_sum = torch.sum(algo.local_metric(data, local_new, shared_new))
        local_out = (local_new, cstate) if stateful else local_new
        return local_out, shared_new, algo.finalize_metric(shared_new,
                                                           metric_sum)

    return round_fn
