"""The distributed-driver layer: the port of ``repro.core.distributed``.

  * :class:`CommScheme` — a *transport* composed with an update codec
    (``repro_torch.comm``). All four of the reference's transports
    parse and price their bytes (``bytes_per_round``, per backend). On
    the virtual driver every exact transport (``persistent``,
    ``spark_faithful``, ``reduce_scatter``) is one f32 sum over the
    stacked updates; ``compressed:<codec>`` encodes the (K, L) stack and
    reduces the payload through the codec (kernels K2 and K3 on the card
    for ``int8``, ``int4`` and ``int2``, K4 for the ``topk`` encode);
    under a stateful codec (``ef:<base>``) the encode also advances the
    per-worker residual. On the sharded driver ``all_reduce`` moves one
    rank's update through the collective fabric
    (``repro_torch.comm.collectives``).
  * :class:`ExchangeMode` — ``sync``, or ``stale`` / ``stale:k=<int>``:
    the aggregate computed in round ``t`` is applied in round ``t+k``
    while the workers compute against state absorbed through round
    ``t-1-k``; the last ``k`` aggregates travel as a stacked pending
    queue in the driver's ``shared`` slot (:func:`init_exchange_state`),
    and ``round_fn.flush`` / :func:`finish_run` absorb it after the last
    round.
  * :class:`StragglerProfile` — the straggler segment of the grammar
    (per-worker compute-time multipliers) and its timing model. Time-only:
    under a bulk-synchronous barrier a straggler changes the wall clock,
    never the numbers, so the driver ignores it and the trade-off layer
    charges it.
  * :class:`MembershipSchedule` — elastic membership (``drop:1@5-9``): a
    dropped worker contributes an exact-zero update (zeroed before the
    encode, its ``ef:`` residual too), keeps its local state and
    residual frozen, and the byte model prices the live workers only.
  * :class:`ExchangeConfig` — all of the above and the collective
    backend (``xla`` or ``ring``) in one frozen value, parsed from and
    printed as the reference's ``/``-separated spec
    (``"compressed:ef:topk(r=0.125)/ring/stale:k=2/drop:1@5-9"``),
    segments in any order.
  * :func:`build_virtual_round` — K virtual workers on one device, with
    the reference's ``vmap`` over workers written out as a leading K
    axis: one batched ``local_step`` for all workers, one exchange, one
    apply. Under a stateful codec its ``local`` slot is the ``(local,
    codec_state)`` pair of :func:`wrap_local_state`.
  * :func:`build_sharded_round` — one worker per process of a
    ``torch.distributed`` group: the virtual round on this rank's
    ``(1, ...)`` slice with the collective in place of the stacked sum;
    :func:`place_state` hands a rank its slice of the state.

Randomness does not enter here: the caller hands each round its (K, H)
coordinate indices, so a run can replay the reference's index stream
(``repro_torch.carry``); a sharded rank takes row ``rank`` of them.
Round indices are Python ints, so the masks the reference evaluates
in-graph are plain branches here.
"""
from __future__ import annotations

import functools
import re
from dataclasses import dataclass, field
from typing import Callable, Protocol

import numpy as np
import torch

from repro_torch.comm import UpdateCodec, get_codec
from repro_torch.comm.collectives import (COLLECTIVE_BACKENDS, Fabric,
                                          exchange_all_reduce,
                                          exchange_roundtrip_state,
                                          get_backend)
from repro_torch.utils import spans

COMM_TRANSPORTS = ("persistent", "spark_faithful", "compressed",
                   "reduce_scatter")
EXCHANGE_MODES = ("sync", "stale")
STRAGGLER_KINDS = ("none", "det", "lognormal", "mix")
EXCHANGE_GRAMMAR = ("<transport>[:<codec>] | "
                    + " | ".join(COLLECTIVE_BACKENDS)
                    + " | sync | stale[:k=<int>] | "
                    "straggler:<kind>[(p=..,slow=..,sigma=..)] | "
                    "drop:<worker>@<round>[-<round>]")


# ---------------------------------------------------------------------------
# the reference's pre-codec quantizer API, over the int8 codec
# ---------------------------------------------------------------------------
def quantize_update(dv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Absmax int8 quantization of one worker's update vector
    (``Int8Codec.encode``: kernel K2 on the card, its plain version on
    the CPU). Returns ``(q, scale)``, ``q`` int8 in [-127, 127] and
    ``scale`` a scalar f32, such that ``dequantize_update(q, scale)``
    is about ``dv``."""
    return get_codec("int8").encode(dv)


def dequantize_update(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


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
            get_codec(codec)  # raises on unknown codec names

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

    @property
    def persistent_local_state(self) -> bool:
        """May per-worker state (e.g. alpha_[k]) stay on its worker?"""
        return self.transport != "spark_faithful"

    def all_reduce(self, update: torch.Tensor, fabric: Fabric,
                   backend=None, state=None):
        """Sum this rank's ``(1, L)`` update across the ranks of
        ``fabric``, moved by ``backend``'s collectives (a name, a backend
        object, or ``None`` for the fused ``xla`` fabric). ``state`` is
        this worker's ``(1, ...)`` codec-state carry: when given, the
        return value is ``(total, new_state)``."""
        return exchange_all_reduce(self.transport, self.codec, update,
                                   fabric, backend, state=state)

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
            if spans.active():
                spans.count("payload_bytes", sum(p.nbytes for p in parts))
            total = self.codec.decode_stacked_sum(parts, updates.shape[1])
        else:
            if spans.active():
                spans.count("payload_bytes", updates.nbytes)
            total = torch.sum(updates, dim=0)
        return total if state is None else (total, state)

    def roundtrip_local_state(self, state: torch.Tensor, fabric: Fabric,
                              backend=None) -> torch.Tensor:
        """``spark_faithful`` ships per-worker persistent state through
        the master every round: all-gather, then each worker re-slices
        its own block — the identity, with real collective traffic."""
        if self.persistent_local_state or state.numel() == 0:
            return state
        return exchange_roundtrip_state(state, fabric, backend)

    def bytes_per_round(self, update_len: int, K: int,
                        local_state_len: int = 0,
                        K_live: int | None = None, backend=None) -> int:
        """Bytes on the wire per round (paper Fig 1 + §5.3), sized to
        the dtypes the collectives move; the backend owns the formula.
        ``K_live`` is the live-worker count of an elastic round
        (``None``: all K)."""
        return get_backend(backend).wire_bytes(
            self.transport, self.codec, update_len, K,
            local_state_len=local_state_len, K_live=K_live)


# ---------------------------------------------------------------------------
# exchange modes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExchangeMode:
    """``sync`` (the round-``t`` aggregate is applied before round
    ``t+1`` computes) or ``stale`` (``k``-round-bounded delay: the
    aggregate computed in round ``t`` is applied during round ``t+k``).
    Spelled ``"sync"``, ``"stale"`` (k=1) or ``"stale:k=<int>"``."""
    name: str
    k: int = 1

    @classmethod
    def parse(cls, spec: "ExchangeMode | str") -> "ExchangeMode":
        if isinstance(spec, ExchangeMode):
            return spec
        name, _, opts = str(spec).partition(":")
        if name not in EXCHANGE_MODES:
            raise ValueError(f"unknown exchange mode {spec!r}; "
                             f"known: {EXCHANGE_MODES} (bounded "
                             f"staleness spells 'stale:k=<int>')")
        if not opts:
            return cls(name)
        m = re.fullmatch(r"k=([0-9]+)", opts)
        if name != "stale" or not m:
            raise ValueError(f"unknown exchange mode {spec!r}; the only "
                             f"parameterized spelling is 'stale:k=<int>' "
                             f"(e.g. 'stale:k=2')")
        return cls(name, int(m.group(1)))

    def __post_init__(self):
        if self.name not in EXCHANGE_MODES:
            raise ValueError(f"unknown exchange mode {self.name!r}; "
                             f"known: {EXCHANGE_MODES}")
        if self.k < 1:
            raise ValueError(f"exchange mode {self.name!r}: the staleness "
                             f"bound k must be >= 1, got {self.k}")
        if self.name == "sync" and self.k != 1:
            raise ValueError(f"exchange mode 'sync' takes no staleness "
                             f"bound (got k={self.k}); spell a bounded "
                             f"delay as 'stale:k={self.k}'")

    @property
    def stale(self) -> bool:
        return self.name == "stale"

    @property
    def spec(self) -> str:
        return self.name if self.k == 1 else f"{self.name}:k={self.k}"


# ---------------------------------------------------------------------------
# straggler profiles
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lognormal_barrier_mult(sigma: float, K: int,
                            samples: int = 8192) -> float:
    """E[max over K workers] of a mean-1 lognormal multiplier, by
    fixed-seed Monte Carlo (no closed form). Deterministic, cached; the
    reference's numpy draw, so the same bits."""
    z = np.random.default_rng(20260808).standard_normal((samples, K))
    mult = np.exp(sigma * z - 0.5 * sigma * sigma)
    return float(np.mean(np.max(mult, axis=1)))


@dataclass(frozen=True)
class StragglerProfile:
    """Per-worker compute-time multiplier distribution (the paper's
    straggling executors, §4). Time-only: under a bulk-synchronous
    barrier every round waits for its slowest worker, so the drivers
    ignore the profile and the trade-off layer's ``TimeModel``
    (``repro_torch.core.tradeoff``) charges compute as the max over
    workers (:meth:`expected_barrier_mult`).

      * ``none``               every worker runs at 1x.
      * ``det(slow=S)``        worker 0 is S× slower; barrier factor S.
      * ``lognormal(sigma=σ)`` mean-1 lognormal jitter on every worker
        (``exp(σz - σ²/2)``); barrier factor E[max of K] by fixed-seed
        Monte Carlo.
      * ``mix(p=P,slow=S)``    each worker S× slow with probability P;
        barrier factor ``1 + (S-1)·(1-(1-P)^K)``.

    :meth:`multipliers` and :meth:`barrier_mults` sample from a
    ``torch.Generator`` where the reference splits a ``jax.random`` key,
    whose bits PyTorch cannot reproduce: ``none`` and ``det`` are exact,
    ``mix`` and ``lognormal`` match the reference in distribution."""
    kind: str = "none"
    slow: float = 4.0
    p: float = 0.1
    sigma: float = 0.5

    _PARAMS = {"none": (), "det": ("slow",), "lognormal": ("sigma",),
               "mix": ("p", "slow")}

    @classmethod
    def parse(cls, spec: "StragglerProfile | str") -> "StragglerProfile":
        if isinstance(spec, StragglerProfile):
            return spec
        body = str(spec)
        body = body[len("straggler:"):] if body.startswith("straggler:") \
            else body
        m = re.fullmatch(r"([a-z_]+)(?:\(([^()]*)\))?", body)
        if not m or m.group(1) not in STRAGGLER_KINDS:
            raise ValueError(f"unknown straggler profile {spec!r}; known "
                             f"kinds: {STRAGGLER_KINDS}, parameterized as "
                             f"'straggler:mix(p=0.1,slow=8)'")
        kind, params = m.group(1), m.group(2)
        allowed = cls._PARAMS[kind]
        kwargs = {}
        for item in (params.split(",") if params else ()):
            key, sep, val = item.partition("=")
            key = key.strip()
            if not sep or key not in allowed:
                raise ValueError(
                    f"straggler profile {spec!r}: '{kind}' takes "
                    f"{allowed or 'no'} parameters, got {item!r}")
            try:
                kwargs[key] = float(val)
            except ValueError:
                raise ValueError(f"straggler profile {spec!r}: parameter "
                                 f"{key}={val!r} is not a number") from None
        return cls(kind, **kwargs)

    def __post_init__(self):
        if self.kind not in STRAGGLER_KINDS:
            raise ValueError(f"unknown straggler profile kind "
                             f"{self.kind!r}; known: {STRAGGLER_KINDS}")
        if self.slow < 1.0:
            raise ValueError(f"straggler slow multiplier must be >= 1, "
                             f"got {self.slow}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"straggler probability p must be in [0, 1], "
                             f"got {self.p}")
        if self.sigma < 0.0:
            raise ValueError(f"straggler lognormal sigma must be >= 0, "
                             f"got {self.sigma}")

    @property
    def active(self) -> bool:
        return self.kind != "none"

    @property
    def spec(self) -> str:
        fmt = {"slow": self.slow, "p": self.p, "sigma": self.sigma}
        args = ",".join(f"{k}={fmt[k]:g}" for k in self._PARAMS[self.kind])
        return f"straggler:{self.kind}" + (f"({args})" if args else "")

    def multipliers(self, generator: torch.Generator, K: int) -> torch.Tensor:
        """One round's per-worker compute-time multipliers, ``(K,)`` f32
        on the generator's device, drawn from ``generator``."""
        dev = generator.device
        if self.kind == "none":
            return torch.ones((K,), dtype=torch.float32, device=dev)
        if self.kind == "det":
            return torch.where(torch.arange(K, device=dev) == 0,
                               self.slow, 1.0).to(torch.float32)
        if self.kind == "lognormal":
            z = torch.randn((K,), generator=generator, device=dev)
            return torch.exp(self.sigma * z - 0.5 * self.sigma ** 2)
        hit = torch.rand((K,), generator=generator, device=dev) < self.p
        return torch.where(hit, self.slow, 1.0).to(torch.float32)

    def barrier_mults(self, generator: torch.Generator, K: int,
                      rounds: int) -> torch.Tensor:
        """``(rounds,)`` sampled per-round barrier factors: the max over
        workers of :meth:`multipliers`, one round after another."""
        return torch.stack([torch.max(self.multipliers(generator, K))
                            for _ in range(rounds)])

    def expected_barrier_mult(self, K: int) -> float:
        """E[max over K workers] of the multiplier: the factor a
        bulk-synchronous barrier stretches compute by (what
        ``TimeModel`` charges)."""
        if K < 1:
            raise ValueError(f"straggler barrier factor needs the worker "
                             f"count K >= 1, got {K}")
        if self.kind == "none":
            return 1.0
        if self.kind == "det":
            return float(self.slow)
        if self.kind == "mix":
            return 1.0 + (self.slow - 1.0) * (1.0 - (1.0 - self.p) ** K)
        return _lognormal_barrier_mult(self.sigma, K)


# ---------------------------------------------------------------------------
# elastic membership schedules
# ---------------------------------------------------------------------------
_DROP_RE = re.compile(r"drop:([0-9]+)@([0-9]+)(?:-([0-9]+))?")


@dataclass(frozen=True)
class MembershipSchedule:
    """Elastic worker membership: each event removes one worker for an
    inclusive window of 1-based rounds (``(worker, first, last)``;
    ``last=None`` means it never rejoins). Spelled ``"drop:1@5"`` /
    ``"drop:1@5-9"``; several ``drop`` segments compose."""
    events: tuple = ()

    @staticmethod
    def parse_event(seg: str) -> tuple:
        m = _DROP_RE.fullmatch(seg)
        if not m:
            raise ValueError(f"malformed membership segment {seg!r}; the "
                             f"grammar is 'drop:<worker>@<round>' or "
                             f"'drop:<worker>@<first>-<last>'")
        w, d, r = int(m.group(1)), int(m.group(2)), m.group(3)
        return (w, d, None if r is None else int(r))

    @classmethod
    def parse(cls, spec: "MembershipSchedule | str") -> "MembershipSchedule":
        if isinstance(spec, MembershipSchedule):
            return spec
        segs = [s for s in str(spec).split("/") if s]
        return cls(tuple(cls.parse_event(s) for s in segs))

    def __post_init__(self):
        norm = []
        for ev in self.events:
            w, d, r = ev
            if w < 0 or d < 1 or (r is not None and r < d):
                raise ValueError(
                    f"membership event {ev!r}: need worker >= 0, first "
                    f"round >= 1 (rounds are 1-based) and last >= first")
            norm.append((int(w), int(d), None if r is None else int(r)))
        object.__setattr__(self, "events", tuple(norm))

    @property
    def empty(self) -> bool:
        return not self.events

    @property
    def spec(self) -> str:
        return "/".join(f"drop:{w}@{d}" if r is None else f"drop:{w}@{d}-{r}"
                        for (w, d, r) in self.events)

    def check_workers(self, K: int) -> None:
        for (w, _, _) in self.events:
            if w >= K:
                raise ValueError(f"membership schedule {self.spec!r} drops "
                                 f"worker {w} but the run has only K={K} "
                                 f"workers")

    def _absent(self, w: int, t: int) -> bool:
        return any(w == ew and t >= d and (r is None or t <= r)
                   for (ew, d, r) in self.events)

    def live_mask(self, t: int, K: int, device=None) -> torch.Tensor:
        """``(K,)`` f32 {0, 1} mask of the live workers at 1-based round
        ``t``, on ``device``. Filled in place on the device: a tensor
        copied from a host list would block the host until the card's
        queued work (the round's K1) has finished."""
        self.check_workers(K)
        mask = torch.ones((K,), dtype=torch.float32, device=device)
        for w in range(K):
            if self._absent(w, t):
                mask[w] = 0.0
        return mask

    def live_count(self, t: int, K: int) -> int:
        """The live-worker count at round ``t`` (the byte model's
        ``K_live``)."""
        self.check_workers(K)
        return sum(0 if self._absent(w, t) else 1 for w in range(K))


# ---------------------------------------------------------------------------
# the exchange configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExchangeConfig:
    """How one run exchanges updates, in one frozen value: the comm
    scheme, the collective backend (``xla`` or ``ring``: which fabric
    moves the bytes on the sharded driver), the exchange mode, the
    straggler profile and the membership schedule.

    Round-trips to/from the reference's ``"/"``-separated spec, whose
    segments may come in any order (``"compressed:int4/stale:k=2"``,
    ``"compressed:int4/ring"``,
    ``"persistent/straggler:mix(p=0.1,slow=8)"``,
    ``"spark_faithful/drop:1@5-9/drop:3@7"``); omitted segments take
    their defaults and ``str(cfg)`` prints the canonical spec with the
    defaults elided."""
    scheme: CommScheme = field(default_factory=lambda: CommScheme("persistent"))
    mode: ExchangeMode = field(default_factory=lambda: ExchangeMode("sync"))
    straggler: StragglerProfile = field(default_factory=StragglerProfile)
    membership: MembershipSchedule = field(default_factory=MembershipSchedule)
    backend: str = "xla"

    def __post_init__(self):
        if isinstance(self.scheme, str):
            object.__setattr__(self, "scheme", CommScheme.parse(self.scheme))
        if isinstance(self.mode, str):
            object.__setattr__(self, "mode", ExchangeMode.parse(self.mode))
        if isinstance(self.straggler, str):
            object.__setattr__(self, "straggler",
                               StragglerProfile.parse(self.straggler))
        if isinstance(self.membership, (str, tuple)):
            object.__setattr__(
                self, "membership",
                MembershipSchedule.parse(self.membership)
                if isinstance(self.membership, str)
                else MembershipSchedule(self.membership))
        # stored by name; get_backend raises on an unknown one
        object.__setattr__(self, "backend", get_backend(self.backend).name)

    @classmethod
    def parse(cls, spec: "ExchangeConfig | CommScheme | ExchangeMode | str | None"
              ) -> "ExchangeConfig":
        """Parse a spec string (or pass through / wrap a typed value);
        ``None`` is the default ``persistent/sync`` exchange. Segments
        are classified by their head token, so order never matters;
        duplicate scheme, backend, mode and straggler segments are
        rejected."""
        if spec is None:
            return cls()
        if isinstance(spec, ExchangeConfig):
            return spec
        if isinstance(spec, CommScheme):
            return cls(scheme=spec)
        if isinstance(spec, ExchangeMode):
            return cls(mode=spec)
        scheme = mode = straggler = backend = None
        events: list = []
        for seg in str(spec).split("/"):
            head = seg.partition(":")[0]
            if head in COLLECTIVE_BACKENDS:
                if seg != head:
                    raise ValueError(
                        f"exchange spec {spec!r}: collective-backend "
                        f"segment {seg!r} takes no parameters")
                if backend is not None:
                    raise ValueError(f"exchange spec {spec!r}: duplicate "
                                     f"collective-backend segment {seg!r}")
                backend = head
            elif head in COMM_TRANSPORTS:
                if scheme is not None:
                    raise ValueError(f"exchange spec {spec!r}: duplicate "
                                     f"comm-scheme segment {seg!r}")
                scheme = CommScheme.parse(seg)
            elif head in EXCHANGE_MODES:
                if mode is not None:
                    raise ValueError(f"exchange spec {spec!r}: duplicate "
                                     f"exchange-mode segment {seg!r}")
                mode = ExchangeMode.parse(seg)
            elif head == "straggler":
                if straggler is not None:
                    raise ValueError(f"exchange spec {spec!r}: duplicate "
                                     f"straggler segment {seg!r}")
                straggler = StragglerProfile.parse(seg)
            elif head == "drop":
                events.append(MembershipSchedule.parse_event(seg))
            else:
                raise ValueError(
                    f"unknown exchange spec segment {seg!r} in {spec!r}; "
                    f"the grammar is {EXCHANGE_GRAMMAR}")
        return cls(scheme=scheme or CommScheme("persistent"),
                   mode=mode or ExchangeMode("sync"),
                   straggler=straggler or StragglerProfile(),
                   membership=MembershipSchedule(tuple(events)),
                   backend=backend or "xla")

    @property
    def spec(self) -> str:
        """Canonical spec string: the scheme first, then the backend
        when not the default ``xla``, then every other non-default
        segment; ``parse(spec)`` round-trips."""
        segs = [self.scheme.name]
        if self.backend != "xla":
            segs.append(self.backend)
        if self.mode.spec != "sync":
            segs.append(self.mode.spec)
        if self.straggler.active:
            segs.append(self.straggler.spec)
        if not self.membership.empty:
            segs.append(self.membership.spec)
        return "/".join(segs)

    def __str__(self) -> str:
        return self.spec


# ---------------------------------------------------------------------------
# the driver's state slots: the stale queue and the codec state
# ---------------------------------------------------------------------------
def init_exchange_state(mode, shared: torch.Tensor):
    """The driver's ``shared`` slot for ``mode`` (an
    :class:`ExchangeConfig` contributes its mode): ``sync`` passes the
    shared state through; ``stale`` pairs it with the pending-aggregate
    queue, a ``(k, ...)`` stack of zeros."""
    if isinstance(mode, ExchangeConfig):
        mode = mode.mode
    mode = ExchangeMode.parse(mode)
    if not mode.stale:
        return shared
    return shared, torch.zeros((mode.k,) + tuple(shared.shape),
                               dtype=shared.dtype, device=shared.device)


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


def _masked_apply(algo, shared, agg, idx: int):
    """Apply one aggregate under its own round index ``idx``; nothing
    while ``idx < 1`` (the queue slot holds only the zero init, and an
    algorithm's apply need not be the identity on a zero update)."""
    return shared if idx < 1 else algo.apply_update(shared, agg, idx)


def _queue_push(queue: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Shift the pending queue one slot and append this round's
    aggregate: after round ``t`` it holds rounds ``t-k+1 .. t``, oldest
    first."""
    return torch.cat([queue[1:], total[None]], dim=0)


def _delayed_apply(algo, shared, queue, t: int, k: int):
    """Apply the oldest pending aggregate, round ``t-k``'s, under its
    own round index."""
    return _masked_apply(algo, shared, queue[0], t - k)


def _absorb_for_metric(algo, shared, queue, t: int, k: int):
    """Fold the other pending aggregates (rounds ``t-k+1 .. t-1``) into
    a metric-only copy of the shared state, so the metric is the
    objective of the round-``t-1`` iterate (a no-op at ``k=1``)."""
    for i in range(1, k):
        shared = _masked_apply(algo, shared, queue[i], t - k + i)
    return shared


def _make_flush(algo, mode: ExchangeMode) -> Callable:
    """``flush(shared_state, t) -> shared``: absorb every aggregate
    still pending after the last executed round ``t`` (the identity
    under ``sync``), each under its own round index."""
    if not mode.stale:
        return lambda shared, t: shared
    k = mode.k

    def flush(shared_state, t: int):
        shared, queue = shared_state
        for i in range(k):
            shared = _masked_apply(algo, shared, queue[i], t - (k - 1) + i)
        return shared

    return flush


def finish_run(round_fn: Callable, shared, last_t: int):
    """The post-run epilogue of every trainer loop: absorb the pending
    aggregates after the last executed round (``last_t``, 1-based; 0
    means no round ran, so the bare shared state is unwrapped as is)."""
    if last_t > 0:
        return round_fn.flush(shared, last_t)
    return shared[0] if round_fn.mode.stale else shared


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

    An algorithm that averages over workers sets ``live_reweight = True``
    so that an elastic round rescales its aggregate by ``K / K_live``.
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


def _freeze_dropped(new: torch.Tensor, old: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """A worker absent this round keeps its pre-round state verbatim."""
    return torch.where(mask[:, None] > 0, new, old)


def build_virtual_round(algo: RoundAlgorithm, exchange, data, *,
                        K: int) -> Callable:
    """K virtual workers on one device, batched along the leading axis.

    ``exchange`` is an :class:`ExchangeConfig`, a :class:`CommScheme` or
    a spec string. Returns ``round_fn(local, shared, idx, t) ->
    (local_new, shared_new, metric)``: every worker's local step in one
    batched call, the exchange of the (K, L) updates, the apply, and the
    metric (a 0-dim tensor, left on the device).

    Under a stateful codec (``ef:``) ``local`` is the ``(local,
    codec_state)`` pair from :func:`wrap_local_state`; the residual
    advances at every round's encode, whatever the stale queue delays.
    Under ``stale`` ``shared`` is the ``(shared, queue)`` pair from
    :func:`init_exchange_state`: the workers compute against state
    absorbed through round ``t-1-k``, the oldest pending aggregate is
    applied, this round's joins the queue, and the metric is the
    round-``t-1`` iterate's (one round behind). Workers that the
    membership schedule drops contribute exact-zero updates (zeroed
    before the encode, residual included) and keep their local state and
    residual frozen; an algorithm with ``live_reweight`` gets its
    aggregate rescaled by ``K / K_live``. Straggler profiles never enter.
    ``round_fn.mode`` and ``round_fn.flush`` are what :func:`finish_run`
    reads; ``round_fn.device`` is the data's, where the round's spans
    (``local_step``, ``exchange``, ``apply``, ``metric``) take their
    device time."""
    ex = ExchangeConfig.parse(exchange)
    ex.membership.check_workers(K)
    comm, xmode, membership = ex.scheme, ex.mode, ex.membership
    k = xmode.k
    stateful = comm.codec.stateful
    reweight = not membership.empty and getattr(algo, "live_reweight", False)

    dev = data[0].device

    def round_fn(local, shared, idx, t=1):
        if idx.shape[0] != K:
            raise ValueError(f"round_fn: idx must have K={K} rows, got "
                             f"{tuple(idx.shape)}")
        if stateful:
            local, cstate = local
        if xmode.stale:
            shared, queue = shared
        with spans.span("local_step", dev):
            upd, local_new = algo.local_step(data, local, shared, idx, t)
        with spans.span("exchange", dev):
            cstate_in = cstate if stateful else None
            if not membership.empty:
                mask = membership.live_mask(t, K, device=upd.device)
                upd = upd * mask[:, None]
                local_new = _freeze_dropped(local_new, local, mask)
                if stateful:
                    # a dropped worker's encode is of an exact zero: its
                    # residual is zeroed with the update and frozen below
                    cstate_in = cstate_in * mask[:, None]
            if stateful:
                total, cstate_new = comm.all_reduce_stacked(upd, cstate_in)
                if not membership.empty:
                    cstate_new = _freeze_dropped(cstate_new, cstate, mask)
            else:
                total = comm.all_reduce_stacked(upd)
            if reweight:
                live = torch.clamp(torch.sum(mask), min=1.0)
                total = total * (torch.full_like(live, float(K)) / live)
        with spans.span("apply", dev):
            if xmode.stale:
                shared_new = _delayed_apply(algo, shared, queue, t, k)
                shared_out = (shared_new, _queue_push(queue, total))
            else:
                shared_new = algo.apply_update(shared, total, t)
                shared_out = shared_new
        with spans.span("metric", dev):
            if xmode.stale:
                # the metric of ONE iterate: the shared state absorbed
                # through round t-1 with the round-(t-1) local state
                metric_shared = _absorb_for_metric(algo, shared_new, queue,
                                                   t, k)
                metric_local = local
            else:
                metric_shared, metric_local = shared_new, local_new
            metric_sum = torch.sum(algo.local_metric(data, metric_local,
                                                     metric_shared))
            metric = algo.finalize_metric(metric_shared, metric_sum)
        local_out = (local_new, cstate_new) if stateful else local_new
        return local_out, shared_out, metric

    round_fn.device = dev
    round_fn.mode = xmode
    round_fn.flush = _make_flush(algo, xmode)
    return round_fn


def build_sharded_round(algo: RoundAlgorithm, exchange, data, *, group=None,
                        K: int) -> Callable:
    """One worker per process of a ``torch.distributed`` group (or of the
    :class:`~repro_torch.comm.collectives.Fabric` the caller opened on
    it, :func:`open_fabric`): this rank runs worker ``rank`` of K.

    ``data`` holds this worker's ``(1, ...)`` slice of every data leaf,
    and ``local`` (from :func:`place_state`) its ``(1, ...)`` slice of
    the local state; ``shared`` is replicated on every rank. Returns
    ``round_fn(local, shared, idx, t) -> (local_new, shared_new,
    metric)`` with the virtual driver's contract: ``idx`` is the round's
    whole ``(K, ...)`` index array, of which the rank takes row
    ``rank``, so the per-worker streams are the virtual driver's. The
    round is the virtual round with the collective in place of the
    stacked sum: the local step, the membership mask's row ``rank``
    (a dropped worker's update and ``ef:`` residual zeroed before the
    encode, its state frozen), ``CommScheme.all_reduce`` over the
    exchange's backend, the ``live_reweight``, ``roundtrip_local_state``,
    the stale apply and queue, and the metric as one scalar all-reduce
    of the rank's ``local_metric``. ``round_fn.fabric`` is the group's
    :class:`~repro_torch.comm.collectives.Fabric`, whose ``round`` every
    recorded call carries; ``round_fn.device`` is the data's, as on the
    virtual driver."""
    ex = ExchangeConfig.parse(exchange)
    ex.membership.check_workers(K)
    fabric = open_fabric(group, K)
    for leaf in data:
        if leaf.shape[0] != 1:
            raise ValueError(f"build_sharded_round: every data leaf is this "
                             f"worker's (1, ...) slice, got "
                             f"{tuple(leaf.shape)}")
    comm, xmode, membership = ex.scheme, ex.mode, ex.membership
    k, rank = xmode.k, fabric.rank
    stateful = comm.codec.stateful
    reweight = not membership.empty and getattr(algo, "live_reweight", False)

    dev = data[0].device

    def round_fn(local, shared, idx, t=1):
        if idx.shape[0] != K:
            raise ValueError(f"round_fn: idx must have K={K} rows, got "
                             f"{tuple(idx.shape)}")
        fabric.round = t
        if stateful:
            local, cstate = local
        if xmode.stale:
            shared, queue = shared
        with spans.span("local_step", dev):
            upd, local_new = algo.local_step(data, local, shared,
                                             idx[rank:rank + 1], t)
        with spans.span("exchange", dev):
            cstate_in = cstate if stateful else None
            if not membership.empty:
                mask = membership.live_mask(t, K, device=upd.device)
                mask_k = mask[rank:rank + 1]
                upd = upd * mask_k[:, None]
                local_new = _freeze_dropped(local_new, local, mask_k)
                if stateful:
                    cstate_in = cstate_in * mask_k[:, None]
            if stateful:
                total, cstate_new = comm.all_reduce(upd, fabric, ex.backend,
                                                    state=cstate_in)
                if not membership.empty:
                    cstate_new = _freeze_dropped(cstate_new, cstate, mask_k)
            else:
                total = comm.all_reduce(upd, fabric, ex.backend)
            if reweight:
                live = torch.clamp(torch.sum(mask), min=1.0)
                total = total * (torch.full_like(live, float(K)) / live)
            # spark_faithful's state round trip (no call of the apply's
            # comes between, so the fabric's calls keep their order)
            local_new = comm.roundtrip_local_state(local_new, fabric,
                                                   ex.backend)
        with spans.span("apply", dev):
            if xmode.stale:
                shared_new = _delayed_apply(algo, shared, queue, t, k)
                shared_out = (shared_new, _queue_push(queue, total))
            else:
                shared_new = algo.apply_update(shared, total, t)
                shared_out = shared_new
        with spans.span("metric", dev):
            metric_shared = (_absorb_for_metric(algo, shared_new, queue, t, k)
                             if xmode.stale else shared_new)
            # stale pairs the lagged shared state with the round-t-1 local
            # state, as the virtual driver does
            metric_local = local if xmode.stale else local_new
            metric_sum = fabric.all_reduce(torch.sum(
                algo.local_metric(data, metric_local, metric_shared))[None])[0]
            metric = algo.finalize_metric(metric_shared, metric_sum)
        fabric.round = None
        local_out = (local_new, cstate_new) if stateful else local_new
        return local_out, shared_out, metric

    round_fn.device = dev
    round_fn.fabric = fabric
    round_fn.exchange = ex
    round_fn.mode = xmode
    round_fn.flush = _make_flush(algo, xmode)
    return round_fn


def open_fabric(group, K: int) -> Fabric:
    """The :class:`~repro_torch.comm.collectives.Fabric` of ``group`` (a
    process group, ``None`` for the default one, or a Fabric already
    opened), which must have one rank per worker."""
    fabric = group if isinstance(group, Fabric) else Fabric(group)
    if fabric.K != K:
        raise ValueError(f"run_sharded: the process group has {fabric.K} "
                         f"ranks and the run K={K} workers; start one rank "
                         f"per worker (repro_torch.launch.dist)")
    return fabric


def place_state(rank: int, local, shared):
    """This rank's share of a ``(local, shared)`` state shaped for the
    virtual driver: row ``rank`` of every ``(K, ...)`` local leaf (the
    ``ef:`` pair's too) as a ``(1, ...)`` tensor of its own, and the
    replicated ``shared`` (the stale pair's too) as it is."""
    def row(x):
        return x[rank:rank + 1].clone()

    local = tuple(map(row, local)) if isinstance(local, tuple) else row(local)
    return local, shared
