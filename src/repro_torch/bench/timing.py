"""The measurement discipline: warmup, repeat, reduce — plus the link
calibration that turns communicated bytes into seconds (the port of
``repro.bench.timing``).

Every sample charges the device's work to the call: PyTorch returns
from a CUDA call before the card has run it, so where this process has
initialised CUDA the timer synchronises the card before the first
sample and after each call (the reference blocks on the jax result for
the same reason). Without that a CUDA call times its launch only.

:func:`calibrate_link` measures the (bandwidth, per-hop latency) of the
collective an exchange actually runs over a ``torch.distributed``
process group (the sharded driver's
:class:`~repro_torch.comm.collectives.Fabric`); the resulting
:class:`LinkCalibration` feeds ``repro_torch.core.tradeoff.TimeModel``,
so the H autotuner charges each scheme its wall-clock traffic (paper
§5.5, Figs 6-7).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class TimingPolicy:
    warmup: int = 1
    reps: int = 3
    reduce: str = "min"   # min | median | mean

    def combine(self, samples: list[float]) -> float:
        if self.reduce == "min":
            return min(samples)
        if self.reduce == "median":
            return float(statistics.median(samples))
        if self.reduce == "mean":
            return float(statistics.fmean(samples))
        raise ValueError(f"unknown reduce {self.reduce!r}")


DEFAULT_POLICY = TimingPolicy()


def _drain() -> None:
    """Wait for the card's queued work, where this process uses a card."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _timed(call, policy: TimingPolicy) -> float:
    """``call(i)`` for i in ``range(warmup + reps)``, the last ``reps``
    timed by the host clock with the card drained inside each sample."""
    warmup = max(policy.warmup, 0)
    for i in range(warmup):
        call(i)
    _drain()
    samples = []
    for i in range(warmup, warmup + max(policy.reps, 1)):
        t0 = time.perf_counter()
        call(i)
        _drain()
        samples.append(time.perf_counter() - t0)
    return policy.combine(samples)


def time_callable(fn, *args, policy: TimingPolicy = DEFAULT_POLICY,
                  **kwargs) -> float:
    """Wall seconds per call of ``fn(*args, **kwargs)`` under ``policy``,
    the card's work included."""
    return _timed(lambda _: fn(*args, **kwargs), policy)


def measure_solver_time(trainer, H: int, reps: int = 3,
                        warmup: int = 1) -> float:
    """Wall seconds of one virtual round of ``trainer.with_H(H)``: the
    paper's measured T_worker per round.

    Works for every trainer of the virtual driver (CoCoA, mini-batch
    SCD, mini-batch SGD). Each rep starts from a fresh ``init_state()``,
    built before the timed region: a round may update its state in
    place. The port's round takes its coordinates (rows, for SGD) from
    the trainer's index source, where the reference's jitted round
    draws them inside; so each sample times round 1's index draw
    together with the round, as the reference's does.
    """
    t = trainer.with_H(int(H))
    source = t.row_source if hasattr(t, "row_source") else t.index_source
    round_fn = t._round_fn
    states = [t.init_state() for _ in range(max(warmup, 0) + max(reps, 1))]
    return _timed(lambda i: round_fn(*states[i], source(1), 1),
                  TimingPolicy(warmup=warmup, reps=reps))


# ---------------------------------------------------------------------------
# link calibration: bytes -> seconds
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LinkCalibration:
    """A fitted ``t(nbytes) = hops * latency_s + nbytes / bandwidth_Bps``
    model of one exchange's collective over one process group.

    ``latency_s`` is the fixed cost of ONE sequential collective call
    (one hop): a fused ``xla`` collective pays it once per exchange, the
    explicit ``ring`` once per hop on the critical path — the backend's
    ``latency_hops`` supplies the multiplier (``TimeModel`` threads it
    through), which is what makes a latency-bound ring favour fewer,
    larger exchanges in ``autotune_H``."""
    bandwidth_Bps: float        # bytes per second on the wire
    latency_s: float = 0.0      # fixed per-hop cost (dispatch, sync)
    source: str = "measured"    # measured | synthetic

    def __post_init__(self):
        if not self.bandwidth_Bps > 0:
            raise ValueError(f"bandwidth must be > 0, got "
                             f"{self.bandwidth_Bps!r}")
        if self.latency_s < 0:
            raise ValueError(f"latency must be >= 0, got {self.latency_s!r}")

    def seconds_for(self, nbytes: float, overlap_s: float = 0.0,
                    latency_hops: int = 1) -> float:
        """Wall seconds the transfer costs the round, paying
        ``latency_hops`` sequential per-hop latencies. ``overlap_s`` is
        compute time the exchange may hide behind (the ``stale``
        exchange mode's delayed apply): the hidden portion is
        ``min(t_wire, overlap_s)``, so a fully hidden transfer costs 0
        and a partly hidden one only the overhang."""
        t = latency_hops * self.latency_s + nbytes / self.bandwidth_Bps
        return t - min(t, max(overlap_s, 0.0))

    def scaled(self, bandwidth_mult: float) -> "LinkCalibration":
        """A synthetic what-if link with scaled bandwidth (e.g. 0.01 for
        a 100x slower interconnect) and unchanged latency."""
        return dataclasses.replace(self, bandwidth_Bps=self.bandwidth_Bps
                                   * bandwidth_mult, source="synthetic")


def synthetic_link(bandwidth_Bps: float,
                   latency_s: float = 0.0) -> LinkCalibration:
    """A deterministic calibration for tests and what-if modelling (the
    fake-bandwidth path: no collectives run, no measurement noise)."""
    return LinkCalibration(bandwidth_Bps, latency_s, source="synthetic")


# ping-pong payload lengths (f32 elements); two decades apart so the
# least-squares fit separates the latency intercept from the 1/bw slope
CALIBRATION_LENGTHS = (1 << 10, 1 << 14, 1 << 17)


def calibrate_link(exchange=None, group=None,
                   lengths: tuple = CALIBRATION_LENGTHS,
                   policy: TimingPolicy = TimingPolicy(warmup=2, reps=5),
                   fake_bandwidth_Bps: float | None = None,
                   fake_latency_s: float = 0.0,
                   device=None) -> LinkCalibration:
    """Measure (bandwidth, per-hop latency) of an exchange's collective
    over a ``torch.distributed`` process group.

    ``exchange`` is an :class:`~repro_torch.core.distributed.ExchangeConfig`
    or spec string (``"compressed:int4/ring"``): the scheme picks the
    collective and the byte accounting, the backend segment the fabric it
    runs on (default ``"persistent"`` on ``xla``). ``group`` is a process
    group (``None``: the default one) or an open
    :class:`~repro_torch.comm.collectives.Fabric`; K is its size, and
    every rank of it must call this function together.

    Ping-pong: for each payload length L this rank's ``(1, L)`` ones go
    through ``CommScheme.all_reduce`` on the group's fabric, on
    ``device`` (the card by default; a gloo group stages it through the
    host, as the sharded driver's rounds do), timed under ``policy``;
    the scheme's ``bytes_per_round(L, K)`` is the x-axis, and a
    least-squares line through (bytes, seconds) gives ``1/bandwidth``
    (slope) and the latency intercept, which is divided by the backend's
    ``latency_hops`` so ``latency_s`` is per hop. Each rank fits its own
    times. A stateful codec (``ef:<base>``) is timed without codec
    state: ``all_reduce`` then encodes the update through the base codec
    and moves what a stateful round moves.

    ``fake_bandwidth_Bps`` bypasses measurement entirely and returns a
    deterministic :func:`synthetic_link`, touching no group.
    """
    from repro_torch.comm.collectives import Fabric, get_backend
    from repro_torch.core.distributed import ExchangeConfig
    from repro_torch.utils.device import resolve_device

    ex = ExchangeConfig.parse(exchange)
    if fake_bandwidth_Bps is not None:
        return synthetic_link(fake_bandwidth_Bps, fake_latency_s)

    dev = resolve_device(device)
    fabric = group if isinstance(group, Fabric) else Fabric(group)
    scheme, backend, K = ex.scheme, ex.backend, fabric.K
    xs, ys = [], []
    for L in lengths:
        payload = torch.ones((1, int(L)), dtype=torch.float32, device=dev)
        xs.append(scheme.bytes_per_round(int(L), K, backend=backend))
        ys.append(time_callable(scheme.all_reduce, payload, fabric, backend,
                                policy=policy))
    hops = max(get_backend(backend).latency_hops(scheme.transport, K), 1)
    if K == 1 or max(xs) == min(xs):
        # one rank moves no bytes whatever the scheme's accounting says,
        # so all that is measurable is the call's latency; a slope fitted
        # to that noise would be a meaningless "measured" bandwidth
        return LinkCalibration(bandwidth_Bps=float("inf"),
                               latency_s=max(min(ys), 0.0) / hops,
                               source="measured")
    slope, intercept = np.polyfit(np.asarray(xs, float),
                                  np.asarray(ys, float), 1)
    # timing jitter on small payloads can give a non-physical fit; clamp
    # to a positive model instead of failing
    if slope <= 0:
        slope = max(ys) / max(xs)
    return LinkCalibration(bandwidth_Bps=1.0 / slope,
                           latency_s=max(float(intercept), 0.0) / hops,
                           source="measured")
