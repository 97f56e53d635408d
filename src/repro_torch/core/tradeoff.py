"""The communication-computation trade-off machinery (paper §5.5, Figs
6-7): the port of ``repro.core.tradeoff``.

``H`` — local steps per round — is *the* tuning knob: more local work
per round means fewer (expensive) communication rounds but diminishing
convergence benefit per round. The optimum depends on the framework's
per-round overhead AND on the per-round communication wall-clock, which
is why the paper finds optimal H differing by >25x between
implementations of the same algorithm on the same hardware.

Sweeps run any of the three trainers (CoCoA, mini-batch SCD, mini-batch
SGD as local SGD) on the virtual driver under ``base_cfg.exchange``,
which threads through every grid point. Per-round traffic under a scheme
(``CommScheme.bytes_per_round``) is converted to seconds by
:class:`TimeModel`: ``comm_bytes / bandwidth + latency`` on top of the
framework profile's calibrated overhead, with bandwidth and latency
measured by ``repro_torch.bench.timing.calibrate_link`` (a ping-pong of
the scheme's collective over a process group) or synthetic. Under a
``stale`` exchange mode the exchange overlaps the next rounds' compute,
so the model only charges the overhang ``max(0, t_wire - k t_compute)``.

The time model, ``time_to_eps``, ``optimal_H``, ``compute_fraction_at``
and ``autotune_H`` are pure Python and give the reference's numbers
exactly; ``sweep_H`` runs the trainers (on the card unless ``device``
says otherwise) and measures the solver's wall time there.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.bench.timing import LinkCalibration, measure_solver_time
from repro_torch.comm.collectives import get_backend
from repro_torch.core.baselines import MinibatchSCD, MinibatchSGD, SGDConfig
from repro_torch.core.cocoa import CoCoATrainer
from repro_torch.core.distributed import ExchangeConfig
from repro_torch.core.overheads import OverheadProfile

SWEEP_ALGORITHMS = ("cocoa", "minibatch_scd", "minibatch_sgd")


class NoConvergedPointError(RuntimeError):
    """No grid point reached the target eps — there is no optimum to
    report. Carries the sweep so callers can show what was tried."""

    def __init__(self, sweep: "HSweep"):
        self.sweep = sweep
        grid = [p.H for p in sweep.points]
        super().__init__(
            f"no H in {grid} reached eps={sweep.eps} "
            f"(algorithm={sweep.algorithm!r}, scheme={sweep.scheme!r}, "
            f"mode={sweep.mode!r})")


@dataclass
class HSweepPoint:
    H: int
    rounds_to_eps: int | None
    t_solver_s: float          # measured local-solver wall time per round


@dataclass
class HSweep:
    eps: float
    n_local: int
    t_ref_s: float = float("nan")  # measured t_solver at H = n_local
    points: list = field(default_factory=list)
    algorithm: str = "cocoa"
    scheme: str = "persistent"     # display: the exchange's scheme name
    mode: str = "sync"             # display: the exchange's mode spec
    comm_bytes_per_round: int = 0  # modelled wire traffic (H-independent)
    exchange: str = "persistent"   # full canonical ExchangeConfig spec
    workers: int = 0               # K the sweep ran with (barrier model)

    def __post_init__(self):
        # a sweep built from the display (scheme, mode) pair alone folds
        # it into the canonical spec, so for_sweep() — which reads ONLY
        # `exchange` — never silently drops a stale mode
        if self.exchange == "persistent" and (self.scheme != "persistent"
                                              or self.mode != "sync"):
            self.exchange = ExchangeConfig.parse(
                self.scheme if self.mode == "sync"
                else f"{self.scheme}/{self.mode}").spec


@dataclass(frozen=True)
class TimeModel:
    """Exchange-aware wall-clock model of one round:

        t_round(H) = profile.round_time(barrier_mult * t_solver, t_ref)
                     + comm_bytes_per_round / bandwidth + latency   # sync
                     + max(0, t_wire - k * t_compute)               # stale

    The first term is the paper's calibrated framework overhead
    (§5.2/Fig 3), with the compute term stretched by the exchange's
    straggler profile: a bulk-synchronous round waits for its slowest
    worker, so compute is charged as E[max over the ``workers``
    multipliers] x ``t_solver``. The second charges the scheme's
    modelled wire traffic against a
    :class:`~repro_torch.bench.timing.LinkCalibration`, the link latency
    paid once per sequential hop of the exchange's backend. Under a
    stale mode a ``k``-deep pending queue lets the exchange hide behind
    up to ``k`` rounds of (barrier-stretched) compute, so the round only
    pays the overhang. With ``link=None`` the model is the bare profile.

    ``exchange`` is an :class:`ExchangeConfig` or spec string. A
    straggler-bearing exchange, and any backend but ``xla``, require
    ``workers`` (the K the max and the hop count are taken over).
    """
    profile: OverheadProfile
    comm_bytes_per_round: int = 0
    link: LinkCalibration | None = None
    exchange: "ExchangeConfig | str | None" = None
    workers: int = 0

    def __post_init__(self):
        ex = ExchangeConfig.parse(self.exchange)
        object.__setattr__(self, "exchange", ex)
        if ex.straggler.active and self.workers < 1:
            raise ValueError(
                "TimeModel with a straggler profile needs workers=K — "
                "the barrier charges E[max over K workers]")
        if ex.backend != "xla" and self.workers < 1:
            raise ValueError(
                f"TimeModel with the {ex.backend!r} collective backend "
                f"needs workers=K — the hop latency scales with the "
                f"ring size")

    @property
    def name(self) -> str:
        return self.profile.name

    @property
    def barrier_mult(self) -> float:
        """The factor the bulk-synchronous barrier stretches compute
        by: E[max over workers] of the straggler multiplier (1.0 with
        no stragglers)."""
        s = self.exchange.straggler
        return s.expected_barrier_mult(self.workers) if s.active else 1.0

    def comm_time_s(self, t_compute_s: float = 0.0) -> float:
        """Wall seconds the round pays for the wire. ``t_compute_s``
        only matters under a stale mode: the exchange hides behind up
        to ``k`` rounds of that much compute."""
        if self.link is None or self.comm_bytes_per_round <= 0:
            return 0.0
        ex = self.exchange
        overlap = ex.mode.k * t_compute_s if ex.mode.stale else 0.0
        # the backend owns how many sequential per-hop latencies one
        # exchange pays: 1 for a fused xla collective, up to 2*(K-1)
        # for the explicit ring
        hops = get_backend(ex.backend).latency_hops(
            ex.scheme.transport, self.workers or 1)
        return self.link.seconds_for(self.comm_bytes_per_round, overlap,
                                     latency_hops=max(hops, 1))

    def round_time(self, t_solver_s: float, t_ref_s: float,
                   t_master_s: float = 0.0) -> float:
        t_eff = self.barrier_mult * t_solver_s
        return (self.profile.round_time(t_eff, t_ref_s, t_master_s)
                + self.comm_time_s(self.profile.compute_mult * t_eff))

    def compute_fraction(self, t_solver_s: float, t_ref_s: float) -> float:
        """Fraction of the round doing USEFUL compute: straggler
        barrier slack counts as overhead, not compute."""
        c = self.profile.compute_mult * t_solver_s
        c_barrier = self.barrier_mult * c
        other = ((c_barrier - c) + self.profile.overhead_units * t_ref_s
                 + self.comm_time_s(c_barrier))
        return c / max(c + other, 1e-30)

    def for_sweep(self, sweep: HSweep) -> "TimeModel":
        """The same model charged with a sweep's modelled traffic and
        run under the sweep's full exchange spec and worker count."""
        return dataclasses.replace(
            self, comm_bytes_per_round=sweep.comm_bytes_per_round,
            exchange=sweep.exchange,
            workers=sweep.workers or self.workers)


def make_trainer(algorithm: str, cfg, A, b, *, device=None,
                 index_source: Callable | None = None):
    """One trainer of the virtual driver; ``cfg`` must match the
    algorithm family (CoCoAConfig for cocoa / minibatch_scd, SGDConfig
    for minibatch_sgd). ``index_source`` (``t -> (K, H)`` coordinates;
    for SGD ``t -> (K, H, batch_local)`` rows) replaces the trainer's
    default draw."""
    if algorithm == "cocoa":
        return CoCoATrainer(cfg, A, b, device=device,
                            index_source=index_source)
    if algorithm == "minibatch_scd":
        return MinibatchSCD(cfg, A, b, device=device,
                            index_source=index_source)
    if algorithm == "minibatch_sgd":
        if not isinstance(cfg, SGDConfig):
            raise TypeError(f"minibatch_sgd needs an SGDConfig, got "
                            f"{type(cfg).__name__}")
        return MinibatchSGD(cfg, A, b, device=device, row_source=index_source)
    raise ValueError(f"unknown algorithm {algorithm!r}; "
                     f"known: {SWEEP_ALGORITHMS}")


def sweep_H(A, b, base_cfg, H_grid, eps: float = 1e-3,
            max_rounds: int = 2000, measure: bool = True,
            algorithm: str = "cocoa", *, device=None,
            index_source_for: Callable | None = None) -> HSweep:
    """Measured rounds-to-eps and solver wall time per H for any of the
    three algorithms, under ``base_cfg.exchange``, one new trainer a grid
    point (on ``device``, the card by default). ``index_source_for(H)``
    gives grid point H's index source (for SGD, its row source); ``None``
    keeps each trainer's default draw. With ``measure``, each point's
    ``t_solver_s`` is :func:`measure_solver_time` at its H, and
    ``t_ref_s`` that at H = n_local."""
    n_local = int(np.ceil(A.shape[1] / base_cfg.K))
    ex = base_cfg.exchange
    sweep = HSweep(eps=eps, n_local=n_local, algorithm=algorithm,
                   scheme=ex.scheme.name, mode=ex.mode.spec,
                   exchange=ex.spec, workers=base_cfg.K)
    trainer = None
    for H in H_grid:
        cfg = dataclasses.replace(base_cfg, H=int(H))
        # the previous point's trainer is dropped here, before this one
        # places its data: one point's data on the device at a time
        trainer = make_trainer(
            algorithm, cfg, A, b, device=device,
            index_source=None if index_source_for is None
            else index_source_for(int(H)))
        hist = (trainer.run_workers(max_rounds, record_every=1,
                                    target_eps=eps)
                if isinstance(trainer, MinibatchSGD)
                else trainer.run(max_rounds, record_every=1, target_eps=eps))
        t_s = measure_solver_time(trainer, int(H)) if measure else float("nan")
        sweep.points.append(HSweepPoint(int(H), hist.rounds_to(eps), t_s))
        sweep.comm_bytes_per_round = trainer.comm_bytes_per_round()
    if measure:
        # with_H gives the base configuration at H = n_local from any
        # trainer of the sweep
        if trainer is None:
            trainer = make_trainer(algorithm, base_cfg, A, b, device=device)
        sweep.t_ref_s = measure_solver_time(trainer, n_local)
    return sweep


def time_to_eps(model, point: HSweepPoint, t_ref_s: float) -> float:
    """``model`` is anything with ``round_time(t_solver, t_ref)``: an
    :class:`~repro_torch.core.overheads.OverheadProfile` (overhead only)
    or a :class:`TimeModel` (overhead + the scheme's traffic)."""
    if point.rounds_to_eps is None:
        return float("inf")
    return point.rounds_to_eps * model.round_time(point.t_solver_s, t_ref_s)


def optimal_H(model, sweep: HSweep) -> tuple[int, float]:
    """(H*, time-to-eps at H*) for one framework profile or time model.
    Raises :class:`NoConvergedPointError` when no grid point reached the
    sweep's eps."""
    best = (None, float("inf"))
    for p in sweep.points:
        t = time_to_eps(model, p, sweep.t_ref_s)
        if t < best[1]:
            best = (p.H, t)
    if best[0] is None:
        raise NoConvergedPointError(sweep)
    return best


def compute_fraction_at(model, sweep: HSweep, H: int) -> float:
    for p in sweep.points:
        if p.H == H:
            return model.compute_fraction(p.t_solver_s, sweep.t_ref_s)
    raise KeyError(f"H={H} is not a sweep grid point "
                   f"(grid: {[p.H for p in sweep.points]})")


def autotune_H(rounds_to_eps_fn, round_time_fn, lo: int, hi: int,
               tol: int = 1) -> int:
    """Golden-section search over integer H minimizing
    rounds_to_eps(H) * round_time(H). Both callables may be models or
    live measurements.

    The endpoints ``lo`` / ``hi`` are evaluated explicitly and the
    argmin of EVERY evaluated cost is returned, so a boundary optimum
    (common when overhead is tiny, e.g. ``E_mpi``) is found, and a
    midpoint that beats neither probe can never be returned."""
    phi = (np.sqrt(5) - 1) / 2
    evaluated: dict[int, float] = {}

    def cost(H):
        H = int(round(H))
        if H not in evaluated:
            r = rounds_to_eps_fn(H)
            evaluated[H] = (float("inf") if r is None
                            else r * round_time_fn(H))
        return evaluated[H]

    cost(lo), cost(hi)
    a, b = float(lo), float(hi)
    c, d = b - phi * (b - a), a + phi * (b - a)
    fc, fd = cost(c), cost(d)
    while b - a > tol:
        if fc <= fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = cost(c)
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = cost(d)
    cost((a + b) / 2)
    return min(evaluated, key=evaluated.get)
