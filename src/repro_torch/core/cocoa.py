"""CoCoA: communication-efficient distributed primal-dual GLM training
(the port of ``repro.core.cocoa``).

``CoCoATrainer.run()`` runs K *virtual* workers on one device: each
round, every worker takes H local SCD steps on its column block (one
batched solve, kernel K1 under ``solver="scd_kernel"`` on the card),
the K updates Delta v are exchanged under the configured exchange (under
``compressed:int8``, ``compressed:int4`` and ``compressed:int2``, and
their error-feedback forms ``compressed:ef:<base>``, through kernels K2
and K3 on the card; under ``compressed:topk(r=..)`` and
``compressed:ef:topk(r=..)`` through kernel K4), the shared residual
``w = A alpha - b`` absorbs their sum (under ``stale:k=..`` ``k`` rounds
late), and the primal objective is evaluated from ``w`` and the
per-worker regularizers without gathering alpha. The exchange may also
drop workers for a window of rounds (``drop:``) or carry a straggler
profile, which changes no number.

Randomness: the reference samples each worker's H coordinates with
``jax.random.categorical`` under keys split per round and per worker.
PyTorch cannot reproduce threefry, so the trainer takes an *index
source*: a callable ``source(t) -> (K, H) int32`` for 1-based round
``t``. The default, :class:`UniformIndices`, draws uniformly over each
worker's real columns from a ``torch.Generator`` on the device — the
distribution the reference draws from. ``repro_torch.carry.ReplayIndices``
replays the reference's own stream.

The real columns of each worker come first in its block
(``pack_columns_t``), so "uniform over the real columns" is "uniform
over ``[0, size_k)``".

``CoCoATrainer.run_sharded()`` runs the same round with one worker per
process of a ``torch.distributed`` group (``repro_torch.launch.dist``
starts them): each rank holds only its own worker's column block on its
device, takes its row of the same index stream, and exchanges through
the collective fabric of the exchange's backend. A rank may be given
only its block (:class:`WorkerColumns`) instead of the whole matrix.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import partition as part_mod
from repro_torch.core import solvers
from repro_torch.core.glm import (GLMProblem, optimal_objective,
                                  primal_objective, suboptimality)
from repro_torch.utils import spans
from repro_torch.utils.device import resolve_device


@dataclass(frozen=True)
class CoCoAConfig:
    K: int = 8                       # number of workers
    H: int = 256                     # local SCD steps per round
    lam: float = 1.0
    eta: float = 1.0                 # 1.0 = ridge
    sigma: float | None = None       # subproblem safety; default K ("adding")
    solver: str = "scd_ref"          # scd_ref | scd_kernel | scd_fixed
    # an ExchangeConfig or a spec string ("compressed:int4/stale:k=2");
    # None is the default persistent/sync exchange
    exchange: "dist.ExchangeConfig | str | None" = None
    partitioner: str = "balanced"    # balanced | block
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "exchange",
                           dist.ExchangeConfig.parse(self.exchange))
        if self.partitioner not in ("balanced", "block"):
            raise ValueError(f"unknown partitioner {self.partitioner!r}; "
                             f"known: ('balanced', 'block')")
        if self.solver not in ("scd_ref", "scd_kernel", "scd_fixed"):
            raise ValueError(f"unknown local solver {self.solver!r}")

    @property
    def sigma_val(self) -> float:
        return float(self.K if self.sigma is None else self.sigma)


@dataclass
class History:
    """One entry a recorded round: its number, primal and suboptimality.
    ``seconds[i]`` is the host time from the previous record (or from
    the first round's start) until record ``i``'s primal is on the host,
    which waits for the device; ``span[i]`` is the number of rounds that
    time covers."""
    rounds: list = field(default_factory=list)
    primal: list = field(default_factory=list)
    subopt: list = field(default_factory=list)
    seconds: list = field(default_factory=list)
    span: list = field(default_factory=list)
    p_star: float = float("nan")
    p_zero: float = float("nan")

    def rounds_to(self, eps: float) -> int | None:
        for r, s in zip(self.rounds, self.subopt):
            if s <= eps:
                return r
        return None


def record_rounds(hist: History, step: Callable, state, rounds: int,
                  record_every: int, target_eps: float | None,
                  first_round: int = 1):
    """Run ``step(state, t) -> (state, primal)`` for rounds
    ``first_round ..`` (``primal()`` gives the round's primal, a 0-dim
    tensor), recording into ``hist`` as the reference's ``_record_loop``
    does: round ``t`` only when ``t % record_every == 0`` or it is the
    last round, and an early stop at ``target_eps`` only at a recorded
    round. A round that is not recorded never reads its primal, so the
    host does not wait for the device. Returns the last state and the
    last round run (0 when none ran), as :func:`dist.finish_run` takes
    it."""
    if record_every < 1:
        raise ValueError(f"record_every must be >= 1, got {record_every}")
    last = first_round + rounds - 1
    last_t, prev_t = 0, first_round - 1
    # the round span takes History's clock reads where it has them
    t0 = start = time.perf_counter_ns()
    for t in range(first_round, last + 1):
        p = None
        with spans.span("round", t=t, start_ns=start, anchor=True) as rnd:
            state, primal = step(state, t)
            last_t = t
            if t % record_every == 0 or t == last:
                with spans.span("read_back", sync=True):
                    p = float(primal())
                t1 = time.perf_counter_ns()
                rnd.stop(t1)
        start = None
        if p is None:
            continue
        hist.seconds.append((t1 - t0) / 1e9)
        s = suboptimality(p, hist.p_star, hist.p_zero)
        hist.rounds.append(t)
        hist.primal.append(p)
        hist.subopt.append(s)
        hist.span.append(t - prev_t)
        prev_t = t
        if target_eps is not None and s <= target_eps:
            break
        t0 = start = time.perf_counter_ns()
    spans.count("rounds", last_t - first_round + 1 if last_t else 0)
    return state, last_t


def round_step(round_fn: Callable, source: Callable) -> Callable:
    """The :func:`record_rounds` step of a driver's run (virtual or
    sharded): round ``t`` on ``source(t)``'s indices (the ``draw``
    span), the state the ``(local, shared)`` pair."""
    def step(state, t):
        with spans.span("draw", round_fn.device):
            idx = source(t)
        local, shared, primal = round_fn(*state, idx, t)
        return (local, shared), lambda: primal
    return step


def from_rank0(fabric: dist.Fabric, compute: Callable, device) -> float:
    """``compute()`` on rank 0, broadcast to every rank (computed once,
    not once a rank)."""
    x = torch.full((1,), compute() if fabric.rank == 0 else 0.0,
                   dtype=torch.float64, device=device)
    return float(fabric.broadcast(x)[0])


@dataclass(frozen=True)
class WorkerColumns:
    """All that one rank of a sharded CoCoA run needs of ``A``: the
    column partition and worker ``rank``'s columns of an (m, n) matrix,
    one a row in the partition's order (``columns``, (size, m): the
    layout of its ``A_T`` block). A trainer built on it runs
    ``run_sharded`` on that rank only."""
    part: part_mod.Partition
    rank: int
    columns: np.ndarray
    n: int


class UniformIndices:
    """The default index source: each worker's H coordinates uniform
    over its real columns, from a ``torch.Generator`` on ``device``
    seeded by ``(seed, t)``. A round's draw depends on nothing but the
    seed and its round number, so a second trainer with the same seed
    replays the same stream."""

    def __init__(self, sizes, H: int, seed: int, device: torch.device):
        self.sizes = torch.as_tensor(np.asarray(sizes), dtype=torch.float32,
                                     device=device)
        self.H, self.seed, self.device = int(H), int(seed), device

    def __call__(self, t: int) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 1_000_003 + int(t))
        u = torch.rand((self.sizes.shape[0], self.H), generator=g,
                       device=self.device)
        idx = torch.floor(u * self.sizes[:, None]).to(torch.int32)
        # u < 1, but u * size may round up to size in f32
        return torch.minimum(idx, (self.sizes[:, None] - 1).to(torch.int32))


def _get_solver(name: str) -> Callable:
    if name == "scd_ref":
        return solvers.scd_steps
    if name == "scd_fixed":
        return solvers.scd_steps_fixed_point_batched
    from repro_torch.kernels import ops as kops
    return kops.scd_steps_kernel


class _CoCoARound:
    """CoCoA's plug into the virtual round driver: the batched local
    SCD solve, the residual update ``w += sum_k Delta v_k``, and the
    primal metric evaluated without gathering alpha
    (``loss(w) + sum_k reg_k``). Mini-batch SCD (``solver="scd_fixed"``)
    is damped by 1/sigma here, in one place."""

    def __init__(self, cfg: CoCoAConfig, problem: GLMProblem,
                 solver: Callable):
        self.cfg, self.problem, self.solver = cfg, problem, solver

    def local_step(self, data, alpha, w, idx, t):
        cfg = self.cfg
        A_T, col_sq, _ = data
        dv, alpha_new = self.solver(A_T, col_sq, alpha, w, idx,
                                    sigma=cfg.sigma_val, lam=cfg.lam,
                                    eta=cfg.eta)
        if cfg.solver == "scd_fixed":
            # scale BOTH the local move and Delta v by 1/sigma so the
            # shared-residual invariant w = A alpha - b survives
            alpha_new = alpha + (alpha_new - alpha) / cfg.sigma_val
            dv = dv / cfg.sigma_val
        return dv, alpha_new

    def apply_update(self, w, total_dv, t):
        return w + total_dv

    def local_metric(self, data, alpha, w_new):
        _, _, mask = data
        return self.problem.regularizer(alpha * mask)

    def finalize_metric(self, w_new, reg_sum):
        return self.problem.loss(w_new) + reg_sum


def col_sq_of(A_T: torch.Tensor) -> torch.Tensor:
    """The ``(K, n_pad)`` squared column norms of a ``(K, n_pad, m)``
    stack, one worker at a time, so that a worker's norms are the same
    bits whether its block is reduced alone or in the stack."""
    return torch.stack([torch.sum(a * a, dim=1) for a in A_T])


class CoCoATrainer:
    """Owns the partitioned data and the round functions.

    ``device`` defaults to the card and raises without one; the tests
    pass ``device="cpu"``. ``index_source`` is a callable ``t -> (K, H)
    int32`` on the device (default :class:`UniformIndices`). ``A`` is
    the (m, n) matrix or, for one rank of a sharded run,
    :class:`WorkerColumns`. The data go to the device at first use:
    the whole partitioned matrix for :meth:`run`, only the rank's own
    block for :meth:`run_sharded`."""

    def __init__(self, cfg: CoCoAConfig, A, b: np.ndarray, *,
                 device=None, index_source: Callable | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.problem = GLMProblem(lam=cfg.lam, eta=cfg.eta)
        self.exchange = cfg.exchange
        self.scheme = self.exchange.scheme
        self.mode = self.exchange.mode
        self.exchange.membership.check_workers(cfg.K)
        self.b_np = np.asarray(b, np.float32)
        if isinstance(A, WorkerColumns):
            if A.part.K != cfg.K:
                raise ValueError(f"WorkerColumns of a {A.part.K}-worker "
                                 f"partition for a K={cfg.K} run")
            self.A_np, self.block = None, A
            self.part = A.part
            self.m, self.n = A.columns.shape[1], A.n
        else:
            self.A_np, self.block = np.asarray(A, np.float32), None
            self.m, self.n = self.A_np.shape
            if cfg.partitioner == "balanced":
                nnz = (np.abs(self.A_np) > 0).sum(axis=0)
                self.part = part_mod.balanced_partition(nnz, cfg.K)
            else:
                self.part = part_mod.block_partition(self.n, cfg.K)
        self.b = torch.from_numpy(self.b_np).to(self.device)
        self.index_source = index_source or UniformIndices(
            self.part.sizes, cfg.H, cfg.seed, self.device)
        self._algo = _CoCoARound(cfg, self.problem, _get_solver(cfg.solver))
        self._p_star_cache: float | None = None

    @functools.cached_property
    def A(self) -> torch.Tensor:
        """The (m, n) matrix on the device."""
        if self.A_np is None:
            raise RuntimeError(
                f"this trainer holds only worker {self.block.rank}'s columns "
                f"(WorkerColumns); it runs run_sharded() on that rank")
        return torch.from_numpy(self.A_np).to(self.device)

    @functools.cached_property
    def _data(self):
        """The virtual driver's ``(A_T (K, n_pad, m), col_sq (K, n_pad),
        mask (K, n_pad))``."""
        A_T, mask = part_mod.pack_columns_t(self.A, self.part)
        return A_T, col_sq_of(A_T), mask

    @property
    def A_T(self) -> torch.Tensor:
        return self._data[0]

    @property
    def col_sq(self) -> torch.Tensor:
        return self._data[1]

    @property
    def mask(self) -> torch.Tensor:
        return self._data[2]

    @functools.cached_property
    def _round_fn(self):
        return dist.build_virtual_round(self._algo, self.exchange,
                                        self._data, K=self.cfg.K)

    def worker_data(self, rank: int):
        """Worker ``rank``'s ``(1, ...)`` slice of the data, built from
        its own columns only: ``(A_T (1, n_pad, m), col_sq (1, n_pad),
        mask (1, n_pad))`` on the device."""
        ids = self.part.owned[rank]
        if self.block is not None:
            if self.block.rank != rank:
                raise ValueError(f"this trainer holds worker "
                                 f"{self.block.rank}'s columns, not worker "
                                 f"{rank}'s")
            columns = self.block.columns
        else:
            columns = self.A_np[:, ids].T
        columns = torch.from_numpy(np.ascontiguousarray(columns, np.float32))
        A_T = torch.zeros((1, self.part.n_padded, self.m),
                          dtype=torch.float32, device=self.device)
        A_T[0, :len(ids)] = columns.to(self.device)
        mask = torch.zeros((1, self.part.n_padded), dtype=torch.float32,
                           device=self.device)
        mask[0, :len(ids)] = 1.0
        return A_T, col_sq_of(A_T), mask

    @property
    def p_star(self) -> float:
        if self._p_star_cache is None:
            self._p_star_cache = optimal_objective(self.problem, self.A,
                                                   self.b)
        return self._p_star_cache

    @property
    def p_zero(self) -> float:
        return float(self.problem.loss(-self.b))

    def init_state(self):
        """The round-0 state ``(local, shared)``: ``local`` is alpha
        ``(K, n_pad)`` or, under a stateful (``ef:``) codec, the pair
        ``(alpha, residual (K, m))``; ``shared`` is ``w = A @ 0 - b``
        or, under ``stale:k=..``, the pair ``(w, queue (k, m))``."""
        alpha = torch.zeros((self.cfg.K, self.part.n_padded),
                            dtype=torch.float32, device=self.device)
        return (dist.wrap_local_state(self.exchange, alpha, self.m,
                                      self.cfg.K),
                dist.init_exchange_state(self.exchange, -self.b))

    def with_H(self, H: int) -> "CoCoATrainer":
        """A trainer on the same problem and device with the H knob moved
        and the default index source for the new H. The partition, the
        data already on the device and ``p_star`` do not depend on H, so
        the new trainer shares them with this one instead of building
        them again: it is a copy of this trainer whose configuration,
        index source and round function are made anew, without this
        trainer's results."""
        new = copy.copy(self)
        new.cfg = dataclasses.replace(self.cfg, H=int(H))
        new.index_source = UniformIndices(self.part.sizes, new.cfg.H,
                                          new.cfg.seed, self.device)
        new._algo = _CoCoARound(new.cfg, self.problem,
                                _get_solver(new.cfg.solver))
        for name in ("_round_fn", "alpha", "w_final", "alpha_final"):
            new.__dict__.pop(name, None)
        return new

    def comm_bytes_per_round(self, t: int | None = None) -> int:
        """Modelled bytes on the wire per round under the configured
        scheme and backend (the codec's payload for
        ``compressed:<codec>``, f32 otherwise; the alpha round trip
        counts the padded blocks).
        ``t`` asks for one 1-based round of the membership schedule:
        dropped workers ship nothing (``None``: all K live)."""
        K_live = (None if t is None
                  else self.exchange.membership.live_count(t, self.cfg.K))
        return self.scheme.bytes_per_round(
            self.m, self.cfg.K, local_state_len=self.cfg.K * self.part.n_padded,
            K_live=K_live, backend=self.exchange.backend)

    def run(self, rounds: int, record_every: int = 1,
            target_eps: float | None = None, *, state=None,
            first_round: int = 1) -> History:
        """Run up to ``rounds`` rounds, numbered from ``first_round``,
        from ``state`` (``(local, shared)`` as :meth:`init_state` shapes
        it, default the zero start), recording every ``record_every``-th
        round and the last (:func:`record_rounds`); stop early at a
        recorded round whose suboptimality reaches ``target_eps``. Under
        ``stale`` the recorded primal is one round behind (the driver's
        metric), and the pending aggregates are absorbed after the last
        round, recorded or not."""
        with spans.span("solve"):
            hist = History(p_star=self.p_star, p_zero=self.p_zero)
            (local, w), last_t = record_rounds(
                hist, round_step(self._round_fn, self.index_source),
                self.init_state() if state is None else state, rounds,
                record_every, target_eps, first_round)
            with spans.span("finish", sync=True):
                w = dist.finish_run(self._round_fn, w, last_t)
                self.alpha = dist.unwrap_local_state(self.exchange, local)
                self.w_final = w.cpu().numpy()
                self.alpha_final = part_mod.unpack_alpha(
                    self.alpha.cpu().numpy(), self.part, self.n)
        return hist

    def build_sharded_round(self, group=None) -> Callable:
        """This rank's round on the sharded driver, over ``group``
        (``None``: the default process group, one rank per worker), on
        the rank's own block of the data. Returns ``round_fn(local,
        shared, idx, t)`` as :func:`dist.build_sharded_round` does."""
        fabric = dist.open_fabric(group, self.cfg.K)
        return dist.build_sharded_round(
            self._algo, self.exchange, self.worker_data(fabric.rank),
            group=fabric, K=self.cfg.K)

    def run_sharded(self, rounds: int, group=None, record_every: int = 1,
                    target_eps: float | None = None, *,
                    p_star: float | None = None) -> History:
        """:meth:`run` with one worker per rank of ``group`` (``None``:
        the default process group, whose size must be K; start the ranks
        with ``repro_torch.launch.dist``). Every rank records the same
        History. ``p_star`` is computed once, on rank 0, unless given.
        After the run every rank holds ``w_final``, the gathered ``alpha``
        (K, n_pad) and ``alpha_final``."""
        with spans.span("solve"):
            round_fn = self.build_sharded_round(group)
            fabric = round_fn.fabric
            if p_star is None:
                p_star = from_rank0(fabric, lambda: self.p_star, self.device)
            hist = History(p_star=p_star, p_zero=self.p_zero)
            state = dist.place_state(fabric.rank, *self.init_state())
            (local, w), last_t = record_rounds(
                hist, round_step(round_fn, self.index_source), state, rounds,
                record_every, target_eps)
            with spans.span("finish", sync=True):
                w = dist.finish_run(round_fn, w, last_t)
                self.alpha = fabric.all_gather(
                    dist.unwrap_local_state(self.exchange, local))
                self.w_final = w.cpu().numpy()
                self.alpha_final = part_mod.unpack_alpha(
                    self.alpha.cpu().numpy(), self.part, self.n)
        return hist

    def objective_of(self, alpha_global: np.ndarray) -> float:
        return float(primal_objective(
            self.problem, self.A, self.b,
            torch.as_tensor(np.asarray(alpha_global, np.float32),
                            device=self.device)))
