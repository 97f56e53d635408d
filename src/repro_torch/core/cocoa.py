"""CoCoA: communication-efficient distributed primal-dual GLM training
(the port of ``repro.core.cocoa``, virtual driver).

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

``run_sharded`` (real distribution over devices) waits for the sharded
driver (ROADMAP.md Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
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
    t0 = time.perf_counter()
    for t in range(first_round, last + 1):
        state, primal = step(state, t)
        last_t = t
        if t % record_every == 0 or t == last:
            p = float(primal())
            hist.seconds.append(time.perf_counter() - t0)
            s = suboptimality(p, hist.p_star, hist.p_zero)
            hist.rounds.append(t)
            hist.primal.append(p)
            hist.subopt.append(s)
            hist.span.append(t - prev_t)
            prev_t = t
            if target_eps is not None and s <= target_eps:
                break
            t0 = time.perf_counter()
    return state, last_t


def virtual_step(round_fn: Callable, source: Callable) -> Callable:
    """The :func:`record_rounds` step of a virtual-driver run: round
    ``t`` on ``source(t)``'s indices, the state the ``(local, shared)``
    pair."""
    def step(state, t):
        local, shared, primal = round_fn(*state, source(t), t)
        return (local, shared), lambda: primal
    return step


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


class CoCoATrainer:
    """Owns the partitioned data on the device and the round function.

    ``device`` defaults to the card and raises without one; the tests
    pass ``device="cpu"``. ``index_source`` is a callable ``t -> (K, H)
    int32`` on the device (default :class:`UniformIndices`)."""

    def __init__(self, cfg: CoCoAConfig, A: np.ndarray, b: np.ndarray, *,
                 device=None, index_source: Callable | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.problem = GLMProblem(lam=cfg.lam, eta=cfg.eta)
        self.exchange = cfg.exchange
        self.scheme = self.exchange.scheme
        self.mode = self.exchange.mode
        self.A_np = np.asarray(A, np.float32)
        self.b_np = np.asarray(b, np.float32)
        m, n = self.A_np.shape
        self.m, self.n = m, n
        nnz = (np.abs(self.A_np) > 0).sum(axis=0)
        if cfg.partitioner == "balanced":
            self.part = part_mod.balanced_partition(nnz, cfg.K)
        else:
            self.part = part_mod.block_partition(n, cfg.K)
        self.A = torch.from_numpy(self.A_np).to(self.device)       # (m, n)
        self.b = torch.from_numpy(self.b_np).to(self.device)
        self.A_T, self.mask = part_mod.pack_columns_t(self.A, self.part)
        self.col_sq = torch.sum(self.A_T * self.A_T, dim=2)       # (K, n_pad)
        self.index_source = index_source or UniformIndices(
            self.part.sizes, cfg.H, cfg.seed, self.device)
        self._algo = _CoCoARound(cfg, self.problem, _get_solver(cfg.solver))
        self._data = (self.A_T, self.col_sq, self.mask)
        self._round_fn = dist.build_virtual_round(
            self._algo, self.exchange, self._data, K=cfg.K)
        self._p_star_cache: float | None = None

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
        """A fresh trainer on the same problem and device with the H knob
        moved (and the default index source for the new H)."""
        return type(self)(dataclasses.replace(self.cfg, H=int(H)),
                          self.A_np, self.b_np, device=self.device)

    def comm_bytes_per_round(self, t: int | None = None) -> int:
        """Modelled bytes through the master per round under the
        configured scheme (the codec's payload for ``compressed:<codec>``,
        f32 otherwise; the alpha round trip counts the padded blocks).
        ``t`` asks for one 1-based round of the membership schedule:
        dropped workers ship nothing (``None``: all K live)."""
        K_live = (None if t is None
                  else self.exchange.membership.live_count(t, self.cfg.K))
        return self.scheme.bytes_per_round(
            self.m, self.cfg.K, local_state_len=self.cfg.K * self.part.n_padded,
            K_live=K_live)

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
        hist = History(p_star=self.p_star, p_zero=self.p_zero)
        (local, w), last_t = record_rounds(
            hist, virtual_step(self._round_fn, self.index_source),
            self.init_state() if state is None else state, rounds,
            record_every, target_eps, first_round)
        w = dist.finish_run(self._round_fn, w, last_t)
        self.alpha = dist.unwrap_local_state(self.exchange, local)
        self.w_final = w.cpu().numpy()
        self.alpha_final = part_mod.unpack_alpha(self.alpha.cpu().numpy(),
                                                 self.part, self.n)
        return hist

    def run_sharded(self, *args, **kwargs) -> History:
        raise NotImplementedError(
            "the sharded driver is not ported yet (ROADMAP.md Queue 1 "
            "item 8); use run()")

    def objective_of(self, alpha_global: np.ndarray) -> float:
        return float(primal_objective(
            self.problem, self.A, self.b,
            torch.as_tensor(np.asarray(alpha_global, np.float32),
                            device=self.device)))
