"""The paper's two baselines on the port's virtual driver (the port of
``repro.core.baselines``).

* Mini-batch SCD (SDCA-style, no immediate local updates) —
  :class:`MinibatchSCD`: CoCoA's partitioning, driver and exchanges, but
  every local step sees the round-start residual and the aggregate is
  damped by 1/sigma (paper §2.1). Its solve is the batched exact form
  ``solvers.scd_steps_fixed_point_batched``.

* Mini-batch SGD — :class:`MinibatchSGD`, the MLlib
  ``LinearRegressionWithSGD`` stand-in (paper §5.4, Fig 5): row-sampled
  gradient steps on the primal with a 1/sqrt(t) step size. ``run()`` is
  the legacy single-device loop over global rows; ``run_workers()`` is
  the virtual driver over K zero-padded row blocks, exchanging an
  n-length gradient (H = 1) or model delta (H > 1, local SGD) where
  CoCoA exchanges an m-vector.

Randomness: the reference draws rows with ``jax.random.choice(...,
replace=False)``, which PyTorch cannot reproduce, so the trainer takes
*row sources*, as ``CoCoATrainer`` takes an index source:
``row_source(t) -> (K, H, batch_local)`` for ``run_workers`` and
``global_row_source(t) -> (batch,)`` for ``run``, 1-based round ``t``.
The default, :class:`UniformRows`, draws distinct rows uniformly from a
``torch.Generator`` on the device; ``repro_torch.carry.ReplayIndices``
replays the reference's own streams.

Every trainer also runs on the sharded driver (``run_sharded``): one
worker per process of a ``torch.distributed`` group, each holding only
its own block (mini-batch SCD: CoCoA's column block; SGD: its row block,
or just that, :class:`WorkerRows`).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core.cocoa import (CoCoAConfig, CoCoATrainer, History,
                                    from_rank0, record_rounds,
                                    round_step)
from repro_torch.core.glm import (GLMProblem, optimal_objective,
                                  primal_objective)
from repro_torch.kernels.bmv import batched_matvec, batched_vecmat
from repro_torch.utils import spans
from repro_torch.utils.device import full_f32_matmul, resolve_device


class MinibatchSCD(CoCoATrainer):
    """First-class mini-batch SCD (the paper's §2.1 baseline): a
    ``CoCoATrainer`` that forces ``solver="scd_fixed"``, so the baseline
    cannot silently run CoCoA's immediate-local-update solver."""

    def __init__(self, cfg: CoCoAConfig, A, b: np.ndarray, *,
                 device=None, index_source: Callable | None = None):
        if cfg.solver != "scd_fixed":
            cfg = dataclasses.replace(cfg, solver="scd_fixed")
        super().__init__(cfg, A, b, device=device, index_source=index_source)


@dataclass(frozen=True)
class SGDConfig:
    batch_frac: float = 1.0          # MLlib miniBatchFraction
    step_size: float = 1.0           # base step (gamma / sqrt(t) schedule)
    lam: float = 1.0
    eta: float = 1.0
    K: int = 8
    H: int = 1                       # local SGD steps per round (H=1: MLlib)
    seed: int = 0
    # an ExchangeConfig or a spec string ("compressed:int8/drop:1@3-5");
    # None is the default persistent/sync exchange
    exchange: "dist.ExchangeConfig | str | None" = None

    def __post_init__(self):
        object.__setattr__(self, "exchange",
                           dist.ExchangeConfig.parse(self.exchange))
        if self.H < 1:
            raise ValueError(f"H must be >= 1, got {self.H}")


@dataclass(frozen=True)
class WorkerRows:
    """All that one rank of a sharded SGD run needs of ``A``: worker
    ``rank``'s block of rows ``[rank * m_local, (rank + 1) * m_local)``
    of an (m, n) matrix (``rows``, the last block short of m_local when
    K does not divide m). A trainer built on it runs ``run_sharded`` on
    that rank only."""
    rank: int
    rows: np.ndarray
    m: int


class UniformRows:
    """The default row source: for round ``t``, ``shape[-1]`` distinct
    rows drawn uniformly from ``[0, pool)`` for each index of
    ``shape[:-1]``, from a ``torch.Generator`` on ``device`` seeded by
    ``(seed, t)`` (the ranks of uniform keys, a stable sort). A round's
    draw depends on nothing but the seed and its round number."""

    def __init__(self, pool: int, shape: tuple, seed: int,
                 device: torch.device):
        self.pool, self.shape = int(pool), tuple(int(s) for s in shape)
        if not 1 <= self.shape[-1] <= self.pool:
            raise ValueError(f"cannot draw {self.shape[-1]} distinct rows "
                             f"from {self.pool}")
        self.seed, self.device = int(seed), device

    def __call__(self, t: int) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 1_000_003 + int(t))
        keys = torch.rand(self.shape[:-1] + (self.pool,), generator=g,
                          device=self.device)
        order = torch.argsort(keys, dim=-1, stable=True)
        return order[..., :self.shape[-1]].to(torch.int32)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to f32 as a 0-dim tensor on ``like``'s device,
    filled there (a copy from the host would wait for the device)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _lr(cfg: SGDConfig, t: int, like: torch.Tensor) -> torch.Tensor:
    """``step_size / sqrt(t)``, an IEEE quotient in f32."""
    return _f32(cfg.step_size, like) / torch.sqrt(_f32(float(t), like))


def _prox_step(cfg: SGDConfig, alpha, grad, lr):
    """A gradient step and the l1 proximal step of the elastic net."""
    alpha_new = alpha - lr * grad
    thresh = lr * _f32(cfg.lam, lr) * _f32(1.0 - cfg.eta, lr)
    return torch.sign(alpha_new) * torch.clamp(
        torch.abs(alpha_new) - thresh, min=0.0)


class _SGDRound:
    """Mini-batch SGD's plug into the virtual round driver: each worker
    owns a row block, samples a local mini-batch and contributes an
    n-length partial gradient; the step-size schedule and the l1
    proximal step run on the aggregate. With ``H > 1`` the round is
    *local SGD*: each worker takes H proximal steps on a private copy
    (its partial gradient times K standing in for the full gradient) and
    the exchange carries the model delta, averaged in ``apply_update``.

    The reference's arithmetic in its order; every quotient is tensor by
    tensor (PyTorch's ``number / tensor`` multiplies by a reciprocal).

    ``live_reweight``: SGD's aggregate is a mean over workers, so under
    ``drop:`` the driver rescales it by ``K / K_live``."""

    live_reweight = True

    def __init__(self, cfg: SGDConfig, problem: GLMProblem, m_local: int,
                 batch_local: int):
        self.cfg, self.problem = cfg, problem
        self.m_local, self.batch_local = m_local, batch_local
        self.scale = m_local / batch_local

    def _partial_grad(self, data, alpha, rows):
        """``(A_s^T (A_s alpha - b_s)) * m_local / batch_local`` on each
        worker's rows ``rows (K, batch_local)``. A batch of the whole
        block is the block itself (the sum in another order), so it is
        not gathered as a copy."""
        A, b = data                       # (K, m_local, n), (K, m_local)
        if self.batch_local == self.m_local:
            A_s, b_s = A, b
        else:
            k = torch.arange(A.shape[0], device=A.device)[:, None]
            rows = rows.long()
            A_s, b_s = A[k, rows], b[k, rows]
        resid = batched_matvec(A_s, alpha) - b_s
        grad = batched_vecmat(resid, A_s)
        return grad * _f32(self.scale, grad)

    def local_step(self, data, local, alpha, rows, t):
        cfg = self.cfg
        if cfg.H == 1:
            return self._partial_grad(data, alpha, rows[:, 0]), local
        lr = _lr(cfg, t, alpha)
        K_f = _f32(float(cfg.K), alpha)
        lam_eta = _f32(cfg.lam * cfg.eta, alpha)
        alpha_loc = alpha.expand(rows.shape[0], -1)
        for h in range(cfg.H):
            g = (K_f * self._partial_grad(data, alpha_loc, rows[:, h])
                 + lam_eta * alpha_loc)
            alpha_loc = _prox_step(cfg, alpha_loc, g, lr)
        return alpha_loc - alpha, local

    def apply_update(self, alpha, total, t):
        cfg = self.cfg
        if cfg.H > 1:
            # the summed model delta: average the H-step local models
            return alpha + total / _f32(float(cfg.K), total)
        grad = total + _f32(cfg.lam * cfg.eta, alpha) * alpha
        return _prox_step(cfg, alpha, grad, _lr(cfg, t, alpha))

    def local_metric(self, data, local, alpha_new):
        A, b = data                       # zero-padded rows contribute 0
        r = batched_matvec(A, alpha_new) - b
        return 0.5 * torch.sum(r * r, dim=1)

    def finalize_metric(self, alpha_new, loss_sum):
        return loss_sum + self.problem.regularizer(alpha_new)


class MinibatchSGD:
    """MLlib-style distributed mini-batch SGD for elastic-net regression.

    ``device`` defaults to the card and raises without one; the tests
    pass ``device="cpu"``. ``row_source`` (``t -> (K, H, batch_local)``,
    rows of each worker's block) feeds ``run_workers``,
    ``global_row_source`` (``t -> (batch,)``) feeds ``run``; both
    default to :class:`UniformRows`."""

    def __init__(self, cfg: SGDConfig, A, b: np.ndarray, *,
                 device=None, row_source: Callable | None = None,
                 global_row_source: Callable | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if isinstance(A, WorkerRows):
            self.A_np, self.block = None, A
            self.m, self.n = A.m, A.rows.shape[1]
        else:
            self.A_np, self.block = np.asarray(A, np.float32), None
            self.m, self.n = self.A_np.shape
        self.b_np = np.asarray(b, np.float32)
        self.b = torch.from_numpy(self.b_np).to(self.device)
        self.problem = GLMProblem(lam=cfg.lam, eta=cfg.eta)
        self.exchange = cfg.exchange
        self.scheme = self.exchange.scheme
        self.mode = self.exchange.mode
        self.batch = max(1, int(cfg.batch_frac * self.m))
        self.m_local = -(-self.m // cfg.K)
        self.batch_local = max(1, int(round(cfg.batch_frac * self.m_local)))
        self.row_source = row_source or UniformRows(
            self.m_local, (cfg.K, cfg.H, self.batch_local), cfg.seed,
            self.device)
        self.global_row_source = global_row_source or UniformRows(
            self.m, (self.batch,), cfg.seed, self.device)
        self._dist_state = None  # (data, algo, round_fn), built lazily
        self._p_star_cache: float | None = None

    @functools.cached_property
    def A(self) -> torch.Tensor:
        """The (m, n) matrix on the device."""
        if self.A_np is None:
            raise RuntimeError(
                f"this trainer holds only worker {self.block.rank}'s rows "
                f"(WorkerRows); it runs run_sharded() on that rank")
        return torch.from_numpy(self.A_np).to(self.device)

    def worker_data(self, rank: int):
        """Worker ``rank``'s ``(1, ...)`` slice of the row partition,
        built from its own rows only: ``(A (1, m_local, n), b (1,
        m_local))``, zero-padded as the virtual driver's blocks are."""
        lo = rank * self.m_local
        hi = min(lo + self.m_local, self.m)
        if self.block is not None:
            if self.block.rank != rank:
                raise ValueError(f"this trainer holds worker "
                                 f"{self.block.rank}'s rows, not worker "
                                 f"{rank}'s")
            rows = self.block.rows
        else:
            rows = self.A_np[lo:hi]
        A = np.zeros((1, self.m_local, self.n), np.float32)
        A[0, :max(hi - lo, 0)] = rows
        b = np.zeros((1, self.m_local), np.float32)
        b[0, :max(hi - lo, 0)] = self.b_np[lo:hi]
        return (torch.from_numpy(A).to(self.device),
                torch.from_numpy(b).to(self.device))

    def _distributed(self):
        """The row partition and the round function, built on first use:
        the legacy ``run()`` must not pay for a second, padded copy of A
        it never touches. K zero-padded row blocks ``(K, m_local, n)``:
        padded rows are zero in A and b, so they add 0 to the gradient
        and the loss."""
        if self._dist_state is None:
            cfg, m_local = self.cfg, self.m_local
            A_pad = torch.zeros((cfg.K * m_local, self.n), dtype=torch.float32,
                                device=self.device)
            A_pad[: self.m] = self.A
            b_pad = torch.zeros((cfg.K * m_local,), dtype=torch.float32,
                                device=self.device)
            b_pad[: self.m] = self.b
            data = (A_pad.view(cfg.K, m_local, self.n),
                    b_pad.view(cfg.K, m_local))
            algo = _SGDRound(cfg, self.problem, m_local, self.batch_local)
            round_fn = dist.build_virtual_round(algo, self.exchange, data,
                                                K=cfg.K)
            self._dist_state = (data, algo, round_fn)
        return self._dist_state

    @property
    def _data(self):
        return self._distributed()[0]

    @property
    def _algo(self):
        return self._distributed()[1]

    @property
    def _round_fn(self):
        return self._distributed()[2]

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
        """``(local, shared)`` for the virtual driver: SGD keeps no
        per-worker state, so ``local`` is ``(K, 0)`` (paired with the
        ``(K, n)`` residual under an ``ef:`` codec); ``shared`` is alpha
        ``(n,)``, paired with the pending queue ``(k, n)`` under
        ``stale``."""
        local = torch.zeros((self.cfg.K, 0), dtype=torch.float32,
                            device=self.device)
        local = dist.wrap_local_state(self.exchange, local, self.n,
                                      self.cfg.K)
        alpha = torch.zeros((self.n,), dtype=torch.float32,
                            device=self.device)
        return local, dist.init_exchange_state(self.exchange, alpha)

    def with_H(self, H: int) -> "MinibatchSGD":
        """A fresh trainer on the same problem and device with the
        local-step count moved (and the default row sources)."""
        return type(self)(dataclasses.replace(self.cfg, H=int(H)),
                          self.A_np if self.block is None else self.block,
                          self.b_np, device=self.device)

    def comm_bytes_per_round(self, t: int | None = None) -> int:
        """Modelled bytes on the wire per round on the exchange's
        backend: the n-length gradient (or model delta) all-reduce across
        K workers, sized to
        the codec's payload under ``compressed``, f32 otherwise. ``t``
        asks for one 1-based round of the membership schedule (dropped
        workers ship nothing; ``None``: all K live)."""
        K_live = (None if t is None
                  else self.exchange.membership.live_count(t, self.cfg.K))
        return self.scheme.bytes_per_round(self.n, self.cfg.K, K_live=K_live,
                                           backend=self.exchange.backend)

    def _history(self, p_star, p_zero) -> History:
        return History(p_star=self.p_star if p_star is None else p_star,
                       p_zero=self.p_zero if p_zero is None else p_zero)

    # -- the legacy single-device loop (global row sampling) -------------
    def _global_step(self, alpha, t):
        cfg, A, b = self.cfg, self.A, self.b
        full_f32_matmul()
        if self.batch == self.m:          # the whole matrix, not a copy
            A_s, b_s = A, b
        else:
            rows = self.global_row_source(t).long()
            A_s, b_s = A[rows], b[rows]
        resid = A_s @ alpha - b_s
        grad = ((A_s.T @ resid) * _f32(self.m / self.batch, alpha)
                + _f32(cfg.lam * cfg.eta, alpha) * alpha)
        return _prox_step(cfg, alpha, grad, _lr(cfg, t, alpha))

    def run(self, rounds: int, p_star: float | None = None,
            p_zero: float | None = None, record_every: int = 10,
            target_eps: float | None = None) -> History:
        """The legacy loop: one gradient step on ``batch`` global rows a
        round, the primal evaluated only at a recorded round."""
        if self.mode.stale:
            # the legacy loop has no exchange to delay; running it
            # synchronously would mislabel the trajectory
            raise ValueError(
                "exchange mode 'stale' has no meaning for the legacy "
                "single-device run(); use run_workers()")
        def step(alpha, t):
            alpha = self._global_step(alpha, t)
            return alpha, lambda: primal_objective(self.problem, self.A,
                                                   self.b, alpha)

        with spans.span("solve"):
            hist = self._history(p_star, p_zero)
            alpha, _ = record_rounds(
                hist, step, torch.zeros((self.n,), dtype=torch.float32,
                                        device=self.device),
                rounds, record_every, target_eps)
            with spans.span("finish", sync=True):
                self.alpha_final = alpha.cpu().numpy()
        return hist

    # -- the virtual driver (row-partitioned, per-worker sampling) -------
    def run_workers(self, rounds: int, record_every: int = 10,
                    target_eps: float | None = None,
                    p_star: float | None = None,
                    p_zero: float | None = None) -> History:
        """K virtual workers, batched into each call. Under ``stale`` the
        recorded primal is one round behind, and the pending aggregates
        are absorbed after the last round, recorded or not."""
        with spans.span("solve"):
            hist = self._history(p_star, p_zero)
            round_fn = self._round_fn
            (_, alpha), last_t = record_rounds(
                hist, round_step(round_fn, self.row_source),
                self.init_state(), rounds, record_every, target_eps)
            with spans.span("finish", sync=True):
                self.alpha_final = dist.finish_run(round_fn, alpha,
                                                   last_t).cpu().numpy()
        return hist

    def build_sharded_round(self, group=None) -> Callable:
        """This rank's round on the sharded driver, over ``group``
        (``None``: the default process group, one rank per worker), on
        the rank's own row block."""
        fabric = dist.open_fabric(group, self.cfg.K)
        algo = _SGDRound(self.cfg, self.problem, self.m_local,
                         self.batch_local)
        return dist.build_sharded_round(algo, self.exchange,
                                        self.worker_data(fabric.rank),
                                        group=fabric, K=self.cfg.K)

    def run_sharded(self, rounds: int, group=None, record_every: int = 10,
                    target_eps: float | None = None,
                    p_star: float | None = None,
                    p_zero: float | None = None) -> History:
        """:meth:`run_workers` with one worker per rank of ``group``
        (``None``: the default process group, whose size must be K;
        start the ranks with ``repro_torch.launch.dist``). ``p_star`` is
        computed once, on rank 0, unless given. Every rank records the
        same History and holds the same ``alpha_final``."""
        with spans.span("solve"):
            round_fn = self.build_sharded_round(group)
            fabric = round_fn.fabric
            if p_star is None:
                p_star = from_rank0(fabric, lambda: self.p_star, self.device)
            hist = self._history(p_star, p_zero)
            (_, alpha), last_t = record_rounds(
                hist, round_step(round_fn, self.row_source),
                dist.place_state(fabric.rank, *self.init_state()), rounds,
                record_every, target_eps)
            with spans.span("finish", sync=True):
                self.alpha_final = dist.finish_run(round_fn, alpha,
                                                   last_t).cpu().numpy()
        return hist

    def objective_of(self, alpha: np.ndarray) -> float:
        return float(primal_objective(
            self.problem, self.A, self.b,
            torch.as_tensor(np.asarray(alpha, np.float32),
                            device=self.device)))
