"""The exchange-cell matrix and each cell's recorded run (the port of
``repro.analysis.cells``).

ONE place defines which (algorithm x exchange spec) cells exist: the
36-cell transport x codec x mode matrix plus the regime, backend and
codec cells, the reference's lists. The reference lowers each cell's
sharded round to optimized HLO and lifts its collective graph; the port
has no compiled graph, so it runs the cell instead: :func:`run_cells`
drives each cell's ``run_sharded`` for a few rounds on one K-rank
``torch.distributed`` group under ``comm.collectives.recording()`` and
returns every rank's log of calls into the group. A :class:`CellContext`
holds those logs, the cell's trainer (for ``comm_bytes_per_round()``),
the resolved exchange, K and the update length: everything a rule
reads.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field, replace

from repro_torch.core.distributed import EXCHANGE_MODES, ExchangeConfig

# every transport x codec cell: the exact transports compose only with
# the f32 identity (validated by CommScheme), `compressed` with all
# three codecs
SCHEMES = ("persistent", "spark_faithful", "compressed:f32",
           "compressed:int8", "compressed:int4", "reduce_scatter")
MODES = EXCHANGE_MODES
ALGORITHMS = ("cocoa", "minibatch_scd", "minibatch_sgd")

# Regime cells (full ExchangeConfig specs) on top of the matrix:
# straggler jitter (time-only), bounded staleness k=2, and elastic
# membership (drop:w@d-r: the modelled traffic shrinks with the live
# count while every rank still makes the same calls).
REGIME_CELLS = (
    ("cocoa", "persistent/straggler:mix(p=0.25,slow=8)"),
    ("cocoa", "persistent/stale:k=2"),
    ("cocoa", "persistent/drop:1@2-4"),
    ("minibatch_sgd", "compressed:int8/drop:1@2-4"),
)

# Codec cells beyond the matrix: the int2/topk base codecs and the
# stateful ef: wrapper on every algorithm, plus ef: composed with the
# staleness and elastic-membership regimes and the ring backend.
# topk keeps r=0.125 at this scale: k = ceil(0.125*96) = 12 of the
# m = 96 entries.
CODEC_CELLS = (
    ("cocoa", "compressed:int2"),
    ("cocoa", "compressed:topk(r=0.125)"),
    ("cocoa", "compressed:ef:int4"),
    ("cocoa", "compressed:ef:int2"),
    ("cocoa", "compressed:ef:topk(r=0.125)"),
    ("minibatch_scd", "compressed:ef:int4"),
    ("minibatch_sgd", "compressed:ef:int4"),
    ("cocoa", "compressed:ef:int4/stale:k=2"),
    ("cocoa", "compressed:ef:int4/drop:1@2-4"),
    ("cocoa", "compressed:ef:int4/ring"),
)

# Collective-backend cells: every transport on the explicit neighbour
# ring, plus a stale ring.
BACKEND_CELLS = (
    ("cocoa", "persistent/ring"),
    ("cocoa", "compressed:int4/ring"),
    ("minibatch_scd", "reduce_scatter/ring"),
    ("minibatch_sgd", "spark_faithful/ring"),
    ("cocoa", "persistent/ring/stale:k=2"),
)

# The small problem every analysis cell runs on, the reference's
# (benchmarks/common.py's smoke tier: m=96, n=256, K=4).
PROBLEM = {"m": 96, "n": 256, "K": 4, "density": 0.2, "zipf_a": 1.1,
           "lam": 1.0, "sgd_step": 0.1, "data_seed": 42,
           "trainer_seed": 0}

# rounds a cell runs: round 2 is the first the drop: cells' worker sits
# out (drop:1@2-4), and a stale cell's queue is full from round 3
ROUNDS = 4


@dataclass(frozen=True)
class Cell:
    """One analyzable (algorithm, full exchange spec) point."""
    algorithm: str
    spec: str

    @property
    def id(self) -> str:
        return f"{self.algorithm}={self.spec}"


def matrix_cells() -> tuple[Cell, ...]:
    """The 36-cell algorithm x (transport x codec) x mode matrix."""
    out = []
    for algo in ALGORITHMS:
        for scheme in SCHEMES:
            for mode in MODES:
                spec = scheme if mode == "sync" else f"{scheme}/{mode}"
                out.append(Cell(algo, spec))
    return tuple(out)


def regime_cells() -> tuple[Cell, ...]:
    return tuple(Cell(a, s) for a, s in REGIME_CELLS)


def backend_cells() -> tuple[Cell, ...]:
    return tuple(Cell(a, s) for a, s in BACKEND_CELLS)


def codec_cells() -> tuple[Cell, ...]:
    return tuple(Cell(a, s) for a, s in CODEC_CELLS)


def all_cells() -> tuple[Cell, ...]:
    return (matrix_cells() + regime_cells() + backend_cells()
            + codec_cells())


def resolve_cells(selector: str) -> tuple[Cell, ...]:
    """CLI cell selector: ``all`` | ``matrix`` | ``regime`` | ``backend``
    or ``codec``, or a comma-separated list of ``algo=spec`` entries."""
    named = {"all": all_cells, "matrix": matrix_cells,
             "regime": regime_cells, "backend": backend_cells,
             "codec": codec_cells}
    if selector in named:
        return named[selector]()
    out = []
    for entry in selector.split(","):
        algo, _, spec = entry.partition("=")
        if not spec or algo not in ALGORITHMS:
            raise ValueError(
                f"bad cell {entry!r}: expected algo=spec with algo in "
                f"{ALGORITHMS} (or one of {sorted(named)})")
        ExchangeConfig.parse(spec)  # validate early
        out.append(Cell(algo, spec))
    return tuple(out)


def problem():
    """(A, b) of the small analysis problem."""
    from repro_torch.data import make_glm_data
    p = PROBLEM
    A, b, _ = make_glm_data(m=p["m"], n=p["n"], density=p["density"],
                            zipf_a=p["zipf_a"], seed=p["data_seed"])
    return A, b


def build_trainer(cell: Cell, K: int | None = None, *, device=None,
                  data=None):
    """The cell's trainer on the analysis problem (``data``: its (A, b),
    made anew when not given), on ``device`` (the card by default)."""
    from repro_torch.core import (CoCoAConfig, CoCoATrainer, MinibatchSCD,
                                  MinibatchSGD, SGDConfig)
    p = PROBLEM
    K = K or p["K"]
    A, b = problem() if data is None else data
    if cell.algorithm == "minibatch_sgd":
        return MinibatchSGD(
            SGDConfig(batch_frac=1.0, step_size=p["sgd_step"], lam=p["lam"],
                      K=K, seed=p["trainer_seed"], exchange=cell.spec), A, b,
            device=device)
    n_local = -(p["n"] // -K)
    cfg = CoCoAConfig(K=K, H=n_local, lam=p["lam"], solver="scd_ref",
                      exchange=cell.spec, seed=p["trainer_seed"])
    cls = MinibatchSCD if cell.algorithm == "minibatch_scd" \
        else CoCoATrainer
    return cls(cfg, A, b, device=device)


def cell_logs(rank: int, world: int, device, specs, rounds: int) -> list:
    """In a rank of a ``world``-rank group: each ``(algorithm, spec)`` of
    ``specs`` run by its trainer's ``run_sharded`` for ``rounds`` rounds
    under ``recording()``; returns this rank's log of each."""
    from repro_torch.comm.collectives import recording
    data = problem()
    out = []
    for algo, spec in specs:
        tr = build_trainer(Cell(algo, spec), world, device=device, data=data)
        with recording() as log:
            tr.run_sharded(rounds, record_every=1)
        out.append(list(log))
    return out


def run_cells(cells, K: int | None = None, *, rounds: int = ROUNDS,
              device=None) -> list:
    """Every cell of ``cells`` run on ONE group of K gloo ranks (one
    process each, ``launch.dist.spawn``, on ``device``: the card by
    default); returns, a cell each, the list of the K ranks' logs."""
    from repro_torch.launch.dist import spawn
    K = K or PROBLEM["K"]
    specs = [(c.algorithm, c.spec) for c in cells]
    with tempfile.TemporaryDirectory() as d:
        ranks = spawn(K, cell_logs, device=device,
                      init_file=os.path.join(d, "init"),
                      args=(specs, rounds))
    return [list(logs) for logs in zip(*ranks)]


def run_cell(cell: Cell, K: int | None = None, rounds: int = ROUNDS, *,
             device=None) -> list:
    """One cell's run on a K-rank group: every rank's log."""
    return run_cells([cell], K, rounds=rounds, device=device)[0]


def full_membership_spec(exchange) -> str:
    """The spec of ``exchange`` without its ``drop:`` schedule."""
    from repro_torch.core.distributed import MembershipSchedule
    return replace(exchange, membership=MembershipSchedule()).spec


@dataclass
class CellContext:
    """Everything a cell-scoped lint rule gets to look at: the K ranks'
    recorded logs of the cell's run (``logs[r]``, rank r's calls in
    order, each with its round)."""
    cell: Cell
    trainer: object
    logs: list
    K: int
    exchange: object            # resolved ExchangeConfig
    update_len: int             # the exchanged update-vector length
    device: object = None
    # sibling runs by spec (same algorithm): the full-membership run a
    # drop: cell is held to
    variants: dict = field(default_factory=dict)

    @property
    def id(self) -> str:
        return self.cell.id

    def run_variant(self, spec: str) -> "CellContext":
        """The sibling cell (same algorithm and K, another spec), from
        ``variants`` when it ran in the same group, else run now."""
        cell = replace(self.cell, spec=spec)
        logs = self.variants.get(spec)
        if logs is None:
            logs = run_cell(cell, self.K, device=self.device)
        return context(cell, logs, self.K, device=self.device)


def context(cell: Cell, logs: list, K: int, *, device=None, trainer=None,
            variants=None) -> CellContext:
    """The :class:`CellContext` of ``cell``'s recorded ``logs``; the
    trainer is built anew on ``device`` unless given."""
    tr = trainer or build_trainer(cell, K, device=device)
    # the exchanged update vector: SGD averages the n-length gradient,
    # the CoCoA family exchanges the m-length shared vector
    update_len = tr.n if cell.algorithm == "minibatch_sgd" else tr.m
    return CellContext(cell=cell, trainer=tr, logs=logs, K=K,
                       exchange=tr.exchange, update_len=update_len,
                       device=device, variants=dict(variants or {}))


def analyze_cells(cells, K: int | None = None, *, rounds: int = ROUNDS,
                  device=None, extra=()) -> tuple[list, list]:
    """Every cell run on one K-rank group, together with each ``drop:``
    cell's full-membership sibling and the ``extra`` cells; returns (the
    :class:`CellContext` of each cell, the ranks' logs of each ``extra``
    cell)."""
    K = K or PROBLEM["K"]
    siblings = []
    for c in cells:
        ex = ExchangeConfig.parse(c.spec)
        if not ex.membership.empty:
            full = replace(c, spec=full_membership_spec(ex))
            if full not in cells and full not in siblings:
                siblings.append(full)
    runs = run_cells(list(cells) + siblings + list(extra), K, rounds=rounds,
                     device=device)
    by_cell = dict(zip(list(cells) + siblings, runs))
    ctxs = []
    for c in cells:
        variants = {v.spec: by_cell[v] for v in by_cell
                    if v.algorithm == c.algorithm}
        ctxs.append(context(c, by_cell[c], K, device=device,
                            variants=variants))
    return ctxs, runs[len(cells) + len(siblings):]
