"""The CoCoA traffic generator: solves back to back from alpha = 0 to a
target suboptimality, each on the program's own coordinate draw
(``UniformIndices``) seeded for that solve (``yardstick.streams``).

Traffic keys: ``H`` (local steps a round), ``exchange``,
``record_every``, ``eps`` (the target), ``expected_rounds`` (a solve
that has not reached ``eps`` after ``max_rounds_factor`` times as many
rounds fails), ``trace_solves`` (the solves a traced run profiles, the
first of the window), ``check_solves`` solves drawn from the seed among
the ``check_among`` that follow the traced ones, whose every round's
state the window keeps, and ``check_rounds`` of each that the reference
follows: the first, the last, and the rest drawn from the seed."""
from __future__ import annotations

import gc
import random
import time

import numpy as np

from cardbench.harness.core import Run
from cardbench.yardstick.glm_data import make_glm_data
from cardbench.yardstick.streams import UniformDraw, mix, solve_seed

STAGE_BYTES = 256 << 20     # the pinned buffer the matrix crosses through


def data(cfg: dict, device):
    d = cfg["data"]
    return make_glm_data(d["examples"], d["features"], density=d["density"],
                         zipf_a=d["zipf_a"], noise=d["noise"],
                         truth_density=d["truth_density"], seed=d["seed"],
                         device=device)


def to_host(x) -> np.ndarray:
    """``x`` as a host array, through a pinned buffer in blocks of rows."""
    import torch
    if x.device.type == "cpu":
        return x.numpy()
    out = np.empty(tuple(x.shape), np.float32)
    host = torch.from_numpy(out).view(x.shape[0], -1)
    src = x.view(x.shape[0], -1)
    rows = max(1, STAGE_BYTES // (4 * src.shape[1]))
    stage = torch.empty((rows, src.shape[1]), dtype=x.dtype, pin_memory=True)
    for s in range(0, src.shape[0], rows):
        e = min(s + rows, src.shape[0])
        stage[:e - s].copy_(src[s:e])
        host[s:e].copy_(stage[:e - s])
    return out


def trainer_of(cfg: dict, traffic: dict, A, b, device):
    """The program's trainer over the benchmark's data (handed in as
    host arrays, the form the trainer takes)."""
    from repro_torch.core.cocoa import CoCoAConfig, CoCoATrainer
    p, wk = cfg["problem"], cfg["workers"]
    cc = CoCoAConfig(K=wk["K"], H=traffic["H"], lam=p["lam"], eta=p["eta"],
                     sigma=p["sigma"], solver=wk["solver"],
                     exchange=traffic["exchange"],
                     partitioner=wk["partitioner"])
    return CoCoATrainer(cc, to_host(A), to_host(b), device=device)


class Recorder:
    """The program's round function, keeping a copy of the state each
    round hands on (``(alpha (K, n_pad), w (m,))``)."""

    def __init__(self, round_fn):
        self.fn, self.states = round_fn, []

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __call__(self, local, shared, idx, t=1):
        out = self.fn(local, shared, idx, t)
        self.states.append((out[0].clone(), out[1].clone()))
        return out


def one_solve(trainer, traffic: dict, seed: int, i: int, device,
              record: bool = False) -> dict:
    """Solve ``i`` of the run: its clocks, what the trainer recorded and,
    with ``record``, every round's state."""
    from repro_torch.core.cocoa import UniformIndices
    trainer.index_source = UniformIndices(trainer.part.sizes, traffic["H"],
                                          solve_seed(seed, i), device)
    real = trainer._round_fn
    rec = Recorder(real) if record else None
    if record:
        trainer._round_fn = rec
    max_rounds = traffic["max_rounds_factor"] * traffic["expected_rounds"]
    t0 = time.perf_counter()
    try:
        hist = trainer.run(max_rounds, record_every=traffic["record_every"],
                           target_eps=traffic["eps"])
    except Exception as e:        # a solve that raises fails
        return dict(kind="solve", i=i, t0=t0, t1=time.perf_counter(), ok=False,
                    error=repr(e)[:500])
    finally:
        trainer._round_fn = real
    t1 = time.perf_counter()
    reached = hist.rounds_to(traffic["eps"])
    return dict(kind="solve", i=i, t0=t0, t1=t1, ok=reached is not None,
                rounds=hist.rounds[-1] if hist.rounds else 0,
                rounds_to_eps=reached, seconds=sum(hist.seconds),
                span=sum(hist.span), primal=list(hist.primal),
                recorded=list(hist.rounds), p_star=hist.p_star,
                states=rec.states if record else None)


def checked_solves(traffic: dict, seed: int, first: int) -> list:
    """The solves whose states the window keeps: ``check_solves`` drawn
    from the seed among the ``check_among`` from solve ``first`` on."""
    pool = range(first, first + traffic["check_among"])
    return sorted(random.Random(mix(seed, 7)).sample(
        list(pool), min(traffic["check_solves"], len(pool))))


def run(ctx) -> Run:
    import torch
    from cardbench.harness.trace import Session

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    out = Run(config=cfg, traffic=tr)
    A, b = data(cfg, dev)
    trainer = trainer_of(cfg, tr, A, b, dev)
    del A, b
    # warm-up: a whole solve on a stream the window does not use builds
    # the device data, P* and every kernel the window launches
    one_solve(trainer, tr, ctx.seed, 0, dev)
    if dev != "cpu":
        torch.cuda.synchronize()
    out.setup_s = time.perf_counter() - ctx.t_start

    n_traced = tr["trace_solves"] if ctx.trace else 0
    checked = checked_solves(tr, ctx.seed, n_traced + 1)
    w0 = time.perf_counter()
    i = 1
    while True:
        if i == 1 and n_traced:
            with Session() as trace:
                for j in range(1, n_traced + 1):
                    out.ops.append(one_solve(trainer, tr, ctx.seed, j, dev))
            out.trace = trace
            i = n_traced + 1
        else:
            out.ops.append(one_solve(trainer, tr, ctx.seed, i, dev,
                                     record=i in checked))
            i += 1
        # the window runs past the solves it keeps for the check (and
        # past one untraced solve, for the trainer's own clock)
        if time.perf_counter() - w0 >= ctx.seconds and i > checked[-1]:
            break
    out.window = (w0, out.ops[-1]["t1"])
    out.info = dict(K=trainer.cfg.K, H=tr["H"], m=trainer.m,
                    n_pad=trainer.part.n_padded, traced_solves=n_traced,
                    sizes=[int(s) for s in trainer.part.sizes],
                    seed=ctx.seed, device=dev)
    if dev != "cpu":
        torch.cuda.synchronize()
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()
    owned = [np.asarray(o) for o in trainer.part.owned]
    n_pad = trainer.part.n_padded
    del trainer
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    out.checks = check(ctx, out.ops, owned, n_pad)
    return out


def check(ctx, ops: list, owned: list, n_pad: int) -> list:
    """The reference, from data, partition and P* it works out again,
    judges what the window produced. Returns the compared numbers beside
    their limits: ``partition`` (1 where a worker's columns differ);
    ``pstar`` (the gap of the program's P*, over P(0) - P*); and, over
    the checked rounds of the kept solves, each followed from the state
    the program handed on the round before: ``alpha`` (the gap of the
    round's moves, over the reference's), ``w`` (the median gap of the
    residual's change, over the median of the reference's) and
    ``primal`` (of the round's recorded objective, over P(0) - P*)."""
    import torch
    from cardbench.reference import cocoa as ref
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    p, K = cfg["problem"], cfg["workers"]["K"]
    sigma = p["sigma"] or K
    A, b = data(cfg, dev)
    A_T = A.T.contiguous()
    del A
    part = ref.balanced_partition(A_T, K)
    worst = dict(partition=0.0, pstar=0.0, alpha=0.0, w=0.0, primal=0.0)
    if [o.tolist() for o in owned] != [o.tolist() for o in part.owned]:
        worst = dict.fromkeys(worst, float("inf"))
        worst["partition"] = 1.0
        return [(name, worst[name], lim) for name, lim in tr["limits"].items()]
    p_star = ref.ridge_optimum(A_T, b, p["lam"])
    b64 = b.double()
    p_span = float(0.5 * torch.dot(b64, b64)) - p_star
    worst["pstar"] = max((abs(op["p_star"] - p_star) / p_span
                          for op in ops if "p_star" in op),
                         default=float("inf"))
    kept = [op for op in ops if op.get("states")]
    if not kept:                  # nothing to judge
        worst.update(alpha=float("inf"), w=float("inf"),
                     primal=float("inf"))
    alpha0 = torch.zeros((K, n_pad), dtype=torch.float32, device=dev)
    for op in kept:
        draw = UniformDraw(part.sizes, tr["H"], solve_seed(ctx.seed, op["i"]),
                           dev)
        states = op["states"]
        rng = random.Random(mix(ctx.seed, op["i"], 11))
        middle = list(range(2, len(states)))
        rounds = sorted({1, len(states)} | set(rng.sample(
            middle, min(len(middle), tr["check_rounds"] - 2))))
        recorded = dict(zip(op["recorded"], op["primal"]))
        for t in rounds:
            alpha_in, w_in = (alpha0, -b) if t == 1 else states[t - 2]
            alpha_out, w_out = states[t - 1]
            s = ref.round_from(A_T, part, alpha_in, w_in, draw(t),
                               lam=p["lam"], sigma=sigma,
                               exchange=tr["exchange"])
            moved = alpha_out.double() - alpha_in.double()
            worst["alpha"] = max(worst["alpha"], float(
                (moved - s.dalpha).norm() / s.dalpha.norm()))
            # medians: an int8 code a step apart, where rounding moved
            # an update across a step, is no fault and moves no median
            change = w_out.double() - w_in.double()
            worst["w"] = max(worst["w"], float(
                (change - s.total).abs().median()
                / s.total.abs().median()))
            if t in recorded:
                want = ref.primal(alpha_out, w_out, p["lam"])
                worst["primal"] = max(worst["primal"],
                                      abs(recorded[t] - want) / p_span)
    return [(name, worst[name], lim) for name, lim in tr["limits"].items()]


def control(ctx) -> Run:
    """The control: the reference computed in TF32 in the program's place
    (a P* and ``check_solves`` solves to the target, every round's state
    kept), judged by :func:`check` as the program's window is; the
    returned run's ``correct`` has to come out false."""
    import torch
    from cardbench.reference import cocoa as ref
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    p, K = cfg["problem"], cfg["workers"]["K"]
    sigma = p["sigma"] or K
    A, b = data(cfg, dev)
    A_T = A.T.contiguous()
    del A
    part = ref.balanced_partition(A_T, K)
    n_pad = max(part.sizes)
    p_star = ref.ridge_optimum(A_T, b, p["lam"], tf32_on=True)
    p_zero = ref.primal(torch.zeros(1, device=dev), -b, p["lam"], True)
    max_rounds = tr["max_rounds_factor"] * tr["expected_rounds"]
    out = Run(config=cfg, traffic=tr)
    for i in checked_solves(tr, ctx.seed, 1):
        draw = UniformDraw(part.sizes, tr["H"], solve_seed(ctx.seed, i), dev)
        alpha = torch.zeros((K, n_pad), dtype=torch.float32, device=dev)
        w = -b.clone()
        states, primal = [], []
        for t in range(1, max_rounds + 1):
            s = ref.round_from(A_T, part, alpha, w, draw(t), lam=p["lam"],
                               sigma=sigma, exchange=tr["exchange"],
                               tf32_on=True)
            alpha, w = alpha + s.dalpha, w + s.total
            states.append((alpha, w))
            primal.append(ref.primal(alpha, w, p["lam"], True))
            if (primal[-1] - p_star) / (p_zero - p_star) <= tr["eps"]:
                break
        out.ops.append(dict(kind="solve", i=i, ok=True, rounds=len(states),
                            primal=primal,
                            recorded=list(range(1, len(states) + 1)),
                            p_star=p_star, states=states))
    owned = [o.cpu().numpy() for o in part.owned]
    del A_T, b, part
    gc.collect()
    out.checks = check(ctx, out.ops, owned, n_pad)
    return out
