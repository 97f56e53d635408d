"""The program's own spans (``repro_torch.utils.spans``) as the span
metrics read them: the log the program kept while the traced window's
profiler session ran, grouped by solve and round, and the traced
window's idle time put down to the innermost span covering it.

A program without the spans gives no log, and every reader returns
nothing.

    python3 cardbench/harness/spans.py --workload <name> --seed <n>
    python3 cardbench/harness/spans.py --workload <a> <b> --seed <n> --cost 8

prints one JSON line: with one workload, a traced run of it (the
``--trace 1`` run's window, cut to ``--seconds``) and what its spans
read against its device trace; with ``--cost``, that many solves a cell,
each run with ``spans.recording()`` on and again with it off, in turns,
without a profiler, and each side's time a round."""
from __future__ import annotations

import bisect
import json
import os
import sys
import time

if __package__ in (None, ""):
    _ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

# a round's device spans, in the order the round runs them
ROUND_PARTS = ("draw", "local_step", "exchange", "apply", "metric")


def log_of(run):
    """The span log of ``run``'s traced solves (``None`` for an untraced
    run, or a program that keeps none)."""
    if run.trace is None:
        return None
    try:
        from repro_torch.utils.spans import profiled
    except ImportError:
        return None
    log = profiled()
    return log if log is not None and log.named("round") else None


def rounds_of(log) -> list:
    """``[(round span, {child name: span})]``, in the order they ran."""
    kids: dict = {}
    for s in log.spans:
        if s.parent is not None:
            kids.setdefault(s.parent, {})[s.name] = s
    return [(s, kids.get(s.index, {})) for s in log.spans
            if s.name == "round"]


def device_ms(log, names) -> list | None:
    """Each round's device ms in its ``names`` children, summed; ``None``
    where a round lacks one or a span has no device time (the CPU)."""
    out = []
    for _, kids in rounds_of(log):
        ms = [kids[n].device_ms if n in kids else None for n in names]
        if None in ms:
            return None
        out.append(sum(ms))
    return out or None


def overhead_ms(log) -> list | None:
    """Each round's host wall less the device ms of its device spans:
    the time the round spends on neither worker nor master work."""
    dev = device_ms(log, ROUND_PARTS)
    if dev is None:
        return None
    return [r.host_ms - d for (r, _), d in zip(rounds_of(log), dev)]


def solve_tail_ms(log) -> list | None:
    """Each solve's host wall less its rounds' (its set-up and finish)."""
    inside: dict = {}
    for r, _ in rounds_of(log):
        inside[r.parent] = inside.get(r.parent, 0.0) + r.host_ms
    out = [s.host_ms - inside[s.index] for s in log.named("solve")
           if s.index in inside]
    return out or None


def mean(xs) -> float | None:
    return sum(xs) / len(xs) if xs else None


def placed(log, trace) -> list:
    """``[(start us, end us, depth, name)]``: every span of the log on
    the profiler's clock, each by the offset of its own round's anchor
    (a span outside a round: the last round before it, or the first);
    ``[]`` without anchors."""
    from repro_torch.utils.spans import anchor_offsets
    offs = anchor_offsets(log, trace.host)
    if not offs:
        return []
    anchored = sorted(offs)
    depth, out = {}, []
    for s in log.spans:
        depth[s.index] = 0 if s.parent is None else depth[s.parent] + 1
        r = s.index
        while r is not None and r not in offs:
            r = log.spans[r].parent
        if r is None:
            i = bisect.bisect_right(anchored, s.index)
            r = anchored[max(i - 1, 0)]
        off = offs[r][0]
        out.append((s.start_ns / 1e3 + off, s.end_ns / 1e3 + off,
                    depth[s.index], s.name))
    return out


def idle_by_span(log, trace) -> dict:
    """``{span name: seconds}``: each gap between kernels in the traced
    window, cut where the spans placed on the profiler's clock begin and
    end, each piece put down to the innermost span covering it
    (``"(no span)"`` where none does)."""
    spans = sorted(placed(log, trace))
    starts = [s[0] for s in spans]
    longest = max((e - s for s, e, _, _ in spans), default=0.0)
    iv = sorted((s, e) for _, s, e in trace.kernels)
    gaps, end = [], trace.t0_us
    for s, e in iv:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if trace.t1_us > end:
        gaps.append((end, trace.t1_us))
    out: dict = {}
    for gs, ge in gaps:
        lo = bisect.bisect_left(starts, gs - longest)
        hit = [sp for sp in spans[lo:bisect.bisect_left(starts, ge)]
               if sp[1] > gs]
        cuts = sorted({gs, ge} | {x for sp in hit for x in sp[:2]
                                  if gs < x < ge})
        for a, b in zip(cuts, cuts[1:]):
            cover = [sp for sp in hit if sp[0] <= a and sp[1] >= b]
            name = max(cover, key=lambda sp: sp[2])[3] if cover \
                else "(no span)"
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def traced(args) -> dict:
    """A traced run of one cell and what its spans read against its
    device trace."""
    import torch
    from cardbench.harness import core
    from cardbench.harness.names import k1
    from repro_torch.utils.spans import ANCHOR, anchor_offsets
    bench = core.spec()
    wl = core.workload(bench, args.workload[0])
    tr = core.traffic(wl["traffic"])
    ctx = core.Context(wl, core.config(wl["config"]), tr, args.seed,
                       args.seconds, True, args.device, time.perf_counter())
    run = core.generator(tr["kind"]).run(ctx)
    trace, log = run.trace, log_of(run)
    metrics = {m["name"]: core.reader(m["name"]).read(run)
               for m in core.metrics_of(bench, wl["name"], True)}
    rounds = rounds_of(log)
    worker = device_ms(log, ("local_step",))
    k1_us, k1_n = trace.kernel_us(k1)
    names = set(ROUND_PARTS) | {"solve", "round", "read_back", "finish"}
    offs = anchor_offsets(log, trace.host)
    return dict(
        workload=wl["name"], seed=args.seed, correct=run.correct,
        device=torch.cuda.get_device_name(0) if args.device == "cuda"
        else "cpu", metrics=metrics, rounds=len(rounds),
        k1_ms_per_round=k1_us / 1e3 / len(rounds), k1_launches=k1_n,
        worker_over_k1=sum(worker) / (k1_us / 1e3) if worker and k1_us
        else None,
        solves_s=sum(s.host_ms for s in log.named("solve")) / 1e3,
        window_s=trace.window_s, busy_s=trace.busy_s,
        anchors=len(offs), anchor_err_us_max=max(e for _, e in offs.values()),
        span_names_on_device=sorted({n for n, _, _ in trace.kernels
                                     if n in names or ANCHOR in n}),
        idle_s=trace.window_s - trace.busy_s,
        idle_by_span=idle_by_span(log, trace))


def cost(args) -> dict:
    """``--cost`` pairs of one solve each a cell, run once with the spans
    recording and once without, in turns (on, off; off, on; ...), no
    profiler: each side's round ms (History's clock) and the ratio of
    each pair's."""
    import contextlib
    import statistics

    import torch
    from cardbench.harness import core
    from repro_torch.utils import spans
    bench = core.spec()
    cells = [core.workload(bench, w) for w in args.workload]
    cfg = core.config(cells[0]["config"])
    drv = core.generator(core.traffic(cells[0]["traffic"])["kind"])
    A, b = drv.data(cfg, args.device)
    base = drv.trainer_of(cfg, core.traffic(cells[0]["traffic"]), A, b,
                          args.device)
    del A, b
    out = {}
    for wl in cells:
        tr = core.traffic(wl["traffic"])
        trainer = base.with_H(tr["H"])
        drv.one_solve(trainer, tr, args.seed, 0, args.device)
        side = {True: [], False: []}
        for i in range(1, args.cost + 1):
            for on in ((True, False) if i % 2 else (False, True)):
                with spans.recording() if on else contextlib.nullcontext():
                    op = drv.one_solve(trainer, tr, args.seed, i,
                                       args.device)
                side[on].append(op["seconds"] / op["span"] * 1e3)
        ratios = [a / b for a, b in zip(side[True], side[False])]
        out[wl["name"]] = dict(
            on_round_ms=side[True], off_round_ms=side[False],
            on_over_off=ratios, on_over_off_median=statistics.median(ratios))
    return dict(seed=args.seed, device=torch.cuda.get_device_name(0)
                if args.device == "cuda" else "cpu", cells=out)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cost", type=int, default=0,
                    help="solves a cell, each with the spans on and off")
    args = ap.parse_args(argv)
    print(json.dumps(cost(args) if args.cost else traced(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
