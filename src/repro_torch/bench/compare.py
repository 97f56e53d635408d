"""Regression gate over BENCH_*.json results (the port of
``repro.bench.compare``).

  python -m repro_torch.bench.compare old.json new.json --max-regression 1.25
  python -m repro_torch.bench.compare old_dir/ new_dir/ --max-regression 1.25

Every metric in ``timings_s`` is lower-is-better; a metric whose
new/old ratio exceeds ``--max-regression`` is a regression and the tool
exits nonzero (so CI can gate). Improvements and new metrics pass.
Sub-millisecond timings are floored at ``--min-time`` before the ratio
so dispatch jitter on trivial measurements cannot fail the gate.

``--exact-counter PREFIX`` (repeatable) additionally gates ``counters``
whose names start with PREFIX on EXACT equality — for machine-
independent modelled quantities (bytes a round, a kernel's bound),
where any drift means the accounting changed, not that the host got
slower.

Two results from cards of one name but different power limits are not
comparable either (a card held below its limit runs slower under load):
the device warning names both.
"""
from __future__ import annotations

import argparse
import glob
import os
from dataclasses import dataclass

from repro_torch.bench import schema


@dataclass(frozen=True)
class Delta:
    benchmark: str
    metric: str
    old: float
    new: float
    ratio: float
    regression: bool


def compare_results(old: schema.BenchResult, new: schema.BenchResult,
                    max_regression: float = 1.25,
                    min_time_s: float = 1e-4) -> list[Delta]:
    deltas = []
    for metric, t_old in sorted(old.timings_s.items()):
        if metric not in new.timings_s:
            continue  # dropped metric: reported by caller, not a gate
        t_new = new.timings_s[metric]
        eff_old = max(float(t_old), min_time_s)
        eff_new = max(float(t_new), min_time_s)
        ratio = eff_new / eff_old
        deltas.append(Delta(old.benchmark, metric, float(t_old), float(t_new),
                            ratio, ratio > max_regression))
    return deltas


def compare_counters(old: schema.BenchResult, new: schema.BenchResult,
                     prefixes: list[str]) -> list[Delta]:
    """Exact-equality deltas over counters matching any of ``prefixes``.
    Counters present only on one side are skipped (coverage growth and
    device-starved hosts must not fail the gate)."""
    deltas = []
    for name, c_old in sorted(old.counters.items()):
        if not any(name.startswith(p) for p in prefixes):
            continue
        if name not in new.counters:
            continue
        c_new = new.counters[name]
        deltas.append(Delta(old.benchmark, name, float(c_old), float(c_new),
                            float("nan") if not c_old
                            else float(c_new) / float(c_old),
                            float(c_new) != float(c_old)))
    return deltas


def _pair_paths(old: str, new: str) -> list[tuple[str, str]]:
    """(old, new) file pairs; dirs are matched on BENCH_*.json filename."""
    if os.path.isdir(old) != os.path.isdir(new):
        raise SystemExit("compare: both paths must be files or both dirs")
    if not os.path.isdir(old):
        return [(old, new)]
    pairs = []
    for old_path in sorted(glob.glob(os.path.join(old, "BENCH_*.json"))):
        new_path = os.path.join(new, os.path.basename(old_path))
        if os.path.exists(new_path):
            pairs.append((old_path, new_path))
        else:
            print(f"# note: {os.path.basename(old_path)} missing from {new}")
    if not pairs:
        raise SystemExit(f"compare: no matching BENCH_*.json under {old!r}")
    return pairs


def _device(env: schema.EnvFingerprint) -> str:
    """The card's name, with its power limit where the result has one."""
    return (f"{env.device_kind} at {env.power_limit}" if env.power_limit
            else env.device_kind)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.compare",
                                 description=__doc__)
    ap.add_argument("old", help="baseline BENCH_*.json file or directory")
    ap.add_argument("new", help="candidate BENCH_*.json file or directory")
    ap.add_argument("--max-regression", type=float, default=1.25,
                    help="fail when new/old exceeds this ratio (default 1.25)")
    ap.add_argument("--min-time", type=float, default=1e-4,
                    help="floor (seconds) applied before the ratio")
    ap.add_argument("--exact-counter", action="append", default=[],
                    metavar="PREFIX",
                    help="gate counters starting with PREFIX on exact "
                         "equality (repeatable)")
    args = ap.parse_args(argv)

    regressions = 0
    for old_path, new_path in _pair_paths(args.old, args.new):
        old, new = schema.load(old_path), schema.load(new_path)
        if old.benchmark != new.benchmark:
            raise SystemExit(f"compare: {old_path} is {old.benchmark!r} but "
                             f"{new_path} is {new.benchmark!r}")
        if old.tier != new.tier:
            print(f"# warning: comparing tiers {old.tier!r} vs {new.tier!r} "
                  f"for {old.benchmark}")
        if _device(old.env) != _device(new.env):
            print(f"# warning: device {_device(old.env)!r} vs "
                  f"{_device(new.env)!r} — timings may not be comparable")
        dropped = sorted(set(old.timings_s) - set(new.timings_s))
        if dropped:
            print(f"# warning: {old.benchmark}: metrics dropped in new "
                  f"result: {dropped}")
        for d in compare_results(old, new, args.max_regression, args.min_time):
            verdict = "REGRESSION" if d.regression else (
                "improved" if d.ratio < 1.0 else "ok")
            print(f"{d.benchmark:<12s} {d.metric:<36s} "
                  f"{d.old:10.5f}s -> {d.new:10.5f}s  x{d.ratio:5.2f}  {verdict}")
            regressions += d.regression
        for d in compare_counters(old, new, args.exact_counter):
            verdict = "MISMATCH" if d.regression else "exact"
            print(f"{d.benchmark:<12s} {d.metric:<36s} "
                  f"{d.old:12.0f}  -> {d.new:12.0f}   {verdict}")
            regressions += d.regression
    if regressions:
        print(f"# {regressions} regression(s) beyond "
              f"x{args.max_regression:.2f} — failing")
        return 1
    print("# no regressions")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
