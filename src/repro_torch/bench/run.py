"""Tiered benchmark runner (the port of ``repro.bench.run``).

  python -m repro_torch.bench.run --smoke            # seconds, CI gate
  python -m repro_torch.bench.run --quick            # minutes, dev loop
  python -m repro_torch.bench.run --full             # the paper figures
  python -m repro_torch.bench.run --smoke --only a,b --out results/

Emits one schema-valid ``BENCH_<name>.json`` per registered benchmark.
The port registers none until its benchmark modules are named in
``registry.DEFAULT_MODULES``; a caller may register its own specs and
pass their names in ``only``.

The reference's ``--devices`` (which fakes N jax host devices through
``XLA_FLAGS`` before jax is imported) has no counterpart: a sharded path
of the port takes its ranks from a ``torch.distributed`` process group
it starts itself (``launch.dist.spawn``), not from a device count fixed
at import.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time
from contextlib import contextmanager

from repro_torch.bench import registry, schema
from repro_torch.bench.timing import _drain

# Per-benchmark wall-clock budget (seconds) by tier; --timeout overrides.
DEFAULT_TIMEOUT_S = {"smoke": 180.0, "quick": 600.0, "full": 3600.0}


class BenchTimeout(Exception):
    pass


@contextmanager
def _time_limit(seconds: float | None):
    """SIGALRM-based soft wall-clock limit (main thread, POSIX only)."""
    if not seconds or not hasattr(signal, "SIGALRM"):
        yield
        return

    def handler(signum, frame):
        raise BenchTimeout()

    old = signal.signal(signal.SIGALRM, handler)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


def run_one(spec: registry.BenchSpec, ctx: registry.BenchContext,
            timeout_s: float | None = None) -> schema.BenchResult:
    """Run one registered benchmark, wrapping its dict into a BenchResult.
    ``wall_s`` ends after the card has run the spec's queued work."""
    env = schema.EnvFingerprint.capture()
    t0 = time.perf_counter()
    try:
        with _time_limit(timeout_s):
            out = spec.fn(ctx) or {}
            # SIGALRM's handler runs only when control returns to Python:
            # a spec blocked in torch.cuda.synchronize() (here or in its
            # own code) overruns its budget by the card's queued work
            _drain()
        status = out.get("status", "ok")
    except BenchTimeout:
        out, status = {"notes": [f"timed out after {timeout_s:.0f}s"]}, "timeout"
    except Exception as e:  # noqa: BLE001 — one bad benchmark must not kill the run
        out, status = {"notes": [f"{type(e).__name__}: {e}"]}, "error"
    return schema.BenchResult(
        benchmark=spec.name,
        tier=ctx.tier,
        env=env,
        status=status,
        wall_s=round(time.perf_counter() - t0, 3),
        params=out.get("params", {}),
        timings_s=out.get("timings_s", {}),
        counters=out.get("counters", {}),
        rows=out.get("rows", []),
        notes=out.get("notes", []),
    )


def run_benchmarks(tier: str = "quick", only: list[str] | None = None,
                   out_dir: str = ".", seed: int = 0,
                   repeats: int | None = None,
                   timeout_s: float | None = None,
                   verbose: bool = True) -> list[schema.BenchResult]:
    """API entry point (used by tests and the CLI). Returns all results
    and writes one BENCH_<name>.json per benchmark into ``out_dir``."""
    registry.load_default_benchmarks()
    selected = [registry.get(n) for n in only] if only else [
        s for s in registry.specs() if tier in s.tiers]
    budget = timeout_s if timeout_s is not None else DEFAULT_TIMEOUT_S[tier]
    results = []
    for spec in selected:
        ctx = registry.BenchContext(tier=tier, seed=seed, repeats=repeats,
                                    timeout_s=budget, out_dir=out_dir)
        res = run_one(spec, ctx, timeout_s=budget)
        problems = schema.validate(res.to_dict())
        if problems:  # a registered benchmark emitted junk — surface it
            res.status = "error"
            res.notes.append("schema: " + "; ".join(problems))
        path = res.write(out_dir)
        results.append(res)
        if verbose:
            gates = ", ".join(f"{k}={v:.4g}s"
                              for k, v in sorted(res.timings_s.items())[:3])
            print(f"[{res.status:>7s}] {spec.name:<12s} {res.wall_s:7.1f}s"
                  f"  -> {path}" + (f"  ({gates}{', ...' if len(res.timings_s) > 3 else ''})" if gates else ""))
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.run",
                                 description=__doc__)
    tier_g = ap.add_mutually_exclusive_group()
    tier_g.add_argument("--smoke", action="store_const", const="smoke",
                        dest="tier", help="seconds; deterministic CI gate")
    tier_g.add_argument("--quick", action="store_const", const="quick",
                        dest="tier", help="minutes; dev loop")
    tier_g.add_argument("--full", action="store_const", const="full",
                        dest="tier", help="the paper figures")
    tier_g.add_argument("--tier", choices=registry.TIERS, dest="tier")
    ap.set_defaults(tier="quick")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated benchmark names")
    ap.add_argument("--out", type=str, default=".",
                    help="directory for BENCH_*.json (default: cwd)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=None,
                    help="timing repetitions override")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-benchmark wall budget in seconds")
    ap.add_argument("--list", action="store_true",
                    help="list registered benchmarks and exit")
    args = ap.parse_args(argv)

    if args.list:
        registry.load_default_benchmarks()
        for s in registry.specs():
            fig = f" [{s.figures}]" if s.figures else ""
            print(f"{s.name:<12s}{fig} {s.description}")
        return 0

    only = args.only.split(",") if args.only else None
    t0 = time.perf_counter()
    try:
        results = run_benchmarks(tier=args.tier, only=only, out_dir=args.out,
                                 seed=args.seed, repeats=args.repeats,
                                 timeout_s=args.timeout)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    bad = [r for r in results if r.status in ("error", "timeout")]
    print(f"# {len(results)} benchmarks, tier={args.tier}, "
          f"{time.perf_counter() - t0:.1f}s total"
          + (f", {len(bad)} FAILED: {[r.benchmark for r in bad]}" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
