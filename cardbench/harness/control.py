"""The controls: the plain reference put in the program's place and
computed one precision below the configuration's (TF32 for the float32
CoCoA cells), its answers held to the same comparison as the program's.
A control has to come out as not correct; its readings are the upper
ends the limits are set below.

    python3 cardbench/harness/control.py --workload <name> --seeds 1 2 3
    python3 cardbench/harness/control.py --workload <name> --seeds 1 --fault no_exchange
    python3 cardbench/harness/control.py --workload <name> --seeds 1 2 --program

prints one JSON line a seed, its readings and whether they come out
``correct``: the control's; with ``--fault`` a shortest run's with that
fault planted under the timed path (``harness/faults.py``); with
``--program`` a sound shortest run's, many seeds in one process."""
from __future__ import annotations

import json
import os
import sys
import time

if __package__ in (None, ""):
    _ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]


def main(argv=None) -> int:
    import argparse
    from cardbench.harness import core
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--program", action="store_true",
                    help="the program's own readings (a one-operation run)")
    args = ap.parse_args(argv)
    bench = core.spec()
    wl = core.workload(bench, args.workload)
    tr = core.traffic(wl["traffic"])
    drv = core.generator(tr["kind"])
    for seed in args.seeds:
        ctx = core.Context(wl, core.config(wl["config"]), tr, seed, 0.0,
                           False, args.device, time.perf_counter())
        t0 = time.perf_counter()
        if args.fault:
            from cardbench.harness.faults import planted
            with planted(tr["kind"], args.fault):
                run = drv.run(ctx)
        elif args.program:
            run = drv.run(ctx)
        else:
            run = drv.control(ctx)
        print(json.dumps({"workload": wl["name"], "seed": seed,
                          "of": args.fault or ("program" if args.program
                                                else "control"),
                          "correct": run.correct,
                          "readings": {n: v for n, v, _ in run.checks},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
