"""``python -m repro_torch.analysis``: run the exchange cells on one
``torch.distributed`` group, put every rank's recorded collective log
through the lint-rule registry, print a findings table, write
ANALYSIS.json in the reference's layout, and exit nonzero on an
error-severity finding (the port of ``repro.analysis.run``)::

    PYTHONPATH=src python -m repro_torch.analysis --cells codec \\
        --devices 4 --out ANALYSIS.json [--inject wire-f32] [--device cpu]

``--devices`` is the number of gloo ranks (one process each, all on the
card unless ``--device cpu``), the cells' K. The reference's
``--src`` / ``--no-source-lint`` drive its AST rules over JAX source
(``repro.analysis.pylint_jax``), which have no counterpart here, so
they are left out.
"""
from __future__ import annotations

import argparse
import json
import sys


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Run each exchange cell on one torch.distributed group, "
                    "record every rank's calls into the group and run the "
                    "lint-rule registry over the logs.")
    p.add_argument("--cells", default="all",
                   help="all | matrix | regime | backend | codec | "
                        "comma-separated algo=spec list (default: all)")
    p.add_argument("--out", default="ANALYSIS.json",
                   help="findings JSON path (default: ANALYSIS.json)")
    p.add_argument("--devices", type=int, default=4,
                   help="ranks of the gloo group, the cells' K (default: "
                        "4, the reference's matrix K)")
    p.add_argument("--inject", choices=("wire-f32",), default=None,
                   help="inject a known violation (validates that the "
                        "gate trips): wire-f32 analyzes an f32 exchange's "
                        "run under an exchange that claims int8")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


INJECTED = ("cocoa", "compressed:f32")      # run, then claimed as int8


def _injected_context(cells_mod, logs, K, device):
    """A deliberately broken cell: the ``compressed:f32`` run analyzed
    under an exchange that CLAIMS the int8 codec; wire-dtype and
    bytes-match must both fire."""
    claimed = cells_mod.build_trainer(
        cells_mod.Cell("cocoa", "compressed:int8"), K, device=device)
    return cells_mod.context(
        cells_mod.Cell("cocoa", "compressed:int8[injected-f32-wire]"), logs,
        K, device=device, trainer=claimed)


def _summary(ctx, injected=False) -> dict:
    """A cell's line of the report: K, rounds, calls and operand bytes a
    rank (rank 0's log)."""
    from repro_torch.comm.collectives import CollectiveLog
    log = CollectiveLog(ctx.logs[0])
    out = {"cell": ctx.id, "K": ctx.K, "rounds": len(log.rounds()),
           "collectives": len(log),
           "logged_operand_bytes": sum(c.nbytes for c in log)}
    if injected:
        out["injected"] = True
    return out


def main(argv=None) -> int:
    args = _parse_args(argv)

    from repro_torch.analysis import cells as cells_mod
    from repro_torch.analysis import rules  # noqa: F401 (registers)
    from repro_torch.analysis.findings import RULES, SEVERITIES
    from repro_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    try:
        selected = cells_mod.resolve_cells(args.cells)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    extra = ([cells_mod.Cell(*INJECTED)] if args.inject == "wire-f32"
             else [])
    ctxs, extra_logs = cells_mod.analyze_cells(
        selected, args.devices, device=device, extra=extra)
    if extra_logs:
        ctxs.append(_injected_context(cells_mod, extra_logs[0],
                                      args.devices, device))

    findings, analyzed = [], []
    for ctx in ctxs:
        analyzed.append(_summary(ctx, "injected" in ctx.id))
        for rule in RULES.values():
            if rule.scope == "cell":
                findings.extend(rule.check(ctx))
        print(f"analyzed {ctx.id} ({analyzed[-1]['collectives']} calls "
              f"on rank 0)")

    counts = {s: sum(1 for f in findings if f.severity == s)
              for s in SEVERITIES}
    print()
    if findings:
        w = max(len(f.rule) for f in findings)
        for f in sorted(findings,
                        key=lambda f: (SEVERITIES.index(f.severity),
                                       f.rule, f.cell)):
            print(f"{f.severity.upper():7s} {f.rule:{w}s} {f.cell}\n"
                  f"        {f.message}")
    print(f"\n{len(analyzed)} cells analyzed on {args.devices} ranks "
          f"({device.type}), {len(RULES)} rules: "
          + ", ".join(f"{counts[s]} {s}" for s in SEVERITIES))
    report = {
        "cells": analyzed,
        "rules": [r.to_json() for r in RULES.values()],
        "findings": [f.to_json() for f in findings],
        "summary": {"cells": len(analyzed), **counts},
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2)
        print(f"wrote {args.out}")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
