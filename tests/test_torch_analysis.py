"""The port's analysis CLI (``python -m repro_torch.analysis``) against the
reference's: the same cell lists and problem, the same rule ids and
severities (less ``f32-intermediate`` and ``single-compile``, which read
a compiled graph and a jit cache the port does not have), each ported
rule firing on a hand-made log and silent on its clean twin, and the CLI
on a 4-rank gloo group on the CPU: clean on the codec cells, tripped by
``--inject wire-f32``. The full ``all`` sweep runs on the card
(``chip_smoke.py`` phase 13)."""
import json
import os
import subprocess
import sys

import pytest

from repro.analysis import cells as ref_cells
from repro.analysis import findings as ref_findings
from repro.analysis import rules as ref_rules  # noqa: F401 (registers)
from repro_torch.analysis import cells, rules  # noqa: F401 (registers)
from repro_torch.analysis.findings import RULES, max_severity
from repro_torch.comm.collectives import LoggedCall

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEFT_OUT = ("f32-intermediate", "single-compile")
K = 4


def test_the_cells_are_the_reference_cells():
    assert [c.id for c in cells.all_cells()] == \
        [c.id for c in ref_cells.all_cells()]
    for name in ("matrix", "regime", "backend", "codec"):
        assert [c.id for c in cells.resolve_cells(name)] == \
            [c.id for c in ref_cells.resolve_cells(name)]
    assert cells.PROBLEM == ref_cells.PROBLEM
    assert [c.id for c in cells.resolve_cells("cocoa=persistent/ring")] == \
        ["cocoa=persistent/ring"]
    with pytest.raises(ValueError, match="bad cell"):
        cells.resolve_cells("nosuch=persistent")


def test_the_rules_are_the_references_less_two():
    want = {r.id: r.severity for r in ref_findings.RULES.values()
            if r.scope == "cell" and r.id not in LEFT_OUT}
    assert {r.id: r.severity for r in RULES.values()} == want
    assert all(r.scope == "cell" for r in RULES.values())


def _call(op, dtype, nbytes, t, peer=None):
    return LoggedCall(op, dtype, nbytes, False, t, peer)


def _int8_logs(payload=96, extra=()):
    """Every rank's log of 2 rounds of CoCoA ``compressed:int8`` at
    m = 96: the int8 payload, its scale and the metric."""
    return [[c for t in (1, 2) for c in (
        _call("all_gather", "int8", payload, t),
        _call("all_gather", "float32", 4, t),
        _call("all_reduce", "float32", 4, t)) + tuple(
            _call(*e, t) for e in extra)] for _ in range(K)]


def _ctx(spec, logs, variants=None):
    return cells.context(cells.Cell("cocoa", spec), logs, K, device="cpu",
                         variants=variants)


def _fires(rule_id, ctx) -> bool:
    found = RULES[rule_id].check(ctx)
    assert all(f.rule == rule_id and f.cell == ctx.id for f in found)
    return bool(found)


def test_bytes_match_fires_on_a_byte_off():
    assert not _fires("bytes-match", _ctx("compressed:int8", _int8_logs()))
    assert _fires("bytes-match", _ctx("compressed:int8", _int8_logs(97)))


def test_wire_dtype_fires_on_an_f32_gather_under_int8():
    assert not _fires("wire-dtype", _ctx("compressed:int8", _int8_logs()))
    bad = _ctx("compressed:int8",
               _int8_logs(extra=[("all_gather", "float32", 64)]))
    assert _fires("wire-dtype", bad)
    assert max_severity(RULES["wire-dtype"].check(bad)) == "error"


def _ring_logs(peer_of):
    """Every rank's 3 hops of one ``compressed:int4/ring`` round (the
    payload and its scale a hop), each sent to ``peer_of(rank)``."""
    return [[_call("send", dt, n, 1, peer_of(r)) for _ in range(K - 1)
             for dt, n in (("uint8", 48), ("float32", 4))]
            + [_call("all_reduce", "float32", 4, 1)] for r in range(K)]


def test_ring_topology_fires_on_two_two_cycles():
    ring = _ctx("compressed:int4/ring", _ring_logs(lambda r: (r + 1) % K))
    assert not _fires("ring-topology", ring)
    assert not _fires("bytes-match", ring)
    assert _fires("ring-topology", _ctx("compressed:int4/ring",
                                        _ring_logs(lambda r: r ^ 1)))
    none = [[_call("all_reduce", "float32", 4, 1)] for _ in range(K)]
    assert _fires("ring-topology", _ctx("compressed:int4/ring", none))


def test_membership_invariant_fires_on_a_drop_round_with_a_call_fewer():
    full = [[_call("all_reduce", "float32", n, t) for t in (1, 2, 3)
             for n in (384, 4)] for _ in range(K)]
    variants = {"persistent": full}
    assert not _fires("membership-invariant",
                      _ctx("persistent/drop:1@2-4", full, variants))
    short = [log[:2] + log[3:] for log in full]       # round 2: one call
    assert _fires("membership-invariant",
                  _ctx("persistent/drop:1@2-4", short, variants))


def _cli(args, tmp_path):
    out = tmp_path / "ANALYSIS.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--devices", str(K), "--device", "cpu", "--out",
                          str(out)] + args, capture_output=True, text=True,
                         timeout=300, env=env, cwd=tmp_path)
    return res, json.loads(out.read_text())


def test_cli_runs_the_codec_cells_clean(tmp_path):
    res, report = _cli(["--cells", "codec"], tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert set(report) == {"cells", "rules", "findings", "summary"}
    assert [c["cell"] for c in report["cells"]] == \
        [c.id for c in cells.codec_cells()]
    assert report["summary"] == {"cells": 10, "error": 0, "warning": 0,
                                 "info": 0}
    assert all(c["K"] == K and c["rounds"] == cells.ROUNDS
               and c["collectives"] >= 2 * cells.ROUNDS
               for c in report["cells"])
    assert {r["id"] for r in report["rules"]} == set(RULES)


def test_cli_injected_violation_exits_nonzero(tmp_path):
    res, report = _cli(["--cells", "cocoa=persistent", "--inject",
                        "wire-f32"], tmp_path)
    assert res.returncode == 1, res.stdout + res.stderr
    errs = [f for f in report["findings"] if f["severity"] == "error"]
    assert {f["rule"] for f in errs} == {"bytes-match", "wire-dtype"}
    assert all("injected-f32-wire" in f["cell"] for f in errs)
    assert report["summary"]["error"] == len(errs)
