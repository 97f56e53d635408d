"""On the card (marker ``gpu``; each skips without one): a whole cell
runs through the command as the benchmark's check runs it, and the CoCoA
control comes out not correct at the cell's own size, through the same
comparison and limits as the program's run.

    python -m pytest cardbench -m gpu"""
from cardbench_fixtures import card  # noqa: F401
import gc
import json
import os
import subprocess
import sys
import time

import pytest

from cardbench.harness import core


pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in core.spec()["workloads"]]


def test_a_cell_runs_through_the_command(card):
    cell = CELLS[-1]
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", cell,
         "--seed", str(2**31 + 45), "--seconds", "2", "--trace", "1"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in core.metrics_of(
        core.spec(), cell, True)}
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct_at_the_cells_size(card, cell):
    import torch
    wl = core.workload(core.spec(), cell)
    tr = core.traffic(wl["traffic"])
    ctx = core.Context(wl, core.config(wl["config"]), tr, 2**31 + 41, 0.0,
                       False, card, time.perf_counter())
    try:
        control = core.generator(tr["kind"]).control(ctx)
        assert control.checks and not control.correct, control.checks
    finally:
        # the card holds one cell at a time: hand back what this held
        control = None
        gc.collect()
        torch.cuda.empty_cache()
