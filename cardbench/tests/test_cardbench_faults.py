"""A whole run of the CoCoA cell, the look for a card skipped, with the
timed path broken underneath (``harness/faults.py``): ``correct`` comes
out false for each fault the cell can have, and true for the sound run
beside it."""
from cardbench_fixtures import run_cell, tiny_cocoa  # noqa: F401
import pytest

from cardbench.harness.faults import FAULTS, PLANT


@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_cocoa_fault(tiny_cocoa, monkeypatch, fault):
    cfg, tr = tiny_cocoa
    if fault:
        PLANT["cocoa"](monkeypatch.setattr, fault)
    run = run_cell(cfg, tr, 2**31 + 21)
    assert run.correct is (fault is None), run.checks
