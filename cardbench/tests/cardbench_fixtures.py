"""Shared fixtures and helpers of the benchmark's tests, imported by each
test module (the repository's own tests keep a ``conftest.py``; this
file's name is the benchmark's own)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device, decided when a test asks for it: tests marked
    ``gpu`` skip without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def tiny_cocoa():
    """A CoCoA cell cut to a size the CPU runs in seconds."""
    from cardbench.harness import core
    cfg = core.config("webspam350k")
    cfg["data"].update(examples=1024, features=256, seed=3)
    cfg["workers"]["K"] = 4
    tr = core.traffic("cocoa-h4096-int8")
    # eps 1e-2: at this size the int8 exchange's drift stalls some solves
    # short of 1e-3, in the reference as in the program
    tr.update(H=128, eps=1e-2, expected_rounds=20, trace_solves=1,
              check_solves=2, check_among=3)
    # between what sound runs read at this size on the CPU (pstar
    # 3.2e-7, alpha 5.2e-6, w 1.0e-5, primal 3.3e-6 at most over eight
    # seeds) and what the TF32 control reads (7.6e-5, 8.9e-3, 1.1e-3,
    # 5.2e-4 at least)
    tr["limits"] = {"partition": 0.0, "pstar": 5e-6, "alpha": 2e-4,
                    "w": 1e-4, "primal": 5e-5}
    return cfg, tr


def run_cell(cfg, tr, seed, seconds=0.5, trace=False):
    """A whole run of a cell's traffic generator on the CPU, the harness's look for
    a card skipped."""
    import time

    import torch

    from cardbench.harness import core
    torch.set_num_threads(4)
    ctx = core.Context({"name": "cpu"}, cfg, tr, seed, seconds, trace,
                       "cpu", time.perf_counter())
    return core.generator(tr["kind"]).run(ctx)
