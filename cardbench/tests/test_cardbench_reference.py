"""The plain reference against the program on the CPU at a tiny size,
and the control against the reference."""
from cardbench_fixtures import run_cell, tiny_cocoa  # noqa: F401
import time

import pytest
import torch

from cardbench.harness import core


@pytest.mark.parametrize("seed", [1, 2**31 + 21])
def test_cocoa_program_agrees_with_the_reference(tiny_cocoa, seed):
    cfg, tr = tiny_cocoa
    run = run_cell(cfg, tr, seed)
    assert run.failed == 0 and run.attempted >= 2
    assert run.correct, run.checks
    assert [op["i"] for op in run.ops if op["states"]] == \
        core.generator("cocoa").checked_solves(tr, seed, 1)


@pytest.mark.parametrize("exchange", ["persistent", "compressed:int8"])
def test_cocoa_reference_round_equals_sequential_scd(exchange):
    """The triangular form against H sequential coordinate steps (the
    program's plain solver) on one round from a state that is not zero,
    with repeated coordinates."""
    from cardbench.reference import cocoa as ref
    from repro_torch.core.solvers import scd_steps
    g = torch.Generator().manual_seed(4)
    m, n, K, H = 96, 64, 2, 48
    A = torch.randn((m, n), generator=g, dtype=torch.float64)
    part = ref.Partition([torch.arange(0, 32), torch.arange(32, 64)])
    idx = torch.randint(0, 32, (K, H), generator=g)
    alpha = torch.randn((K, 32), generator=g, dtype=torch.float64)
    w = torch.randn((m,), generator=g, dtype=torch.float64)
    s = ref.round_from(A.T.contiguous(), part, alpha, w, idx, lam=1.0,
                       sigma=2.0, exchange=exchange)
    A_T = torch.stack([A[:, o].T for o in part.owned])
    dv, alpha_new = scd_steps(A_T, (A_T ** 2).sum(-1), alpha, w, idx,
                              sigma=2.0, lam=1.0, eta=1.0)
    assert torch.allclose(s.dalpha, alpha_new - alpha, atol=1e-10)
    want = ref.int8_sum(dv) if exchange != "persistent" else dv.sum(0)
    assert torch.allclose(s.total, want, atol=1e-10)


def test_tf32_rounding():
    from cardbench.reference.cocoa import tf32
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11,
                      -(1 + 2**-11 + 2**-20), 3.0e-30])
    got = tf32(x)
    assert got.tolist()[:4] == [1.0, 1 + 2**-10, 1.0, 1 + 2**-9]
    assert got[4] == -(1 + 2**-10)
    assert torch.equal(tf32(got), got)


def test_cocoa_tf32_control_comes_out_not_correct(tiny_cocoa):
    """The control through the same comparison and limits as the
    program's run: it fails one of the numbers."""
    cfg, tr = tiny_cocoa
    torch.set_num_threads(4)
    ctx = core.Context({"name": "cpu"}, cfg, tr, 2**31 + 3, 0.0, False,
                       "cpu", time.perf_counter())
    control = core.generator("cocoa").control(ctx)
    assert control.checks and not control.correct, control.checks
    sound = run_cell(cfg, tr, 2**31 + 3)
    assert sound.correct, sound.checks
