"""Each metric reader's arithmetic on a synthetic run: hand-made clocks
and trace."""
import cardbench_fixtures  # noqa: F401  (puts the checkout on the path)
import math

import pytest
import torch

from cardbench.harness import core
from cardbench.harness.trace import Trace, breakdown, busy_us
from cardbench.yardstick import bounds, streams


def read(name, run):
    return core.reader(name).read(run)


def cocoa_run(traced=True):
    K, H, m, n_pad = 2, 8, 64, 16
    ops = [dict(kind="solve", i=1, t0=0.0, t1=0.3, ok=True, rounds=3,
                rounds_to_eps=3, seconds=0.25, span=3),
           dict(kind="solve", i=2, t0=0.3, t1=0.5, ok=True, rounds=4,
                rounds_to_eps=4, seconds=0.16, span=4),
           dict(kind="solve", i=3, t0=0.5, t1=1.0, ok=False, rounds=12,
                rounds_to_eps=None, seconds=0.48, span=12)]
    info = dict(K=K, H=H, m=m, n_pad=n_pad, traced_solves=1,
                sizes=[16, 13], seed=2**31 + 7, device="cpu")
    drawn = streams.solve_draws(info, ops[0], "cpu")
    tr = None
    if traced:
        # per round: K1 100 us, K2 3 us, K3 2 us, one other 5 us; a
        # 10 us gap a round; the window 0.001 s after the last kernel
        ks, t = [], 0.0
        for _ in range(3):
            for name, us in (("void (anonymous namespace)::scd_kernel<4, "
                              "false>(float const*)", 100.0),
                             ("void quant_kernel<1, 2>(float const*)", 3.0),
                             ("void dequant_kernel<8, 4>(float*)", 2.0),
                             ("void at::native::reduce_kernel<512>()", 5.0)):
                ks.append((name, t, t + us))
                t += us
            t += 10.0
        tr = Trace(window_s=400e-6, kernels=ks,
                   host=[("aten::rand", 110.0, 125.0)], t0_us=0.0,
                   t1_us=400.0)
    return core.Run(config={}, traffic={}, setup_s=12.5, window=(0.0, 1.0),
                    ops=ops, trace=tr, info=info), drawn


def test_cocoa_end_to_end():
    run, _ = cocoa_run()
    assert read("setup_s", run) == 12.5
    assert read("time_to_eps_ms", run) == pytest.approx(1000.0 / 2)
    assert run.attempted == 3 and run.failed == 1


def test_cocoa_per_layer():
    run, drawn = cocoa_run()
    # the untraced solves only: (0.16 + 0.48) / 16 rounds
    assert read("round_ms.cocoa", run) == pytest.approx(640.0 / 16)
    assert read("rounds_to_eps.cocoa", run) == pytest.approx(3.5)
    k1 = sum(bounds.kernel_bounds(i, 16, 64, 1)[0]["scd_solve"][0]
             for i in drawn)
    assert read("k1_roofline.cocoa", run) == pytest.approx(
        100 * k1 / 0.3)
    assert read("codec_us.cocoa", run) == pytest.approx(5.0)
    rest = bounds.cocoa_round_rest_ms(2, 16, 64)
    total = sum(b["scd_solve"][0] + b["int8"][0] + b["decode_int8"][0]
                + rest for b in (bounds.kernel_bounds(i, 16, 64, 1)[0]
                                 for i in drawn))
    assert read("mfu.cocoa", run) == pytest.approx(100 * total / 0.4)
    assert read("device_idle.cocoa", run) == pytest.approx(
        100 * (1 - 330 / 400))


def test_untraced_run_reads_nothing_from_a_trace():
    run, _ = cocoa_run(traced=False)
    for name in ("k1_roofline.cocoa", "codec_us.cocoa", "mfu.cocoa",
                 "device_idle.cocoa"):
        assert read(name, run) is None


def test_traced_draws_are_the_traced_solves_rounds():
    run, drawn = cocoa_run()
    got = streams.traced_draws(run)
    assert len(got) == 3 and all(torch.equal(a, b)
                                 for a, b in zip(got, drawn))
    assert int(got[0][1].max()) < 13


def test_busy_union_and_breakdown():
    ks = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("a", 20.0, 30.0)]
    assert busy_us(ks) == 22.0
    tr = Trace(window_s=40e-6, kernels=ks,
               host=[("aten::item", 11.0, 19.0), ("aten::rand", 31.0, 33.0)],
               t0_us=0.0, t1_us=40.0)
    bd = breakdown(tr)
    assert bd["device_ops"][0] == ["a", pytest.approx(20e-6)]
    gaps = dict(bd["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(8e-6)
    assert gaps["aten::rand"] == pytest.approx(10e-6)
    assert math.isclose(sum(gaps.values()), 18e-6)
