"""The span metrics' readers (``harness/spans.py`` and
``metrics/{worker_ms,exchange_us,master_us,overhead_ms,solve_tail_ms}.cocoa``)
on hand-made span logs, and on the CPU the spans a traced run of the
CoCoA cell records by itself under the window's profiler session."""
from cardbench_fixtures import run_cell, tiny_cocoa  # noqa: F401
import pytest

from cardbench.harness import core, names
from cardbench.harness import spans as hs
from cardbench.harness.trace import Trace
from repro_torch.utils import spans

SPAN_METRICS = ("worker_ms.cocoa", "exchange_us.cocoa", "master_us.cocoa",
                "overhead_ms.cocoa", "solve_tail_ms.cocoa")


def _span(log, name, parent, t, start_ms, end_ms, device_ms=None):
    s = spans.Span(log, name, None, t, int(start_ms * 1e6), False, False)
    s.index, s.parent = len(log.spans), parent
    s.end_ns, s.device_ms = int(end_ms * 1e6), device_ms
    log.spans.append(s)
    return s.index


def hand_log():
    """Two solves of 2 and 1 rounds: a round 10 ms on the host, its
    draw 0.1, local step 8, exchange 0.03, apply 0.01 and metric 0.05
    ms on the device; each solve 4 ms outside its rounds."""
    log = spans.SpanLog()
    t0 = 0.0
    for n_rounds in (2, 1):
        solve = _span(log, "solve", None, None, t0, t0 + 10 * n_rounds + 4)
        at = t0 + 1
        for t in range(1, n_rounds + 1):
            r = _span(log, "round", solve, t, at, at + 10)
            for name, ms in (("draw", 0.1), ("local_step", 8.0),
                             ("exchange", 0.03), ("apply", 0.01),
                             ("metric", 0.05)):
                _span(log, name, r, t, at, at + ms, ms)
            _span(log, "read_back", r, t, at + 9, at + 10)
            at += 10
        _span(log, "finish", solve, None, at, at + 3)
        t0 += 100
    return log


def traced_run():
    return core.Run(config={}, traffic={}, trace=Trace(window_s=1.0))


def read(name, run):
    return core.reader(name).read(run)


def test_readers_arithmetic(monkeypatch):
    monkeypatch.setattr(spans, "profiled", hand_log)
    run = traced_run()
    assert read("worker_ms.cocoa", run) == pytest.approx(8.0)
    assert read("exchange_us.cocoa", run) == pytest.approx(30.0)
    assert read("master_us.cocoa", run) == pytest.approx(60.0)
    assert read("overhead_ms.cocoa", run) == pytest.approx(
        10 - (0.1 + 8 + 0.03 + 0.01 + 0.05))
    assert read("solve_tail_ms.cocoa", run) == pytest.approx(4.0)


def test_readers_read_nothing_without_a_log(monkeypatch):
    untraced = core.Run(config={}, traffic={})
    monkeypatch.setattr(spans, "profiled", hand_log)
    for name in SPAN_METRICS:
        assert read(name, untraced) is None
    # a program that keeps no span log (the profiler saw no round)
    monkeypatch.setattr(spans, "profiled", lambda: None)
    for name in SPAN_METRICS:
        assert read(name, traced_run()) is None


def test_device_spans_read_nothing_on_the_cpu(monkeypatch):
    log = hand_log()
    for s in log.spans:
        s.device_ms = None
    monkeypatch.setattr(spans, "profiled", lambda: log)
    run = traced_run()
    for name in SPAN_METRICS[:4]:
        assert read(name, run) is None
    assert read("solve_tail_ms.cocoa", run) == pytest.approx(4.0)


def test_no_span_name_matches_a_kernels(tiny_cocoa):
    from repro_torch.core.cocoa import CoCoAConfig, CoCoATrainer
    from repro_torch.data import make_glm_data
    A, b, _ = make_glm_data(m=64, n=32, density=0.3, zipf_a=1.1, seed=1)
    tr = CoCoATrainer(CoCoAConfig(K=2, H=4, exchange="compressed:int8"),
                      A, b, device="cpu")
    with spans.recording() as log:
        tr.run(2)
    got = {s.name for s in log.spans} | {spans.ANCHOR + "0"}
    assert {"solve", "round", "local_step", "exchange"} <= got
    for match in (names.k1, names.k2, names.k3):
        assert not [n for n in got if match(n)]


def test_a_traced_cpu_run_records_one_round_span_a_round(tiny_cocoa):
    cfg, tr = tiny_cocoa
    run = run_cell(cfg, tr, 2**31 + 33, trace=True)
    assert run.correct, run.checks
    traced = [op for op in run.ops if op["i"] <= run.info["traced_solves"]]
    log = hs.log_of(run)
    rounds = hs.rounds_of(log)
    assert len(rounds) == sum(op["rounds"] for op in traced)
    assert [r.t for r, _ in rounds] == [
        t for op in traced for t in range(1, op["rounds"] + 1)]
    assert all(set(kids) == set(hs.ROUND_PARTS) | {"read_back"}
               for _, kids in rounds)
    assert len(log.named("solve")) == len(traced)
    # one anchor a round in the trace, and the window's idle time (all
    # of it on the CPU, which runs no kernel) put down to the spans
    anchors = [n for n, _, _ in run.trace.host if n.startswith(spans.ANCHOR)]
    assert len(anchors) == len(rounds)
    split = hs.idle_by_span(log, run.trace)
    assert sum(split.values()) == pytest.approx(
        (run.trace.t1_us - run.trace.t0_us) / 1e6)
    assert {"local_step", "read_back"} <= set(split)
    assert read("solve_tail_ms.cocoa", run) > 0
