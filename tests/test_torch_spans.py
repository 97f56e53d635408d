"""The round driver's spans and counters (``repro_torch.utils.spans``) on
the CPU: off records nothing and touches no clock, event or profiler;
``recording()`` gives one tree a run (a solve, its rounds with one draw,
local step, exchange, apply, metric and read-back each, its finish) on
History's own clock reads and leaves every bit of the run as it was; a
profiler session records the spans by itself, with one anchor a round
that places them on the profiler's clock; ``payload_bytes`` is the
codec's payload. One small problem (256 x 64, K = 4, H = 16) serves
every test."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import (CoCoAConfig, CoCoATrainer, MinibatchSCD,
                              MinibatchSGD, SGDConfig)
from repro_torch.data import make_glm_data
from repro_torch.utils import spans

M, N, K, H, ROUNDS = 256, 64, 4, 16, 5
PARTS = ("draw", "local_step", "exchange", "apply", "metric", "read_back")


@pytest.fixture(scope="module")
def data():
    A, b, _ = make_glm_data(m=M, n=N, density=0.3, zipf_a=1.1, seed=7)
    return A, b


def _cocoa(data, exchange="compressed:int8"):
    return CoCoATrainer(CoCoAConfig(K=K, H=H, exchange=exchange), *data,
                        device="cpu")


def _tree(log):
    """``[(round t, [child names])]`` of every round, and the names of
    the top-level spans and of their children."""
    rounds = [(r.t, [c.name for c in log.children(r)])
              for r in log.named("round")]
    top = [(s.name, [c.name for c in log.children(s)
                     if c.name != "round"])
           for s in log.spans if s.parent is None]
    return rounds, top


class _Counting:
    """Counts its calls and then calls ``real``."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.real(*a, **k)


def test_off_records_nothing_and_touches_no_clock_event_or_profiler(
        data, monkeypatch):
    tr = _cocoa(data)
    assert spans.span("a") is spans.span("b", "cuda", t=3, sync=True)
    assert not spans.active()
    clock = _Counting(spans.perf_counter_ns)
    event = _Counting(torch.cuda.Event)
    anchor = _Counting(torch._C._profiler._RecordFunctionFast)
    monkeypatch.setattr(spans, "perf_counter_ns", clock)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", anchor)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _Counting(torch.autograd.profiler.record_function))
    before = spans.profiled()
    tr.run(ROUNDS)
    assert (clock.calls, event.calls, anchor.calls) == (0, 0, 0)
    assert torch.autograd.profiler.record_function.calls == 0
    assert spans.profiled() is before
    with spans.recording() as log:
        tr.run(ROUNDS)
    # the same counters see the spans once they record
    assert clock.calls > 0 and len(log.spans) == 1 + 7 * ROUNDS + 1
    assert event.calls == anchor.calls == 0      # the CPU, no profiler


def test_recording_gives_one_tree_a_run(data):
    tr = _cocoa(data)
    with spans.recording() as log:
        hist = tr.run(ROUNDS)
    rounds, top = _tree(log)
    assert [t for t, _ in rounds] == hist.rounds == list(range(1, ROUNDS + 1))
    assert all(kids == list(PARTS) for _, kids in rounds)
    assert top == [("solve", ["finish"])]
    assert all(s.device_ms is None and s.end_ns >= s.start_ns
               for s in log.spans)
    # every span of a round carries its t
    for r in log.named("round"):
        assert {c.t for c in log.children(r)} == {r.t}
    assert log.counted("rounds") == [("rounds", ROUNDS, 0, None)]


def test_round_spans_take_historys_clock_reads(data):
    tr = _cocoa(data)
    with spans.recording() as log:
        hist = tr.run(6, record_every=2)
    rounds = log.named("round")
    assert hist.span == [2, 2, 2]
    for i, sec in enumerate(hist.seconds):
        first, last = rounds[2 * i], rounds[2 * i + 1]
        assert sec == (last.end_ns - first.start_ns) / 1e9
        # a round that is not recorded does not read its primal back
        assert [c.name for c in log.children(first)] == list(PARTS[:-1])
        assert [c.name for c in log.children(last)] == list(PARTS)


def test_recording_leaves_the_run_bit_identical(data):
    tr = _cocoa(data, "compressed:ef:int4/stale:k=2/drop:1@2-3")
    off = tr.run(ROUNDS)
    a_off, w_off = tr.alpha_final.copy(), tr.w_final.copy()
    with spans.recording() as log:
        on = tr.run(ROUNDS)
    assert on.primal == off.primal
    assert np.array_equal(tr.alpha_final, a_off)
    assert np.array_equal(tr.w_final, w_off)
    rounds, _ = _tree(log)
    assert all(kids == list(PARTS) for _, kids in rounds)


@pytest.mark.parametrize("make", ["minibatch_scd", "sgd_workers", "sgd"])
def test_the_baselines_record_the_same_tree(data, make):
    A, b = data
    if make == "minibatch_scd":
        tr = MinibatchSCD(CoCoAConfig(K=K, H=H, exchange="compressed:int8"),
                          A, b, device="cpu")
        go = lambda: tr.run(ROUNDS)                        # noqa: E731
    else:
        tr = MinibatchSGD(SGDConfig(K=K, H=2, exchange="compressed:int8"),
                          A, b, device="cpu")
        go = ((lambda: tr.run_workers(ROUNDS, record_every=1))
              if make == "sgd_workers"
              else lambda: tr.run(ROUNDS, record_every=1))
    with spans.recording() as log:
        go()
    rounds, top = _tree(log)
    assert len(rounds) == ROUNDS and top == [("solve", ["finish"])]
    # the legacy loop has no driver: its rounds are the step and the
    # read-back alone
    want = ["read_back"] if make == "sgd" else list(PARTS)
    assert all(kids == want for _, kids in rounds)


@pytest.mark.parametrize("codec", ["int8", "int4", "int2", "topk(r=0.125)"])
def test_payload_bytes_is_the_codecs_payload(data, codec):
    tr = _cocoa(data, f"compressed:{codec}")
    with spans.recording() as log:
        tr.run(ROUNDS)
    got = log.counted("payload_bytes")
    payload = K * tr.scheme.codec.wire_bytes(M)
    # one count a round, under its exchange span
    assert [n for _, n, _, _ in got] == [payload] * ROUNDS
    assert [log.spans[p].name for _, _, p, _ in got] == ["exchange"] * ROUNDS
    assert [t for _, _, _, t in got] == list(range(1, ROUNDS + 1))
    # the modelled wire carries the payload up and the aggregate down
    assert tr.comm_bytes_per_round() == 2 * payload


def _anchors(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(spans.ANCHOR)]


def test_a_profiler_session_records_the_spans_by_itself(data):
    tr = _cocoa(data)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hist = tr.run(ROUNDS)
    log = spans.profiled()
    rounds, top = _tree(log)
    assert [t for t, _ in rounds] == hist.rounds
    assert top == [("solve", ["finish"])]
    anchors = _anchors(prof)
    assert len(anchors) == ROUNDS
    offs = spans.anchor_offsets(log, anchors)
    assert sorted(offs) == [r.index for r in log.named("round")]
    # mapped by its round's offset, each round's draw covers the
    # coordinate draw's own aten::rand, within the offset's error
    rand = [e for e in prof.events() if e.name == "aten::rand"]
    assert len(rand) == ROUNDS
    for r, e in zip(log.named("round"), rand):
        off, err = offs[r.index]
        draw = next(c for c in log.children(r) if c.name == "draw")
        assert draw.start_ns / 1e3 + off - err <= e.time_range.start
        assert e.time_range.end <= draw.end_ns / 1e3 + off + err
    # a second session's log holds its own spans only
    with profile(activities=[ProfilerActivity.CPU]):
        tr.run(2)
    second = spans.profiled()
    assert second is not log and len(second.named("round")) == 2
    assert len(log.named("round")) == ROUNDS


def test_recording_inside_a_profiler_takes_the_spans(data):
    tr = _cocoa(data)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as log:
            tr.run(3)
    assert len(log.named("round")) == 3 and len(_anchors(prof)) == 3
    assert all(r.anchor_ns is not None for r in log.named("round"))


class _FakeEvent:
    """A CUDA event on the host: ``record`` stamps a counter."""
    stamps = made = 0

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1
        self.at = None

    def record(self):
        _FakeEvent.stamps += 1
        self.at = _FakeEvent.stamps

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return float(other.at - self.at)


def test_device_times_are_read_where_the_host_waits_anyway(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "made", 0)

    def read(t):
        return [s.device_ms for s in log.spans if s.name in "ab"
                and s.t == t]

    with spans.recording() as log:
        with spans.span("solve"):
            for t in (1, 2, 3, 4):
                with spans.span("round", t=t):
                    with spans.span("a", "cuda"):
                        pass
                    with spans.span("b", "cuda"):
                        pass
                    with spans.span("sync", sync=True):
                        # the round before is read as this wait begins
                        # (its own wait has passed); this one not yet
                        assert read(t - 1) == ([1.0, 1.0] if t > 1 else [])
                        assert read(t) == [None, None]
            # adjacent spans share a boundary event: three a round (a's
            # start, a's end = b's start, b's end), pooled once read, so
            # two rounds' worth serve every round
            assert _FakeEvent.made == 6
            assert read(4) == [None, None]
        # the last round's: read when the outermost span ends
        assert read(4) == [1.0, 1.0]
        with spans.span("c", "cuda"):
            pass
    assert log.named("c")[0].device_ms == 1.0        # read at the close
