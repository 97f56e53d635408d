"""Device timings on the card: CUDA events around warm calls, and a
``torch.profiler`` trace that sums each kernel's device time by name.

    time_ms(fn, reps)                   # ms a call, by CUDA events
    device_ms(fn, reps, "scd_kernel")   # device ms a call, from a trace
    device_trace(fn)                    # every kernel's device time

``chip_smoke.py`` and the bench specs share these; each needs a card.
"""
from __future__ import annotations

import time

import torch

# device_trace's guard on each side of the traced window: marker
# kernels (``torch.cuda._sleep``, named "spin_kernel"), left out of every
# sum. A profiler session in a process that has traced before loses its
# first kernel records, more the more sessions came before (on an H100:
# 2 after chip_smoke.py's phase 5, 11-12 in phase 10, over 32 in phase
# 12 and ~53 in phase 15): the markers ahead take that loss, and a trace
# counts the markers it kept on each side. device_ms traces again with
# 4x the markers, up to MAX_MARKERS, while none ahead was kept
TRACE_MARKERS, MAX_MARKERS, MARKER = 32, 2048, "spin_kernel"


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events around ``reps`` warm
    calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel, guards=None):
    """Mean device milliseconds per call of ``fn``: the device time of
    every kernel whose name holds ``kernel`` (a substring, or a tuple of
    them: a form of several kernels is summed) in a ``torch.profiler``
    trace of ``reps`` warm calls, over ``reps``; "not measured" when the
    trace holds no such kernel, or kept no marker ahead of the calls
    (the profiler may then have lost some or all of their records) with
    ``MAX_MARKERS`` markers. The trace's guard counts are appended to
    ``guards`` when it is a list."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    markers = TRACE_MARKERS
    while True:
        trace = device_trace(lambda: [fn() for _ in range(reps)],
                             markers=markers)
        # a trace of no kernel but markers counts its markers on "either
        # side": the calls' records may all be lost with those ahead
        lost_all = trace["guard"]["markers_kept"].get("before", 0) == 0
        if not lost_all or markers >= MAX_MARKERS:
            break
        markers *= 4
    if guards is not None:
        guards.append(trace["guard"])
    hits = [v for name, v in trace.get("kernels", {}).items()
            if any(n in name for n in names)]
    if lost_all or not sum(v["calls"] for v in hits):
        return "not measured"
    return sum(v["device_ms"] for v in hits) / reps


def device_trace(fn, host=(), markers: int = TRACE_MARKERS) -> dict:
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA activities) and
    sum the device time of each kernel by name, with the device's busy
    share of the host window, and the host time of each CPU op whose
    name holds one of the ``host`` substrings. ``markers`` marker
    kernels run on each side of ``fn``; the trace says how many of them
    it kept. A trace that holds no device time says so instead of
    failing."""
    from torch.profiler import ProfilerActivity, profile

    def spin():
        for _ in range(markers):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spin()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
        spin()
    by_name, spans, host_ops, marks = {}, [], {}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if any(h in ev.name for h in host):
                n, us = host_ops.get(ev.name, (0, 0.0))
                host_ops[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
            continue
        start, end = ev.time_range.start, ev.time_range.end
        if MARKER in ev.name:
            marks.append(start)
            continue
        if end <= start:
            continue
        spans.append((start, end))
        name = ev.name if len(ev.name) <= 80 else ev.name[:77] + "..."
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + (end - start))
    host_ms = {name: {"calls": n, "host_ms": us / 1e3}
               for name, (n, us) in host_ops.items()}
    first = min(s_ for s_, _ in spans) if spans else None
    guard = dict(
        markers_kept=(dict(before=sum(m < first for m in marks),
                           after=sum(m > first for m in marks))
                      if spans else {"either side": len(marks)}),
        markers_launched=dict(before=markers, after=markers))
    if not spans:
        return dict(device_time="none in the trace", window_ms=window_us / 1e3,
                    guard=guard, **({"host_ops": host_ms} if host else {}))
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:             # the union of the device spans
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    device_span = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return dict(
        window_ms=window_us / 1e3, device_busy_ms=busy / 1e3,
        device_span_ms=device_span / 1e3,
        busy_share_of_window=busy / window_us,
        busy_share_of_device_span=busy / device_span,
        kernels={name: {"calls": n, "device_ms": us / 1e3}
                 for name, (n, us) in top}, guard=guard,
        **({"host_ops": host_ms} if host else {}))
