"""One ``torch.profiler`` session over a steady part of a run, reduced to
what the metric readers take: every device kernel (name, start, end),
the host's top-level operations, the device's busy time (the union of
the kernels' spans) and the traced window's length.

A process runs one session only: a session loses more of its first
records the more sessions the process has run before it."""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float = 0.0
    kernels: list = field(default_factory=list)    # (name, start_us, end_us)
    host: list = field(default_factory=list)       # (name, start_us, end_us)
    t0_us: float = 0.0                             # the window on the
    t1_us: float = 0.0                             # profiler's clock

    @property
    def busy_s(self) -> float:
        return busy_us(self.kernels) / 1e6

    def kernel_us(self, match) -> tuple[float, int]:
        """(device microseconds, launches) of the kernels whose name
        ``match(name)`` accepts."""
        hits = [(e - s) for n, s, e in self.kernels if match(n)]
        return float(sum(hits)), len(hits)


def busy_us(spans) -> float:
    """The length of the union of ``(name, start, end)`` spans."""
    iv = sorted((s, e) for _, s, e in spans if e > s)
    if not iv:
        return 0.0
    total, cs, ce = 0.0, *iv[0]
    for s, e in iv[1:]:
        if s > ce:
            total += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    return total + ce - cs


class Session:
    """``with Session() as tr: ...`` profiles the block; ``tr`` is the
    :class:`Trace` once the block has ended (the device drained)."""

    def __init__(self):
        self.trace = Trace()

    def __enter__(self) -> Trace:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU]
        if self._cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        # a marker pair on each side fixes the window on the profiler's
        # own clock
        with torch.profiler.record_function("cardbench_window_start"):
            pass
        self._t0 = time.perf_counter()
        return self.trace

    def __exit__(self, *exc):
        import torch
        if self._cuda:
            torch.cuda.synchronize()
        self.trace.window_s = time.perf_counter() - self._t0
        with torch.profiler.record_function("cardbench_window_end"):
            pass
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce()
        return False

    def _reduce(self) -> None:
        import torch
        tr = self.trace
        host, kernels, marks = [], [], {}
        for ev in self._prof.events():
            s, e = ev.time_range.start, ev.time_range.end
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if e > s:
                    kernels.append((ev.name, float(s), float(e)))
            elif ev.name.startswith("cardbench_window_"):
                marks[ev.name] = float(s)
            elif ev.cpu_parent is None:
                host.append((ev.name, float(s), float(e)))
        tr.t0_us = marks.get("cardbench_window_start",
                             min((s for _, s, _ in kernels), default=0.0))
        tr.t1_us = marks.get("cardbench_window_end",
                             max((e for _, _, e in kernels), default=0.0))
        tr.kernels = sorted(k for k in kernels
                            if k[2] > tr.t0_us and k[1] < tr.t1_us)
        tr.host = sorted(host, key=lambda h: h[1])


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between kernels named by the host operation that covered most
    of each gap, both summed by name: ``[[name, seconds], ...]``."""
    by_op: dict = {}
    for n, s, e in tr.kernels:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps: dict = {}
    iv = sorted((s, e) for _, s, e in tr.kernels)
    edges, end = [], tr.t0_us
    for s, e in iv:
        if s > end:
            edges.append((end, s))
        end = max(end, e)
    if tr.t1_us > end:
        edges.append((end, tr.t1_us))
    host = tr.host
    starts = [h[1] for h in host]
    import bisect
    for gs, ge in edges:
        best, cover = "idle (no host operation)", 0.0
        i = bisect.bisect_right(starts, ge)
        for name, hs, he in host[max(0, i - 64):i]:
            c = min(he, ge) - max(hs, gs)
            if c > cover:
                best, cover = name, c
        gaps[best] = gaps.get(best, 0.0) + (ge - gs)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    short = (lambda n: n if len(n) <= 120 else n[:117] + "...")
    return {"device_ops": [[short(n), us / 1e6] for n, us in ops],
            "idle_gaps": [[short(n), us / 1e6] for n, us in idle]}
