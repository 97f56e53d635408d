"""Spans and counters at the round driver's layer boundaries.

The drivers (``core/cocoa.py::record_rounds``, ``round_step``, the virtual
and sharded rounds of ``core/distributed.py`` and the trainers' runs)
open one span at each boundary of a run::

    solve           a trainer's run, set-up to the state on the host
      round [t]     one round, on History's own clock reads
        draw        the round's coordinates or rows (the index source)
        local_step  every worker's local solve (K1 under scd_kernel)
        exchange    the masks, the encode, the collective, the decode
        apply       the shared state absorbs the aggregate
        metric      the per-worker metric, its sum and the primal
        read_back   the host waits for the round's primal
      finish        the pending aggregates, the state to the host

and count ``payload_bytes`` (the encoded payload as the codec produced
it, a round) at the exchange and ``rounds`` at the end of a solve.

A span records only inside :func:`recording` (the operator's way in:
``with spans.recording() as log: trainer.run(...)``) or while a
``torch.profiler`` session is active, whose log :func:`profiled` returns.
Otherwise :func:`span` returns one shared object that does nothing: no
allocation, no clock read, no CUDA event, no profiler call.

What a span keeps: its name, its parent, the round ``t`` it belongs to,
host start and end (``time.perf_counter_ns``) and, where it is given a
CUDA device, its device milliseconds, from CUDA events recorded on the
current stream (drawn from a pool; adjacent spans share a boundary
event). The events of the spans that ended before a span marked
``sync`` (the read-back, the finish) are read when the next ``sync``
span begins, or when the outermost span ends: by then the host has
waited for them, so the spans add no synchronise, and the reads fall
where the host is about to wait for the device again, not where the
device waits for the host. On the CPU ``device_ms`` is ``None``.

While a profiler is active each ``round`` places one zero-length
profiler range, named ``ANCHOR`` and the round's index in the log, and
keeps its ``perf_counter_ns``: :func:`anchor_offsets` maps every span of
the round onto the profiler's clock by one offset a round. The anchor
falls where the round's read-back begins (at the round's end where it
has none), so its cost too overlaps the device's work. No span opens a
profiler range around device work, so a device trace shows no span.
"""
from __future__ import annotations

import contextlib
import contextvars
from time import perf_counter_ns

import torch

ANCHOR = "repro_torch.spans.anchor#"

_RECORDING: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_span_log", default=None)
_profiler_enabled = torch.autograd._profiler_enabled


class Span:
    """One recorded span. ``index`` and ``parent`` are positions in its
    log's ``spans``; ``anchor_ns`` holds the host clock's reads before,
    inside and after the span's profiler anchor (``None`` without one)."""

    __slots__ = ("name", "index", "parent", "t", "start_ns", "end_ns",
                 "device_ms", "anchor_ns", "_log", "_cuda",
                 "_anchor", "_sync", "_ev0", "_ev1", "_ready_at")

    def __init__(self, log, name, device, t, start_ns, anchor, sync):
        self.name, self.t, self.start_ns = name, t, start_ns
        self.index = self.parent = self.end_ns = self.device_ms = None
        self.anchor_ns = None
        self._log, self._anchor, self._sync = log, anchor, sync
        self._cuda = (not sync and device is not None
                      and torch.device(device).type == "cuda")
        self._ev0 = self._ev1 = self._ready_at = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def stop(self, end_ns: int) -> None:
        """End the span at ``end_ns`` (a clock read the caller took)
        instead of at its exit."""
        self.end_ns = end_ns

    def __enter__(self):
        log = self._log
        if log._stack:
            up = log._stack[-1]
            self.parent = up.index
            if self.t is None:
                self.t = up.t
        self.index = len(log.spans)
        log.spans.append(self)
        log._stack.append(self)
        if self.start_ns is None:
            self.start_ns = perf_counter_ns()
        if self._cuda:
            self._ev0 = log._boundary()
        else:
            log._tail = None
        if self._sync:
            # the host is about to wait for the device: read what the
            # last wait made ready and anchor the round here
            log._settle()
            if self.parent is not None:
                log.spans[self.parent]._place_anchor()
            self._ready_at = len(log._pending)
        return self

    def _place_anchor(self) -> None:
        if self._anchor and self.anchor_ns is None and _profiler_enabled():
            mark = torch._C._profiler._RecordFunctionFast(
                f"{ANCHOR}{self.index}")
            ns0 = perf_counter_ns()
            mark.__enter__()
            ns1 = perf_counter_ns()
            mark.__exit__(None, None, None)
            self.anchor_ns = (ns0, ns1, perf_counter_ns())

    def __exit__(self, *exc):
        log = self._log
        if self._cuda:
            self._ev1 = log._event()
            log._tail = self._ev1
            log._pending.append(self)
        else:
            log._tail = None
        if self.end_ns is None:
            self.end_ns = perf_counter_ns()
        self._place_anchor()
        log._stack.pop()
        if self._sync:
            log._ready = self._ready_at
        elif not log._stack:
            log._settle()
        return False


class _Off:
    """The shared span of a run that records nothing."""

    __slots__ = ()

    def stop(self, end_ns: int) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class SpanLog:
    """The spans (in the order they opened) and counters ``(name, n,
    parent index, t)`` of a :func:`recording` or a profiler session."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: list[tuple] = []
        self._stack: list[Span] = []
        self._pending: list[Span] = []
        self._ready = 0
        self._tail = None
        self._free: list = []

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, span: Span) -> list[Span]:
        return [s for s in self.spans if s.parent == span.index]

    def counted(self, name: str) -> list[tuple]:
        return [c for c in self.counters if c[0] == name]

    def _event(self):
        ev = self._free.pop() if self._free else torch.cuda.Event(
            enable_timing=True)
        ev.record()
        return ev

    def _boundary(self):
        """The start event of a device span: the previous device span's
        end when nothing came between them."""
        if self._tail is None:
            self._tail = self._event()
        return self._tail

    def _settle(self, wait: bool = False) -> None:
        """Read the device times of the spans that ended before the
        last sync span (all of them with ``wait``, which waits for their
        events: only once the run is over), and pool their events: no
        later span shares one, since a sync span breaks the chain."""
        n = len(self._pending) if wait else self._ready
        done = {}
        for s in self._pending[:n]:
            if wait:
                s._ev1.synchronize()
            s.device_ms = s._ev0.elapsed_time(s._ev1)
            done[id(s._ev0)], done[id(s._ev1)] = s._ev0, s._ev1
            s._ev0 = s._ev1 = None
        del self._pending[:n]
        self._ready = 0
        self._free.extend(done.values())

    def close(self) -> None:
        self._tail = None
        self._settle(wait=True)


class _Profiled:
    log: SpanLog | None = None
    read: bool = False


_PROFILED = _Profiled()


def _current() -> SpanLog | None:
    """The log a span opened now records into: the innermost
    :func:`recording`'s, else the running profiler session's, else
    none."""
    log = _RECORDING.get()
    if log is None and _profiler_enabled():
        if _PROFILED.log is None or _PROFILED.read:
            _PROFILED.log, _PROFILED.read = SpanLog(), False
        log = _PROFILED.log
    return log


def span(name: str, device=None, *, t: int | None = None,
         start_ns: int | None = None, anchor: bool = False,
         sync: bool = False):
    """A span named ``name`` for a ``with`` block. ``device``: where the
    block enqueues work (a CUDA device: its device time is taken);
    ``t``: its round (default its parent's); ``start_ns``: a clock read
    the caller already took at its start; ``anchor``: place the
    profiler anchor (at the first ``sync`` child's start, else at the
    end); ``sync``: the host waits for the device inside the block, so
    every device span before it can be read (it takes no device time
    of its own)."""
    log = _current()
    if log is None:
        return _OFF
    return Span(log, name, device, t, start_ns, anchor, sync)


def count(name: str, n: int) -> None:
    """Count ``n`` of ``name`` under the innermost open span."""
    log = _current()
    if log is None:
        return
    up = log._stack[-1] if log._stack else None
    log.counters.append((name, int(n), None if up is None else up.index,
                         None if up is None else up.t))


def active() -> bool:
    """Whether a span opened now would record."""
    return _RECORDING.get() is not None or _profiler_enabled()


@contextlib.contextmanager
def recording():
    """Record every span and counter of the block into the yielded
    :class:`SpanLog` (its device times read once the block ends)."""
    log = SpanLog()
    token = _RECORDING.set(log)
    try:
        yield log
    finally:
        _RECORDING.reset(token)
        log.close()


def profiled() -> SpanLog | None:
    """The log of the spans recorded under the most recent profiler
    session (``None`` before any). Read once that session has ended:
    the next session then records into a new log (unread, a log takes
    the next session's spans too)."""
    log = _PROFILED.log
    if log is not None and not _profiler_enabled():
        log.close()
        _PROFILED.read = True
    return log


def anchor_offsets(log: SpanLog, anchors) -> dict:
    """``{round index: (offset us, error us)}``: what to add to a span's
    ``ns / 1e3`` of that round to place it on the profiler's clock, from
    ``anchors``, the ``(name, start us, end us)`` of the profiler's
    events named ``ANCHOR<index>`` (other names are skipped).

    The anchor's start lies between the host's reads before and inside
    it, and its end between the reads inside and after it, so its start
    lies where both bounds allow; the offset takes the middle of that
    interval and the error is half its width."""
    out = {}
    for name, start_us, end_us in anchors:
        if not name.startswith(ANCHOR):
            continue
        s = log.spans[int(name[len(ANCHOR):])]
        b, i, a = (ns / 1e3 for ns in s.anchor_ns)
        d = end_us - start_us
        lo, hi = max(b, i - d), min(i, a - d)
        out[s.index] = (start_us - (lo + hi) / 2, abs(hi - lo) / 2)
    return out
