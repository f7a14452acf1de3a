"""The harness's spans and its reading of a profiler trace.

Spans: the harness times its own calls into each layer with the host's
clock (``time.perf_counter_ns``), never waiting for the card, and keeps
them in memory.

A trace: ``torch.profiler`` with device activity only (host operators of
a zamba2 round run to hundreds of thousands) over whole rounds, started
and stopped after ``torch.cuda.synchronize()``.  It is reduced to the
device operations (kernels, copies, sets) as (name, start, end) in
seconds from the traced window's start, with the window's length and the
harness's spans on the same axis.  The window runs from the first device
operation to the synchronisation after the last round.  The profiler's
events are placed on the host's wall clock by its trace start where that
agrees with the host's clock (CUPTI's times are converted to it), else by
the moment the window opened.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class Spans:
    def __init__(self):
        self.records: List[Tuple[str, int, int]] = []   # perf_counter_ns

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter_ns()))

    def total_ms(self, name: str) -> float:
        return sum(e - s for n, s, e in self.records if n == name) / 1e6


@dataclass
class Trace:
    events: List[Tuple[str, float, float]]      # device ops, seconds
    window_s: float
    rounds: int
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    aligned_by: str = ""

    @property
    def busy_s(self) -> float:
        """The union of the device operations' intervals in the window."""
        busy, end = 0.0, 0.0
        for _, s, e in sorted(self.events, key=lambda r: r[1]):
            s, e = max(s, end), min(e, self.window_s)
            if e > s:
                busy += e - s
                end = e
        return busy

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the window, in order."""
        out, end = [], 0.0
        for _, s, e in sorted(self.events, key=lambda r: r[1]):
            if s > end:
                out.append((end, min(s, self.window_s)))
            end = max(end, e)
        if end < self.window_s:
            out.append((end, self.window_s))
        return [(a, b) for a, b in out if b > a]

    def span_at(self, t: float) -> str:
        for name, s, e in reversed(self.spans):
            if s <= t < e:
                return name
        return "between rounds"


def capture(torch, run_round, first_round: int, rounds: int,
            spans: Spans) -> Optional[Trace]:
    """Run ``rounds`` rounds under the profiler -> their Trace, or None
    where the profiler recorded no device operation."""
    act = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    mark = len(spans.records)
    with torch.profiler.profile(activities=act) as prof:
        wall0 = time.time_ns()
        t0 = time.perf_counter_ns()
        for r in range(first_round, first_round + rounds):
            run_round(r)
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    start_ns = None
    try:
        start_ns = int(prof.profiler.kineto_results.trace_start_ns())
    except AttributeError:  # an older profiler without the accessor
        pass
    if start_ns is not None and abs(start_ns - wall0) < 1_000_000_000:
        # the events' times are offsets from the profiler's own start
        base, how = (start_ns - wall0) / 1e9, "profiler trace start"
    else:
        base, how = 0.0, "window start"
    events = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s = base + e.time_range.start / 1e6
        events.append((e.name, s, s + (e.time_range.end
                                       - e.time_range.start) / 1e6))
    if not events:
        return None
    # the window opens at the first device operation: the host's prelude
    # to the first traced round, which a steady run overlaps with the
    # round before, is not counted as idle time
    first = max(0.0, min(s for _, s, _ in events))
    events = [(n, s - first, e - first) for n, s, e in events]
    host = [(n, (s - t0) / 1e9 - first, (e - t0) / 1e9 - first)
            for n, s, e in spans.records[mark:]]
    return Trace(events, (t1 - t0) / 1e9 - first, rounds, host, how)


def breakdown(trace: Trace, top: int = 10):
    """The device operations that took most time, and the longest idle
    gaps named by the harness span open when each began."""
    by_name = {}
    for name, s, e in trace.events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[trace.span_at(a), b - a] for a, b in gaps]}
