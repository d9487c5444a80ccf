"""The program's span log (`gdl_tpu_torch/utils/profiling.py`) on a
traced stretch's timeline, and the device's idle time inside spans.

The program stamps its spans on the Unix clock (`time.time_ns()`); a
`Trace` keeps µs from the start of the profiler's trace. On a card the
profiler records CUDA activity alone, so the trace holds none of the
program's spans but every CUDA runtime call, among them the
`cudaMemcpyAsync` that each copy of a `data.h2d` span issues. One offset
puts the log on the trace's timeline: the median, over the stretch's
`data.h2d` spans, of the gap from a span's end to the end of the last
copy call inside it. The copy calls inside a span are found first on a
coarse offset: of the shifts that end a `data.h2d` span where a copy
call ends, the one under which the most spans hold copy calls with none
cutting across a span's edge (a span issues whole calls), and of those
the one that fits the spans tightest around their calls (a span's first
act is a copy, its last the return of one; the calls around a span, a
request's answer fetch or the next stage's copies, may also fit whole,
but loosely).

A reader takes the log as the program left it after the stretch: the
profiler records nowhere else in a run, so it holds the stretch alone;
spans that fall outside the trace's window are left out all the same.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Callable, Iterable, List, Optional, Tuple

ANCHOR = "data.h2d"
COPY_CALL = "cudaMemcpyAsync"
TOLERANCE_US = 20.0  # how far a copy call may stick out of its span


def closed_spans(profiling) -> Optional[list]:
    """The closed spans of the program's log, or None where the program
    logs none (a program without span log) or the log dropped records."""
    read = getattr(profiling, "spans", None)
    if read is None or getattr(profiling, "dropped", 0):
        return None
    return [s for s in read() if s.end_ns is not None]


def _calls(trace) -> List[Tuple[float, float]]:
    """The copy calls, host to device alone where the trace tells: the
    card runs one stream's copies in the order they were issued, so where
    the calls are as many as the device's `Memcpy` operations the k-th
    call issued the k-th operation, whose name gives its direction."""
    calls = sorted((s, e) for name, s, e in trace.host_ops
                   if name == COPY_CALL)
    copies = sorted((s, name) for name, s, _ in trace.device_ops
                    if name.startswith("Memcpy "))
    if len(copies) == len(calls):
        calls = [c for c, (_, name) in zip(calls, copies) if "HtoD" in name]
    return calls


def _against(calls, starts, longest: float, lo: float, hi: float):
    """(the copy calls inside [lo, hi], within the tolerance; whether any
    other copy call cuts across [lo, hi])."""
    inside, cut = [], False
    first = bisect.bisect_left(starts, lo - TOLERANCE_US - longest)
    for k in range(first, len(calls)):
        s, e = calls[k]
        if s > hi + TOLERANCE_US:
            break
        if s >= lo - TOLERANCE_US and e <= hi + TOLERANCE_US:
            inside.append(calls[k])
        elif s < hi and e > lo:
            cut = True
    return inside, cut


def offset_us(trace, log: list) -> Optional[float]:
    """µs to add to a span's time since `base(log)` to put it on the
    trace's timeline, or None where the stretch has no `data.h2d` span
    or no copy call inside one."""
    anchors = [s for s in log if s.name == ANCHOR]
    calls = _calls(trace)
    if not anchors or not calls:
        return None
    t0 = base(log)
    spans = [((s.start_ns - t0) / 1e3, (s.end_ns - t0) / 1e3)
             for s in anchors]
    starts = [s for s, _ in calls]
    longest = max(e - s for s, e in calls)

    def fit(d):  # (anchors that hold copy calls, none cut; − slack)
        held, slack = 0, []
        for s, e in spans:
            inside, cut = _against(calls, starts, longest, s + d, e + d)
            if inside and not cut:
                held += 1
                slack.append(inside[0][0] - s - d + e + d - inside[-1][1])
        return (held, -statistics.median(slack)) if held else (0, 0.0)

    candidates = {ce - e for _, ce in calls for _, e in spans}
    d = max(candidates, key=fit)
    if fit(d)[0] == 0:
        return None
    for _ in range(2):  # the last copy call of each span, then the median
        gaps = []
        for s, e in spans:
            inside, _ = _against(calls, starts, longest, s + d, e + d)
            if inside:
                gaps.append(max(ce for _, ce in inside) - e)
        if not gaps:
            return None
        d = statistics.median(gaps)
    return d


def base(log: list) -> int:
    """The ns the log's times are counted from."""
    return min(s.start_ns for s in log)


def on_trace(trace, log: list) -> Optional[list]:
    """[(span, start µs, end µs)] of the spans of `log` that overlap the
    trace's window, on the trace's timeline; None where no offset is
    found."""
    if not log:
        return None
    d = offset_us(trace, log)
    if d is None:
        return None
    t0 = base(log)
    lo, hi = trace.window
    out = []
    for s in log:
        start, end = (s.start_ns - t0) / 1e3 + d, (s.end_ns - t0) / 1e3 + d
        if end > lo and start < hi:
            out.append((s, start, end))
    return out


def union(intervals: Iterable[Tuple[float, float]]) -> list:
    """Sorted disjoint [start, end] pairs covering `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def idle(trace) -> list:
    """The window's stretches with no device operation, sorted: the
    complement of `Trace.merged()`."""
    lo, hi = trace.window
    edges = [lo] + [x for se in trace.merged() for x in se] + [hi]
    return [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def overlap_us(a: list, b: list) -> float:
    """µs in both of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_us(trace, placed: list, match: Callable[[str], bool]
                   ) -> float:
    """Device-idle µs of the window inside the placed spans whose name
    `match`es, each instant counted once however the spans nest or the
    threads overlap."""
    covered = union((s, e) for span, s, e in placed if match(span.name))
    return overlap_us(covered, idle(trace))


def idle_ms_per_unit(trace, log: Optional[list],
                     match: Callable[[str], bool]) -> Optional[float]:
    """Device-idle ms a step (or request) inside the matching spans, or
    None where the stretch has no device operation, no span log, no
    offset or no matching span."""
    if not trace.device_ops or not log or not trace.units:
        return None
    placed = on_trace(trace, log)
    if not placed or not any(match(span.name) for span, _, _ in placed):
        return None
    return idle_inside_us(trace, placed, match) / 1e3 / trace.units


def self_ms_per_unit(trace, log: Optional[list],
                     match: Callable[[str], bool]) -> Optional[float]:
    """Host ms a step (or request) of the matching spans' self time (each
    span's length less its child spans'), over the spans in the window;
    None as `idle_ms_per_unit`."""
    if not trace.device_ops or not log or not trace.units:
        return None
    placed = on_trace(trace, log)
    if not placed:
        return None
    children = {}
    for span in log:
        if span.parent is not None:
            key = id(span.parent)
            children[key] = (children.get(key, 0)
                             + span.end_ns - span.start_ns)
    own = [span.end_ns - span.start_ns - children.get(id(span), 0)
           for span, _, _ in placed if match(span.name)]
    if not own:
        return None
    return sum(own) / 1e6 / trace.units
