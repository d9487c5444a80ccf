"""One traced stretch of a run, reduced to what the per-layer metrics
read: the device operations (kernels, copies, sets) on one timeline, the
traced window (from the start of the stretch's first device operation to
the end of its last), the device's busy time (the union of its
operations' intervals), the idle gaps between them labelled by the CUDA
runtime call the host was in, and device time by kind (`kinds.py`).

On a card the profiler records CUDA activity alone: recording every host
operation as well slows a host-paced step, and the idle share would read
the profiler's own cost. A warm-up stretch runs under the profiler first
and its events are dropped, so the profiler's start is not traced.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from portbench.harness.kinds import kind_of

STEP = "ProfilerStep"  # the profiler's own span of a traced stretch
HOST_OUTSIDE = "host outside the CUDA runtime"


@dataclass
class Trace:
    device_ops: List[Tuple[str, float, float]]  # (name, start, end), µs
    host_ops: List[Tuple[str, float, float]]  # CUDA runtime calls on a card
    window: Tuple[float, float]  # µs on the same timeline
    units: int = 0  # steps or requests traced
    _merged: Optional[list] = field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def merged(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint [start, end] pairs."""
        if self._merged is None:
            lo, hi = self.window
            spans = sorted((max(s, lo), min(e, hi))
                           for _, s, e in self.device_ops if e > lo and s < hi)
            out = []
            for s, e in spans:
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            self._merged = out
        return self._merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e6

    def seconds_by_kind(self) -> dict:
        out = {}
        for name, s, e in self.device_ops:
            k = kind_of(name)
            out[k] = out.get(k, 0.0) + (e - s) / 1e6
        return out

    def ms_per_unit(self, kinds) -> float:
        """Device ms a step (or request) of the operations of `kinds`."""
        by_kind = self.seconds_by_kind()
        return sum(by_kind.get(k, 0.0) for k in kinds) * 1e3 / self.units

    def idle_gaps(self, count: int = 10) -> list:
        """The `count` longest stretches of the window with no device
        operation, as [label, seconds]: the label names the outermost and
        the innermost host operation open at the gap's middle."""
        lo, hi = self.window
        edges = [lo] + [x for se in self.merged() for x in se] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host_ops, key=lambda op: op[1])
        starts = [op[1] for op in host]
        out = []
        for s, e in gaps[:count]:
            mid = 0.5 * (s + e)
            open_ops = [op for op in host[:bisect.bisect_right(starts, mid)]
                        if op[2] > mid]
            if open_ops:
                outer = min(open_ops, key=lambda op: op[1])[0]
                inner = max(open_ops, key=lambda op: op[1])[0]
                label = outer if outer == inner else f"{outer} > {inner}"
            else:
                label = HOST_OUTSIDE
            out.append([label, (e - s) / 1e6])
        return out

    def breakdown(self) -> dict:
        ops = sorted(self.seconds_by_kind().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops[:10]],
                "idle_gaps": self.idle_gaps()}


@contextlib.contextmanager
def traced(device, warmup):
    """Trace the body with torch.profiler, CUDA activity alone on a card
    (the CPU's operations on the CPU), after `warmup()` has run under the
    profiler untraced. Yields a holder whose `.trace` is set on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    holder = type("Holder", (), {"trace": None})()
    activity = (ProfilerActivity.CUDA if device.type == "cuda"
                else ProfilerActivity.CPU)
    with profile(activities=[activity],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warmup()
        sync()
        prof.step()
        yield holder
        sync()
        prof.step()
    holder.trace = from_profiler(prof)


def from_profiler(prof) -> Trace:
    from torch.autograd import DeviceType

    device_ops, host_ops = [], []
    for ev in prof.events():
        span = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.name.startswith(STEP):
            continue
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                device_ops.append(span)
        else:
            host_ops.append(span)
    # an annotation's span on the device (record_function, the program's
    # `train_step`) has the name of its host span: it is no operation
    annotations = {name for name, _, _ in host_ops}
    device_ops = [op for op in device_ops if op[0] not in annotations]
    window = ((min(s for _, s, _ in device_ops),
               max(e for _, _, e in device_ops)) if device_ops else (0.0, 0.0))
    return Trace(device_ops, host_ops, window)
