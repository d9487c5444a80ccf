"""Step traces for `--profile_dir`, port of `gdl_tpu/utils/profiling.py`,
and the program's spans.

gdl_tpu captures steps 10-12 of the first epoch with `jax.profiler` into
an XSpace that TensorBoard's profile plugin reads. The port captures the
same steps with `torch.profiler` (CPU activity always, CUDA activity when
a card is present) and writes a Chrome trace-event JSON,
`<profile_dir>/rank<k>.<ms>.pt.trace.json`, that Perfetto and
TensorBoard's PyTorch profile plugin open: one file a process, the rank
of a `torchrun` group in its name, as `jax.profiler` writes one file a
host.

`annotate(name, unit=None)` is the program's one span API, written where
the work happens: the loop's `data.next`, `data.pin`, `data.h2d`,
`train_step` and `metrics.fetch`; the DGL step's `preprocess`,
`forward`, `backward`, `clip` and `optimizer`; the server's `request`
and the eval step's `preprocess`, `forward` and `answer`; each hand
kernel's op wrapper as `kernel.<its launch_counts key>`. While no torch
profiler records (`torch.autograd.profiler._is_profiler_enabled`, which
the profiler sets when its trace starts and clears when it stops) it
returns one shared no-op context manager. While one records, the span
enters `record_function(name)`, so the profiler's trace shows it, and
appends a `Span` to the log that `spans()` returns: its name, its start
and end in `time.time_ns()` (the Unix clock, which kineto stamps its
events on), its thread, its parent (the span open on the same thread
when it began) and its unit, the index of the step or request it
belongs to: the `unit` it was given, else its parent's, else (a span on
autograd's device thread, say a kernel wrapper in the backward) that of
the span with a unit open on the main thread. The log holds at most
`SPAN_CAP` records; `dropped` counts those past it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from gdl_tpu_torch.parallel.distributed import process_index

# (profiler, path) of the open trace: one a process, as torch.profiler
# (and jax.profiler, whose global trace gdl_tpu's step_trace starts and
# stops) allows
_active: Optional[tuple] = None


def _start(profile_dir: str) -> None:
    global _active
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "rank{}.{}.pt.trace.json".format(
        process_index(), int(time.time() * 1000)))
    prof = profile(activities=activities)
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the steps before the window have ended
    prof.start()
    _active = (prof, path)


def stop_trace() -> Optional[str]:
    """Close the open trace, if any, and write its file → its path. The
    loop calls it at the end of every epoch, so an epoch of fewer steps
    than the window still writes a closed trace (gdl_tpu leaves its trace
    open there)."""
    global _active
    if _active is None:
        return None
    prof, path = _active
    _active = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the traced steps' kernels have ended
    prof.stop()
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def step_trace(profile_dir: Optional[str], step: int, start: int = 10,
               num: int = 3):
    """Trace steps [start, start + num) of an epoch into profile_dir."""
    if profile_dir and step == start:
        _start(profile_dir)
    try:
        yield
    finally:
        if profile_dir and step == start + num - 1:
            stop_trace()


SPAN_CAP = 1_000_000
_log: list = []
dropped = 0  # spans past SPAN_CAP, not logged
_log_lock = threading.Lock()
_open = threading.local()  # .stack: the thread's open spans, innermost last
_unit = None  # the unit of the span with a unit open on the main thread
_OFF = contextlib.nullcontext()


class Span:
    """One logged span; `end_ns` is None while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "parent", "unit")

    def __init__(self, name, start_ns, thread, parent, unit):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.thread, self.parent, self.unit = thread, parent, unit


class _Recording:
    """`annotate`'s span while a profiler records."""

    __slots__ = ("_name", "_unit", "_rf", "_span", "_prior")

    def __init__(self, name: str, unit):
        self._name, self._unit = name, unit
        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        global _unit, dropped
        self._rf.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        unit = self._unit
        if unit is not None:
            self._prior, _unit = _unit, unit
        elif parent is not None:
            unit = parent.unit
        else:
            unit = _unit
        span = Span(self._name, time.time_ns(), threading.get_ident(),
                    parent, unit)
        with _log_lock:  # the autograd thread logs too
            if len(_log) < SPAN_CAP:
                _log.append(span)
            else:
                dropped += 1
        stack.append(span)
        self._span = span
        return self

    def __exit__(self, *exc):
        global _unit
        self._span.end_ns = time.time_ns()
        _open.stack.pop()
        if self._unit is not None:
            _unit = self._prior
        return self._rf.__exit__(*exc)


def annotate(name: str, unit=None):
    """The span `name` around a `with` block: a no-op while no profiler
    records; else a `record_function` and a record in the log. `unit`
    (the step's or request's index) is given where a unit begins."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, unit)


def spans() -> list:
    """The logged spans, in the order they began."""
    return list(_log)


def reset_spans() -> None:
    global dropped
    with _log_lock:
        _log.clear()
        dropped = 0
