"""Step traces for `--profile_dir`, port of `gdl_tpu/utils/profiling.py`.

gdl_tpu captures steps 10-12 of the first epoch with `jax.profiler` into
an XSpace that TensorBoard's profile plugin reads. The port captures the
same steps with `torch.profiler` (CPU activity always, CUDA activity when
a card is present) and writes a Chrome trace-event JSON,
`<profile_dir>/rank<k>.<ms>.pt.trace.json`, that Perfetto and
TensorBoard's PyTorch profile plugin open: one file a process, the rank
of a `torchrun` group in its name, as `jax.profiler` writes one file a
host.

`annotate(name)` is a named span in that trace
(`torch.profiler.record_function`); the loops wrap every step in
`annotate("train_step")`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

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


def annotate(name: str):
    """Named region for the trace viewer."""
    return torch.profiler.record_function(name)
