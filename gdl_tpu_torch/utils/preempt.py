"""Preemption-safe training, port of `gdl_tpu/utils/preempt.py`: catch
SIGTERM, checkpoint at the next step boundary, resume exactly mid-epoch.

A scheduler sends SIGTERM with a grace window that is usually far
smaller than an epoch. The guard below turns that signal into a clean
stop at the next STEP boundary, after which the loop saves a resume
state carrying `step_in_epoch`, and the resumed run replays the
remainder of the interrupted epoch:

- the device generator's state is part of the resume state
  (utils/checkpoint.py), so augmentation and DropPath draws continue
  where they stopped;
- host augmentation draws are per-(seed, epoch, sample-index)
  (data/datasets.py), independent of which batches were already consumed;
- the shuffle order is per-epoch deterministic (Loader.set_epoch), so
  skipping the first k batch index groups re-enters the same stream.

Several processes (`torchrun`) must stop at the SAME step, or the
survivors hang in the next collective. A local flag (each rank gets its
own SIGTERM from the scheduler) is therefore acted on only at an
agreement boundary: every `sync_every` steps the ranks all-reduce their
flags (MAX) and stop iff any rank flagged; a flag raised in the final
partial window is caught by the epoch-end `agree()` (run_training calls
it before eval). The all-reduce blocks the host: at the default of 32
steps that is one wait for the device every 32 steps. A run without a
process group, or of one rank, stops at once and pays nothing (a local
Event read).
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

import torch

from gdl_tpu_torch.parallel.distributed import all_reduce_, process_count


class PreemptionGuard:
    """Cooperative stop flag checked once per train step (a host-side
    Event read — zero device cost).

    `trigger_after` is a test hook: should_stop() flags itself once
    `step_count` reaches that value, exercising the exact save/resume path
    without delivering a real signal.
    """

    def __init__(self, sync_every: int = 32,
                 trigger_after: Optional[int] = None):
        self._event = threading.Event()
        self.sync_every = max(1, sync_every)
        self.trigger_after = trigger_after
        self._previous = {}  # signum -> previous handler (install/uninstall)

    # -- flag -------------------------------------------------------------
    def trigger(self, *_args) -> None:
        self._event.set()

    def triggered(self) -> bool:
        return self._event.is_set()

    # -- signal handlers ----------------------------------------------------
    def install(self, signals=(signal.SIGTERM,)) -> "PreemptionGuard":
        """Route `signals` to trigger(). No-op off the main thread
        (worker threads, pytest-xdist) — the guard still works via
        trigger()/trigger_after."""
        for s in signals:
            try:
                self._previous[s] = signal.signal(s, self.trigger)
            except ValueError:  # not the main thread
                pass
        return self

    def uninstall(self) -> None:
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._previous.clear()

    # -- the per-step check -------------------------------------------------
    def should_stop(self, step_count: int) -> bool:
        """True when training must stop AFTER the step just completed.
        `step_count` is 1-based within the epoch (skipped batches of a
        resumed epoch excluded; every rank counts alike)."""
        if (self.trigger_after is not None
                and step_count >= self.trigger_after):
            self.trigger()
        if process_count() == 1:
            return self.triggered()
        if step_count % self.sync_every:
            return False
        return self.agree()

    def agree(self) -> bool:
        """True iff the flag is raised on any rank (an all-reduce MAX of
        the flags; the local flag without a process group). Every rank
        calls it at the same points: should_stop's boundaries and
        run_training's epoch ends, so a flag raised after the last step's
        check still saves before the next epoch starts."""
        if process_count() == 1:
            return self.triggered()
        flag = torch.tensor([int(self.triggered())], dtype=torch.int32)
        return bool(all_reduce_(flag, "max").item())
