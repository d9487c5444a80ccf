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

The port runs one process on one device, so a raised flag stops the run
at once; gdl_tpu's multi-host agreement (an allgather of the flags every
`sync_every` steps) waits for the multi-GPU slice. `sync_every` is kept
in the signature so callers carry over.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


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
        resumed epoch excluded)."""
        if (self.trigger_after is not None
                and step_count >= self.trigger_after):
            self.trigger()
        return self.triggered()

    def agree(self) -> bool:
        """True iff the flag is raised. run_training calls it at each
        epoch end, so a flag raised after the last step's check still
        saves before the next epoch starts."""
        return self.triggered()
