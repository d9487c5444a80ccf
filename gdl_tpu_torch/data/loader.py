"""Host-side batching loader with threaded prefetch, a copy of
`gdl_tpu/data/loader.py` (numpy only).

Replaces torch DataLoader(num_workers=32, pin_memory, drop_last)
(main_dgl.py:284-288). The heavy per-sample compute already moved on-device
(see preprocess.py), so the host side is IO-bound decode — a thread pool
(PIL/scipy release the GIL for the hot parts) plus a bounded prefetch queue
that keeps batches ready while the device runs the previous step.

drop_last=True is the reference's setting for BOTH train and test loaders;
the test-side truncation changes reported accuracy (SURVEY §5.5), so it is
kept for train, and controlled by cfg.eval_drop_last for eval.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


class Loader:
    """batch_size is always the GLOBAL batch. Over several processes
    (process_count > 1: the ranks of torchrun's group,
    `train/loop.py::make_loaders`) each rank decodes ONLY its contiguous
    batch_size/process_count slice of every batch — the shuffle order is
    seed-deterministic and identical on all ranks, so the slices partition
    each global batch exactly."""

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 drop_last: bool, num_workers: int = 8, seed: int = 0,
                 prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self._epoch = 0
        self._skip = 0
        if process_count > 1:
            if batch_size % process_count:
                raise ValueError(
                    f"global batch {batch_size} must divide process count "
                    f"{process_count}")
            if not drop_last:
                raise ValueError(
                    "multi-host sharded loading requires drop_last=True "
                    "(a ragged final batch cannot partition evenly)")

    @property
    def local_batch(self) -> int:
        return self.batch_size // self.process_count

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(idx)
        nb = len(self)
        lo = self.process_index * self.local_batch
        skip, self._skip = self._skip, 0
        for b in range(nb):
            if b < skip:  # mid-epoch resume: re-enter the deterministic
                continue  # stream past the already-trained batches
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if self.process_count > 1:
                chunk = chunk[lo:lo + self.local_batch]
            if chunk:
                yield chunk

    def _collate(self, pool: ThreadPoolExecutor, indices) -> dict:
        # whole-batch native fast path over the offline-preprocessed
        # cache (datasets._AVListDataset.collate_cached: one GIL-released
        # C call preads straight into the final batch arrays — bitwise-
        # equal to the per-sample path below, tests/test_preprocessed.py);
        # None → per-sample path (no cache, partial cache, no native lib)
        fast = getattr(self.dataset, "collate_cached", None)
        if fast is not None:
            out = fast(indices, nthreads=self.num_workers)
            if out is not None:
                batch = {"wave": out[0], "frames": out[1],
                         "label": out[2]}
                if len(out) > 3:
                    batch["frame_sizes"] = out[3]
                return batch
        samples = list(pool.map(self.dataset.__getitem__, indices))
        if isinstance(samples[0], dict):
            # pre-tensorized datasets (e.g. preprocessed synthetic sets in
            # tests) yield dicts; stack per key with no raw-contract names
            return {k: (np.asarray([s[k] for s in samples], np.int32)
                        if k == "label"
                        else np.stack([s[k] for s in samples]))
                    for k in samples[0]}
        waves = np.stack([s[0] for s in samples])
        frames = np.stack([s[1] for s in samples])
        labels = np.asarray([s[2] for s in samples], np.int32)
        batch = {"wave": waves, "frames": frames, "label": labels}
        if len(samples[0]) > 3:  # per-frame original sizes (crop geometry)
            batch["frame_sizes"] = np.stack([s[3] for s in samples])
        return batch

    def skip_next_batches(self, n: int) -> None:
        """The next __iter__ silently drops the first `n` batch index
        groups (no decode cost) — used with set_epoch by mid-epoch resume
        (utils/preempt.py) to continue an interrupted epoch's shuffle and
        augmentation stream at the exact batch where training stopped."""
        self._skip = int(n)

    def set_epoch(self, epoch: int) -> None:
        """Align the shuffle/augmentation epoch for RESUMED runs: the next
        __iter__ behaves as 0-indexed training epoch `epoch`. Without this
        a fresh Loader restarts its internal counter at 0, so a resumed
        epoch k would replay epoch 0's shuffle order and augmentation
        draws — continuous-vs-resumed runs then differ (caught by
        tests/test_end_to_end.py::test_resume_equivalence_flagship_width).
        """
        self._epoch = epoch

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        q: "queue.Queue[Optional[dict]]" = queue.Queue(maxsize=self.prefetch)
        err = []
        stop = threading.Event()  # consumer abandoned the epoch early
        # (preemption mid-epoch, utils/preempt.py) — unblock the producer

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for indices in self._batch_indices():
                        if not _put(self._collate(pool, indices)):
                            return
            except Exception as e:  # surface in consumer
                err.append(e)
            finally:
                _put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
