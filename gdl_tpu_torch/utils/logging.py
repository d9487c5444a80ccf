"""CSV / TensorBoard logging with reference formats (SURVEY §5.5), a copy
of `gdl_tpu/utils/logging.py`.

- Per-epoch accuracy CSV `{ckpt_path}/{dataset}_{modality}.csv` with the
  sentinel row [1000, 1000, 1000] at run start (main_dgl.py:292-295,
  :345-347).
- Per-step encoder grad-magnitude CSV `audio_visual_grad_vanilla.csv`
  (main_dgl.py:148-152) — buffered here and flushed at an interval instead
  of an fopen per step, same file contents.
- Optional TensorBoard 'Loss' / 'Evaluation' scalar groups
  (main_dgl.py:306-331) under --use_tensorboard; `torch.utils.tensorboard`
  (and so the `tensorboard` package) is imported only then.

Under a process group only rank 0 writes: on the other ranks both
loggers take every call and write nothing.
"""

from __future__ import annotations

import csv
import os
from typing import Iterable, Optional

from gdl_tpu_torch.parallel.distributed import is_primary


class CSVLogger:
    def __init__(self, path: str, sentinel: Optional[Iterable] = None,
                 flush_every: int = 1):
        self.path = path
        self.flush_every = flush_every
        self._buffer = []
        self.enabled = is_primary()
        dirname = os.path.dirname(path)
        if dirname and self.enabled:
            os.makedirs(dirname, exist_ok=True)
        if sentinel is not None:
            self.write_row(list(sentinel))
            self.flush()

    def write_row(self, row):
        if not self.enabled:
            return
        self._buffer.append(list(row))
        if len(self._buffer) >= self.flush_every:
            self.flush()

    def flush(self):
        if not self._buffer:
            return
        with open(self.path, "a+", newline="") as f:
            writer = csv.writer(f, delimiter=",")
            writer.writerows(self._buffer)
        self._buffer.clear()

    def close(self):
        self.flush()


class TBLogger:
    """A SummaryWriter at {tensorboard_path}/{dataset}/{fusion}_{modulation},
    made once a run (the reference makes it anew every epoch,
    main_dgl.py:312; not kept)."""

    def __init__(self, tensorboard_path: str, dataset: str,
                 fusion_method: str, modulation: str):
        self.writer = None
        if not is_primary():
            return
        from torch.utils.tensorboard import SummaryWriter

        writer_path = os.path.join(tensorboard_path, dataset)
        os.makedirs(writer_path, exist_ok=True)
        log_name = "{}_{}".format(fusion_method, modulation)
        self.writer = SummaryWriter(os.path.join(writer_path, log_name))

    def log_epoch(self, epoch: int, losses: dict, accs: dict):
        if self.writer is not None:
            self.writer.add_scalars("Loss", losses, epoch)
            self.writer.add_scalars("Evaluation", accs, epoch)

    def close(self):
        if self.writer is not None:
            self.writer.close()
