"""Evaluation accounting with reference semantics, a copy of
`gdl_tpu/utils/metrics.py` (numpy only).

The reference computes overall + per-modality top-1 via a per-sample
softmax/argmax python loop with per-class counters (main_dgl.py:189-219).
Argmax of softmax == argmax of logits, so the device returns argmaxes per
batch and the host accumulates per-class counts — numerically identical,
without the reference's per-sample GPU syncs.

`obtain_top1_accuracy` mirrors utils/evaluation.py:4-15 (present in the
reference but unused by its entry scripts).
"""

from __future__ import annotations

import numpy as np


class PerClassAccuracy:
    """num[c], acc[c], acc_a[c], acc_v[c] counters (main_dgl.py:189-192)."""

    def __init__(self, n_classes: int):
        self.num = np.zeros(n_classes, np.float64)
        self.acc = np.zeros(n_classes, np.float64)
        self.acc_a = np.zeros(n_classes, np.float64)
        self.acc_v = np.zeros(n_classes, np.float64)

    def update(self, pred, pred_a, pred_v, label):
        label = np.asarray(label)
        np.add.at(self.num, label, 1.0)
        np.add.at(self.acc, label, (np.asarray(pred) == label).astype(float))
        np.add.at(self.acc_a, label,
                  (np.asarray(pred_a) == label).astype(float))
        np.add.at(self.acc_v, label,
                  (np.asarray(pred_v) == label).astype(float))

    def results(self):
        total = self.num.sum()
        if total == 0:
            return 0.0, 0.0, 0.0
        return (self.acc.sum() / total, self.acc_a.sum() / total,
                self.acc_v.sum() / total)

    def per_class(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(self.num > 0, self.acc / self.num, 0.0)


def obtain_top1_accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    """Top-1 accuracy (utils/evaluation.py:4-15 capability)."""
    return float((np.argmax(logits, axis=-1) == labels).mean())
