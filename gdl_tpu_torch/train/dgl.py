"""DGL steps, port of `gdl_tpu/train/dgl.py`. Only the eval step is
ported so far; the train step comes with the training slice."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def make_eval_step(model, preprocess: Optional[Callable] = None) -> Callable:
    """eval_step(batch) -> per-example argmaxes of the three logits, the
    label, and the logits themselves under 'logits' (out, out_a, out_v).

    The model is used as it is: the caller puts it in eval mode and
    chooses the autocast dtype."""

    @torch.inference_mode()
    def eval_step(batch):
        if preprocess is not None:
            batch = preprocess(batch)
        out, out_a, out_v = model(batch["audio"], batch["visual"])
        return {
            "pred": out.argmax(dim=-1),
            "pred_a": out_a.argmax(dim=-1),
            "pred_v": out_v.argmax(dim=-1),
            "label": batch["label"],
            "logits": (out, out_a, out_v),
        }

    return eval_step
