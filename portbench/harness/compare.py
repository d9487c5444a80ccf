"""The numbers that decide `correct`, and their limits.

Training (the first three steps of the object the window then drives,
against the reference's three steps from the same weights, batches and
augmentation draws):
- `loss_gap`: the largest |loss − reference loss| / |reference loss| of
  the three steps;
- `grad_gap`: over the leaves, the largest gap between the norm of the
  program's first gradient as its optimizer got it (clipped, worked out
  from the momentum after one step) and the reference's, over the
  larger of the reference leaf's norm and the median leaf's;
- `change_gap`: the same of the change of each leaf (parameters and
  BatchNorm running statistics) over the three steps.
Parameters whose reference gradient is under a thousandth of the median
leaf's gradient norm are left out of both: such a leaf moves by
round-off and weight decay alone (the concat head's unused `fc_auxi`
gets no gradient on either side).

Serving (a sample of the requests served in the window, drawn from the
seed, against the reference's eval forward of the same raw batches):
- `logit_gap`: the largest |logit − reference logit| over the sample's
  clips and three heads, over the largest |reference logit| of that
  request and head;
- `answer_gap`: the largest amount, on that scale, by which the
  program's own logit of the class it answered lies below its best
  logit: 0 where every answer is the argmax of the logits served with
  it, an exact comparison (the logits themselves are held to the
  reference by `logit_gap`).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def trained_leaves(ref_grad: Dict[str, float]) -> set:
    med = statistics.median(ref_grad.values())
    return {n for n, g in ref_grad.items() if g >= EXCLUDE_BELOW * med}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: Iterable[str]) -> float:
    names = sorted(names)
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"losses": [3 floats], "grad": {leaf: norm}, "change":
    {leaf: norm}} → the three numbers."""
    kept = trained_leaves(ref["grad"])
    buffers = set(ref["change"]) - set(ref["grad"])
    loss = max(abs(p - r) / abs(r)
               for p, r in zip(prog["losses"], ref["losses"]))
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(prog["grad"], ref["grad"], kept),
            "change_gap": leaf_gap(prog["change"], ref["change"],
                                   kept | buffers)}


def serve_numbers(served: list, reference: list) -> Dict[str, float]:
    """served: [(logits (out, out_a, out_v), answers (3 arrays))] and
    reference: [logits (out, out_a, out_v)], numpy, one entry a checked
    request → the two numbers."""
    import numpy as np

    logit, answer = 0.0, 0.0
    for (logits, answers), ref in zip(served, reference):
        for got, picked, want in zip(logits, answers, ref):
            scale = float(np.abs(want).max())
            logit = max(logit, float(np.abs(got - want).max()) / scale)
            chosen = np.take_along_axis(
                got, picked[:, None].astype(np.int64), axis=1)[:, 0]
            answer = max(answer,
                         float((got.max(axis=1) - chosen).max()) / scale)
    return {"logit_gap": logit, "answer_gap": answer}


def verdict(numbers: Dict[str, float], limits: dict):
    """(correct, checks): every number finite and at or under its limit;
    checks = {name: {"value", "limit"}} in the limits file's order."""
    checks, ok = {}, True
    for name, spec in limits["numbers"].items():
        value = numbers.get(name, float("nan"))
        limit = float(spec["limit"])
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
