"""optimizer_ms.train: device ms a training step of the optimizer's
foreach kernels (the gradient norm, the clip, SGD), from the trace."""

from __future__ import annotations


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    ms = ctx.trace.ms_per_unit(["optimizer_foreach"])
    return ms if ms > 0 else None
