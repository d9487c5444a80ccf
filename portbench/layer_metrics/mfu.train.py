"""mfu.train: model FLOP utilization of the whole training step over
the untraced window: the model FLOPs of every step the window
completed (`costs/<model>.py::train_flops`, independent of what implements
them) over the window's seconds, as a percentage of the card's
data-sheet peak in the configuration's precision."""

from __future__ import annotations

from portbench.harness import peaks
from portbench.harness.spec import cost_module


def read(ctx):
    if ctx.kind != "train":
        return None
    cost = cost_module(ctx.config["model"])
    flops = cost.train_flops(ctx.config, ctx.clips)
    return (100.0 * flops / ctx.window_s
            / peaks.PEAK_FLOPS[ctx.config["compute_dtype"]])
