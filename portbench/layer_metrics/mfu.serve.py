"""mfu.serve: model FLOP utilization of the whole eval step over its
service time: the model FLOPs of every request the untraced window
completed (`costs/<model>.py::eval_flops`, independent of what implements
them) over the sum of their service times (from a request's hand-over
to the server to its answer on the host, the waits between arrivals
left out), as a percentage of the card's data-sheet peak in the
configuration's precision."""

from __future__ import annotations

from portbench.harness import peaks
from portbench.harness.spec import cost_module


def read(ctx):
    if ctx.kind != "serve":
        return None
    cost = cost_module(ctx.config["model"])
    flops = cost.eval_flops(ctx.config, ctx.clips)
    return (100.0 * flops / ctx.service_s
            / peaks.PEAK_FLOPS[ctx.config["compute_dtype"]])
