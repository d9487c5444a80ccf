"""h2d_copy_ms.train: device ms a step of host-to-device copies (the
raw batch's waveform, frames and labels), from the trace."""

from __future__ import annotations


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    ms = ctx.trace.ms_per_unit(["h2d_copy"])
    return ms if ms > 0 else None
