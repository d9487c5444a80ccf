"""device_idle_share.serve: the share of the traced stretch, requests
served back to back, in which no operation (kernel, copy or set) ran on
the device, in percent: 100 · (1 − union of the operations' intervals /
the window), from one timeline. The host's share of a request's service:
its preprocessing, launches and the wait for the answer."""

from __future__ import annotations


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
