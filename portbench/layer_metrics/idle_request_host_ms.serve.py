"""idle_request_host_ms.serve: device-idle ms a request inside its
`request` span (the server's side: the raw arrays to tensors, their
pageable copies, preprocessing, forward and argmax launches), from the
traced stretch's timeline with the program's span log on it
(`harness/spans.py`); the rest of the idle time is the client's (the
answer's fetch, the next hand-over). Nothing where the program logs no
such span."""

from __future__ import annotations

from portbench.harness import spans


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    from gdl_tpu_torch.utils import profiling

    return spans.idle_ms_per_unit(ctx.trace, spans.closed_spans(profiling),
                                  lambda name: name == "request")
