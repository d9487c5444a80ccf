"""idle_host_data_ms.train: device-idle ms a training step inside the
loop's host data spans (`data.next`, `data.pin`, `data.h2d`: the
loader's next batch, its pinning, its copies' launch), from the traced
stretch's timeline with the program's span log on it
(`harness/spans.py`). Nothing where the program logs no such span."""

from __future__ import annotations

from portbench.harness import spans


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    from gdl_tpu_torch.utils import profiling

    return spans.idle_ms_per_unit(ctx.trace, spans.closed_spans(profiling),
                                  lambda name: name.startswith("data."))
