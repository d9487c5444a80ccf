"""wrapper_host_ms.train: host ms a training step in the hand kernels'
op wrappers, from their operand checks to the return of the launch: the
self time of the program's `kernel.*` spans in the traced stretch
(`harness/spans.py`). Nothing where the program logs no such span."""

from __future__ import annotations

from portbench.harness import spans


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    from gdl_tpu_torch.utils import profiling

    return spans.self_ms_per_unit(ctx.trace, spans.closed_spans(profiling),
                                  lambda name: name.startswith("kernel."))
