"""wa_attn_bwd_roofline: the share of its roofline that kernel #4
(`wa_bwd_kernel`), every block of both encoders reaches, in percent: the
sum of each launch's bound a step (the larger of its bytes over 3.35
TB/s and its operations over the float32 peak, `costs/`) over the device
time a step of the kernels the frozen classification files under it.
Nothing where no such kernel ran."""

from __future__ import annotations

from portbench.harness.spec import cost_module

KINDS = ["window_attention_bwd (#4)"]


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    ms = ctx.trace.ms_per_unit(KINDS)
    if ms <= 0:
        return None
    cost = cost_module("window_attention")
    bound = cost.pass_bound_ms("bwd", ctx.config, ctx.batch,
                               ctx.batch * ctx.config["frames"])
    return 100.0 * bound / ms
