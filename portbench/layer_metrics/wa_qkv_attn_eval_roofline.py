"""wa_qkv_attn_eval_roofline: the share of its roofline that kernel #1,
both launches, every block of both encoders of a request reaches, in
percent: the sum of each launch's bound a request (the larger of its
bytes over 3.35 TB/s and its operations over the float32 peak, `costs/`)
over the device time a request of the kernels the frozen classification
files under it. Nothing where no such kernel ran."""

from __future__ import annotations

from portbench.harness.spec import cost_module

KINDS = ["window_attention_proj (#1, #2)",
         "window_attention (#1, #2, #5, #7 forward)"]


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    ms = ctx.trace.ms_per_unit(KINDS)
    if ms <= 0:
        return None
    cost = cost_module("window_attention")
    bound = cost.pass_bound_ms("eval", ctx.config, ctx.batch,
                               ctx.batch * ctx.config["frames"])
    return 100.0 * bound / ms
