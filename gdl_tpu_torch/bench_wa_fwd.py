"""Time kernels #2 (the save-p training forward) per Swin-B training step
and #1 (the eval forward) per serving request on the GPU, and compare
checkouts of this repository in turns.

    python -m gdl_tpu_torch.bench_wa_fwd [--roots DIR [DIR ...]] [--out F]

A dual Swin-B pass makes 48 calls of each: 2 encoders x depth (2, 2, 18,
2) blocks at C = 128 .. 1024, heads 4 .. 32, windows of 49 tokens; odd
blocks are shifted (a mask) wherever the window does not cover the map.
#2 runs at the batch-32 training shapes (Bw = 2048, 512, 128, 32), #1 at
the batch-16 serving shapes (Bw = 1024, 256, 64, 16). For each dtype
(float32, TF32 off; bfloat16), on seeded x, W, b, relative-position bias
and shift mask, the script times with CUDA events, and sums over the 48
calls: the kernel (`window_attention_qkv_fused_fwd`,
`window_attention_qkv_fused_eval`; the median of 20 single calls after a
warm-up, and `run_ms`: a run of 20 calls between two events, so that the
host's time to enqueue a call hides behind the card's work), its plain
version, and the library yardstick that does the same work: `F.linear`
for qkv, then `F.scaled_dot_product_attention` with the bias + mask as
its float mask (made beforehand, not timed), with the layout copies in
and out. A torch.profiler trace of ten calls at each shape splits the
kernel's device time into its projection (the GEMM tile with the
wa2::ProjBias epilogue) and its attention (wa_fwd_kernel); a version
whose one kernel does both is filed under "fused". Each row also gives
the bound (the larger of the bytes moved once over 3.35 TB/s and the
operations over 67 TFLOP/s f32 or 989 bf16, as `chip_smoke.py` counts
it) and, beside it and not counted in it, the qkv traffic the split into
two launches adds: #2 reads the qkv it wrote once more, #1 writes it and
reads it.

At the #2 shapes the same run also times, per step of the arm that runs
them (runs of 20 calls), the kernels that share code with #1 and #2 and
must not move: #5 (`window_attention_qkv_fwd`) and #7's forward
(`window_attention_qkv_recompute_fwd`) on the plain forward's qkv, #3
(`window_attention_qkv_fused_bwd_fused`) from its qkv and p, #15
(`mlp_fused_fwd`, M = Bw * 49 tokens, hidden 4C); and per mmformer_n step
#13 (`self_attention_fused_eval`) and #10 (`self_attention_fused_fwd`,
no dropout) at [64, 196, 512] x 4 and [64, 392, 512] x 3, 8 heads.

With --roots, each DIR (a checkout of this repository, e.g. the parent
commit unpacked by `git archive`) is timed in a process of its own, in
the order given, so that `--roots parent . . parent` compares two
versions on one card in turns. Each process builds its checkout's
kernels. Every result names the card; without CUDA the script exits 2
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import gdl_tpu_torch

# run by path for another checkout (--roots), whose package comes first:
# the bench helpers are found beside this file (see bench_common)
_HERE = os.path.dirname(os.path.abspath(__file__))
if _HERE not in gdl_tpu_torch.__path__:
    gdl_tpu_torch.__path__.append(_HERE)
from gdl_tpu_torch.bench_common import (  # noqa: E402
    cuda_ms,
    nvidia_smi,
    run_ms,
    run_roots,
    split_ms,
)

N = 49  # tokens a window
WINDOW = 7
# (C, heads, feature-map side) of each Swin-B stage, its windows at batch
# 16 and its depth; a pass runs both encoders
STAGES = {"stage0": ((128, 4, 56), 1024, 2), "stage1": ((256, 8, 28), 256, 2),
          "stage2": ((512, 16, 14), 64, 18), "stage3": ((1024, 32, 7), 16, 2)}
# kernel -> (op name, batch of its pass)
KERNELS = {"savep": ("window_attention_qkv_fused_fwd", 32),
           "eval": ("window_attention_qkv_fused_eval", 16)}
SA_SITES = {196: 4, 392: 3}  # mmformer_n: tokens -> calls a step
TRACED = 10
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}
MARK = "bench_wa_fwd "  # the result line, among whatever else is printed


def calls_per_pass(depth: int, res: int) -> dict:
    """{masked: calls} of one pass at a stage: even blocks unshifted, odd
    blocks shifted where the window does not cover the map; 2 encoders."""
    shifted = depth // 2 if res > WINDOW else 0
    return {m: 2 * k for m, k in ((False, depth - shifted), (True, shifted))
            if k}


def wa_fwd_part(name: str) -> str:
    """The part of #1 or #2 a kernel symbol belongs to: the projection
    (the GEMM tile with the wa2 epilogue), the attention (wa_fwd_kernel),
    or "fused" for the first design's kernel with its projection inside
    (a fourth template argument, PROJ, true); "other" for anything
    else."""
    if "wa2::" in name:
        return "projection"
    if "wa_fwd_kernel<" in name:
        targs = name.split("wa_fwd_kernel<", 1)[1].split(">", 1)[0]
        proj = targs.count(",") == 3 and targs.endswith("true")
        return "fused" if proj else "attention"
    return "other"


def cost(kind: str, bw: int, c: int, heads: int, masked: bool, res: int,
         itemsize: int):
    """(bytes, operations, split bytes) of one call of #2 (kind "savep")
    or #1 ("eval"): x, W, b in and out out in T, the bias [H, N, N] and
    the mask [nW, N, N] in f32, each moved once; #2 also writes qkv and p.
    2 operations a multiply-add of the projection and the two attention
    products, 5 a score for the softmax. The split bytes are the qkv
    traffic of running the projection and the attention as two launches,
    not counted in the bound: #2 reads its qkv back once, #1 writes and
    reads it."""
    tokens, scores = bw * N * c, bw * heads * N * N
    nw = (res // WINDOW) ** 2 if masked else 0
    nbytes = ((2 * tokens + 3 * c * c + 3 * c) * itemsize
              + (heads + nw) * N * N * 4)
    if kind == "savep":
        nbytes += (3 * tokens + scores) * itemsize
        split = 3 * tokens * itemsize
    else:
        split = 2 * 3 * tokens * itemsize
    ops = 2 * bw * N * c * 3 * c + 4 * bw * N * N * c + 5 * scores
    return nbytes, ops, split


def bound_ms(nbytes: float, ops: float, dtype: str) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[dtype])


def sites(kind: str):
    """(stage, bw, c, heads, res, masked, calls) of each shape of one pass
    of #2 (batch 32) or #1 (batch 16)."""
    batch = KERNELS[kind][1]
    for stage, ((c, heads, res), bw16, depth) in STAGES.items():
        for masked, calls in calls_per_pass(depth, res).items():
            yield stage, bw16 * batch // 16, c, heads, res, masked, calls


def pass_bound(kind: str, dtype: str) -> dict:
    """The bound of one pass (48 calls), each call's summed, and the split
    bytes beside it."""
    itemsize = 4 if dtype == "float32" else 2
    tot = {"bound_ms": 0.0, "bytes": 0, "operations": 0, "split_bytes": 0}
    for _, bw, c, heads, res, masked, calls in sites(kind):
        nbytes, ops, split = cost(kind, bw, c, heads, masked, res, itemsize)
        tot["bound_ms"] += calls * bound_ms(nbytes, ops, dtype)
        tot["bytes"] += calls * nbytes
        tot["operations"] += calls * ops
        tot["split_bytes"] += calls * split
    return tot


def stage_tensors(bw, c, heads, res, masked, dt, dev, seed):
    """Seeded x, W, b in dt, the relative-position bias [H, N, N] and the
    shift mask [nW, N, N] (or None) in f32."""
    import torch

    from gdl_tpu_torch.models.swin import (
        relative_position_index,
        shift_attn_mask,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    x, w, b = (rand(bw, N, c).to(dt), rand(3 * c, c, std=c ** -0.5).to(dt),
               rand(3 * c, std=0.1).to(dt))
    table = rand((2 * WINDOW - 1) ** 2, heads, std=0.5)
    idx = torch.as_tensor(relative_position_index(WINDOW).reshape(-1),
                          device=dev)
    bias = table[idx].reshape(N, N, heads).permute(2, 0, 1).contiguous()
    mask = (torch.as_tensor(shift_attn_mask(res, res, WINDOW, WINDOW // 2),
                            device=dev) if masked else None)
    return x, w, b, bias, mask


def linear_sdpa(x, w, b, am, heads):
    """The library yardstick: qkv by F.linear, then SDPA on its q, k, v
    with `am` [Bw, H, N, N] as the additive mask, out as [Bw, N, C]."""
    import torch.nn.functional as F

    bw, n, c = x.shape
    q, k, v = F.linear(x, w, b).reshape(bw, n, 3, heads, c // heads).permute(
        2, 0, 3, 1, 4)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
    return out.transpose(1, 2).reshape(bw, n, c)


def others(dt, dev) -> dict:
    """ms a step (runs of 20 calls) of the kernels that share code with #1
    and #2: #5, #7's forward, #3 and #15 over a batch-32 Swin-B step's 48
    sites, #13 and #10 over a mmformer_n step's 7."""
    import torch

    from gdl_tpu_torch.ops import self_attention as sa
    from gdl_tpu_torch.ops import window_attention as wa
    from gdl_tpu_torch.ops.mlp import mlp_fused_fwd

    tot = dict.fromkeys(("5_ms", "7_fwd_ms", "3_ms", "15_ms", "13_ms",
                         "10_ms"), 0.0)
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)

    with torch.no_grad():
        for k, (stage, bw, c, heads, res, masked, calls) in enumerate(
                sites("savep")):
            x, w, b, bias, mask = stage_tensors(bw, c, heads, res, masked,
                                                dt, dev, 500 + k)
            _, qkv, p = wa.window_attention_qkv_fused_fwd(
                x, w, b, bias, mask, heads, impl="plain")
            dout = rand(bw, N, c)
            tot["5_ms"] += calls * run_ms(
                lambda: wa.window_attention_qkv_fwd(qkv, bias, mask, heads))
            tot["7_fwd_ms"] += calls * run_ms(
                lambda: wa.window_attention_qkv_recompute_fwd(qkv, bias, mask,
                                                              heads))
            tot["3_ms"] += calls * run_ms(
                lambda: wa.window_attention_qkv_fused_bwd_fused(
                    qkv, p, dout, x, w, heads))
            margs = (x.reshape(-1, c), rand(4 * c, c, std=c ** -0.5),
                     rand(4 * c, std=0.1), rand(c, 4 * c, std=(4 * c) ** -0.5),
                     rand(c, std=0.1))
            tot["15_ms"] += calls * run_ms(lambda: mlp_fused_fwd(*margs))
            del x, w, b, qkv, p, dout, margs
            torch.cuda.empty_cache()
        for n, calls in SA_SITES.items():
            x, w = rand(64, n, 512), rand(1536, 512, std=512 ** -0.5)
            tot["13_ms"] += calls * run_ms(
                lambda: sa.self_attention_fused_eval(x, w, 8))
            tot["10_ms"] += calls * run_ms(
                lambda: sa.self_attention_fused_fwd(x, w, 8))
    return tot


def worker() -> dict:
    import torch

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import window_attention as wa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build(["window_attention_eval", "window_attention_train",
                   "mlp_fused", "self_attention_eval",
                   "self_attention_train"])
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "dtypes": {}}
    keys = ("ms", "run_ms", "plain_ms", "library_ms", "library_run_ms",
            "bound_ms", "projection_ms", "attention_ms", "fused_ms",
            "other_ms")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        res_dt = {}
        for kind, (op_name, batch) in KERNELS.items():
            op = getattr(wa, op_name)
            tot = dict.fromkeys(keys, 0.0)
            rows = {}
            for k, (stage, bw, c, heads, res, masked, calls) in enumerate(
                    sites(kind)):
                x, w, b, bias, mask = stage_tensors(bw, c, heads, res, masked,
                                                    dt, dev, 300 + k)
                am = bias[None]
                if mask is not None:
                    am = (am + mask[:, None]).repeat(bw // mask.shape[0], 1,
                                                     1, 1)
                am = am.expand(bw, heads, N, N).to(dt).contiguous()
                with torch.no_grad():
                    def kernel():
                        return op(x, w, b, bias, mask, heads)

                    def plain():
                        return op(x, w, b, bias, mask, heads, impl="plain")

                    def library():
                        return linear_sdpa(x, w, b, am, heads)

                    nbytes, ops, split = cost(kind, bw, c, heads, masked, res,
                                              x.element_size())
                    row = {"Bw": bw, "C": c, "H": heads, "masked": masked,
                           "calls": calls, "ms": cuda_ms(kernel),
                           "run_ms": run_ms(kernel),
                           "plain_ms": cuda_ms(plain, reps=5, warmup=1),
                           "library_ms": cuda_ms(library),
                           "library_run_ms": run_ms(library),
                           "bound_ms": bound_ms(nbytes, ops, dtype),
                           "split_bytes": split}
                    parts, names = split_ms(kernel, wa_fwd_part, TRACED)
                for part in ("projection", "attention", "fused", "other"):
                    row[part + "_ms"] = parts.get(part, 0.0)
                row["traced_kernels_ms"] = names
                rows[f"{stage}{'_shifted' if masked else ''}"] = row
                for key in tot:
                    tot[key] += calls * row[key]
                del x, w, b, bias, mask, am
                torch.cuda.empty_cache()
            tot["bound_share"] = tot["bound_ms"] / tot["run_ms"]
            tot["split_bytes"] = pass_bound(kind, dtype)["split_bytes"]
            tot["batch"] = batch
            res_dt[kind] = {"per_pass": tot, "stages": rows}
        res_dt["others"] = others(dt, dev)
        out["dtypes"][dtype] = res_dt
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="*", default=None,
                    help="checkouts to time in turns, each in its own "
                         "process (default: this one, in this process)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_wa_fwd: no CUDA device", file=sys.stderr)
        return 2
    if args.worker or not args.roots:
        res = worker()
        print(MARK + json.dumps(res), flush=True)
        runs = [res]
    else:
        runs = []
        for res in run_roots(__file__, args.roots, MARK):
            runs.append(res)
            print(json.dumps({"root": res["root"], **{
                dt: {**{k: r[k]["per_pass"] for k in KERNELS},
                     "others": r["others"]}
                for dt, r in res["dtypes"].items()}}), flush=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
