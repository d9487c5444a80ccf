"""Time kernel #3 (the fused projection backward) per Swin-B training
step of arm B on the GPU, and compare checkouts of this repository in
turns.

    python -m gdl_tpu_torch.bench_wa_bwd [--roots DIR [DIR ...]] [--out F]

A batch-32 dual Swin-B step under FUSED_PROJECTION_BACKWARD makes 48
calls of #3: 2 encoders x depth (2, 2, 18, 2) blocks, at the window
batches Bw = 2048, 512, 128, 32 of 49 tokens, C = 128 .. 1024, heads 4 ..
32; odd blocks are shifted (a mask in the forward) wherever the window
does not cover the map. For each dtype (float32, TF32 off; bfloat16) the
script makes the saved qkv and p of each stage shape, shifted and not,
with the plain forward, and times with CUDA events: the kernel
(`window_attention_qkv_fused_bwd_fused`, median of 20 single calls after
a warm-up; `run_ms`: a run of 20 calls between two events, so that the
host's time to enqueue a call hides behind the card's work), the split it
replaces (kernel #4, then the three `torch.matmul` of dx, dW and db: the
library yardstick) and the plain version, and sums them over the 48
calls. A torch.profiler trace of ten calls at each shape splits the
kernel's device time into its attention stage, its dx and dW products and
the partial sums (db, dbias and dW partials summed by torch), by kernel
symbol; a version whose one kernel does everything is filed under
"fused". Each row also gives the bound (the larger of the bytes moved
once over 3.35 TB/s and the operations over 67 TFLOP/s f32 or 989 bf16,
the same whatever implements the function) and dqkv's round trip through
device memory (written once, read by dx and by dW), which the bound does
not count.

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
# (Bw, C, heads, feature-map side) of each Swin-B stage at batch 32, and
# its depth; a step runs both encoders
STAGES = {"stage0": ((2048, 128, 4, 56), 2), "stage1": ((512, 256, 8, 28), 2),
          "stage2": ((128, 512, 16, 14), 18), "stage3": ((32, 1024, 32, 7), 2)}
TRACED = 10
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}
MARK = "bench_wa_bwd "  # the result line, among whatever else is printed


def calls_per_step(depth: int, res: int) -> dict:
    """{masked: calls} of one step at a stage: even blocks unshifted, odd
    blocks shifted where the window does not cover the map; 2 encoders."""
    shifted = depth // 2 if res > WINDOW else 0
    return {m: 2 * k for m, k in ((False, depth - shifted), (True, shifted))
            if k}


def wa_bwd_part(name: str) -> str:
    """The stage of #3 a kernel symbol belongs to: its attention stage,
    its dx or dW product (epilogues of namespace wa3), or the partial sums
    (torch's reductions and casts); "fused" for a version whose one kernel
    does everything."""
    if "wa_bwd_fused_attn" in name:
        return "attention"
    if "wa3::Dx" in name:
        return "dx"
    if "wa3::DwPart" in name:
        return "dw"
    if "wa_bwd_fused" in name:
        return "fused"
    return "sums"


def cost(bw: int, c: int, heads: int, itemsize: int):
    """(bytes, operations, dqkv round-trip bytes) of one call: qkv, p,
    dout, x and W in, dx, dW, db and dbias out, each moved once (bias-
    sized tensors in f32); 2 operations a multiply-add of the four
    attention products and the two projection products, 6 a score for
    the softmax backward; dqkv [Bw, N, 3C] written once and read twice."""
    tokens, scores = bw * N * c, bw * heads * N * N
    small = heads * N * N * 4
    nbytes = (6 * tokens + scores + 6 * c * c + 3 * c) * itemsize + small
    ops = 8 * bw * N * N * c + 6 * scores + 12 * bw * N * c * c
    return nbytes, ops, 3 * 3 * tokens * itemsize


def stage_tensors(bw, c, heads, res, masked, dt, dev, seed):
    """(qkv, p, dout, x, w) of one call, the residuals from the plain
    forward on seeded x, W, b, relative-position bias and shift mask."""
    import torch

    from gdl_tpu_torch.models.swin import (
        relative_position_index,
        shift_attn_mask,
    )
    from gdl_tpu_torch.ops import window_attention as wa

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
    with torch.no_grad():
        _, qkv, p = wa.window_attention_qkv_fused_fwd(x, w, b, bias, mask,
                                                      heads, impl="plain")
    dout = rand(bw, N, c).to(dt)
    return qkv, p, dout, x, w


def worker() -> dict:
    import torch

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import window_attention as wa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build(["window_attention_train"])
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "dtypes": {}}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        keys = ("ms", "run_ms", "plain_ms", "library_ms", "library_run_ms",
                "bound_ms", "dqkv_round_trip_ms", "attention_ms", "dx_ms",
                "dw_ms", "sums_ms", "fused_ms")
        tot = dict.fromkeys(keys, 0.0)
        rows = {}
        for k, (stage, ((bw, c, heads, res), depth)) in enumerate(
                STAGES.items()):
            for masked, calls in calls_per_step(depth, res).items():
                args = stage_tensors(bw, c, heads, res, masked, dt, dev,
                                     300 + 2 * k + masked)
                qkv, p, dout, x, w = args
                with torch.no_grad():
                    def kernel():
                        return wa.window_attention_qkv_fused_bwd_fused(
                            *args, heads)

                    def plain():
                        return wa.window_attention_qkv_fused_bwd_fused(
                            *args, heads, impl="plain")

                    def split():  # kernel #4, then the library's GEMMs
                        dqkv, dbias = wa.window_attention_qkv_fused_bwd(
                            qkv, p, dout, heads)
                        return (*wa._projection_bwd(dqkv, x, w), dbias)

                    nbytes, ops, rt = cost(bw, c, heads, x.element_size())
                    row = {"Bw": bw, "C": c, "H": heads, "masked": masked,
                           "calls": calls, "ms": cuda_ms(kernel),
                           "run_ms": run_ms(kernel),
                           "plain_ms": cuda_ms(plain, reps=5, warmup=1),
                           "library_ms": cuda_ms(split),
                           "library_run_ms": run_ms(split),
                           "bound_ms": 1e3 * max(nbytes / HBM_BYTES_S,
                                                 ops / PEAK_OPS_S[dtype]),
                           "dqkv_round_trip_bytes": rt,
                           "dqkv_round_trip_ms": 1e3 * rt / HBM_BYTES_S}
                    parts, names = split_ms(kernel, wa_bwd_part, TRACED)
                for part in ("attention", "dx", "dw", "sums", "fused"):
                    row[part + "_ms"] = parts.get(part, 0.0)
                row["traced_kernels_ms"] = names
                rows[f"{stage}{'_shifted' if masked else ''}"] = row
                for key in tot:
                    tot[key] += calls * row[key]
                del args, qkv, p, dout, x, w
                torch.cuda.empty_cache()
        tot["bound_share"] = tot["bound_ms"] / tot["run_ms"]
        out["dtypes"][dtype] = {"per_step": tot, "stages": rows}
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
        print("bench_wa_bwd: no CUDA device", file=sys.stderr)
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
                dt: r["per_step"] for dt, r in res["dtypes"].items()}}),
                flush=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
