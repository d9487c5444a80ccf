"""Time kernel #13 (`self_attention_fused_eval`) per mmformer_n eval
forward on the GPU, and compare checkouts of this repository in turns.

    python -m gdl_tpu_torch.bench_sa_eval [--roots DIR [DIR ...]] [--out F]

One eval forward of mmformer_n at batch 64 makes 7 launches of #13: 4 at
x [64, 196, 512] and 3 at [64, 392, 512], 8 heads. For each dtype
(float32, TF32 off; bfloat16) the script times, with CUDA events (median
of 20 calls after a warm-up, one call between two events), at each
shape: the kernel, SDPA on the same q, k, v (the attention alone) and
F.linear + SDPA (the same work in two library calls), and sums them over
the 7 launches; `run_ms` times the kernel and `plain_run_ms` its plain
version over a run of calls between two events instead, so that the
host's time to enqueue a call hides behind the card's work. Then a
torch.profiler trace of ten launches at each shape splits the kernel's
device time into the projection and the attention, by kernel name.

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

SITES = {"intra": ((64, 196, 512), 4), "inter": ((64, 392, 512), 3)}
HEADS = 8
TRACED = 10
# kernel names of the projection, in this version and in earlier ones
PROJECTION_NAMES = ("gemm", "proj")
MARK = "bench_sa_eval "  # the result line, among whatever else is printed


def _part(name: str) -> str:
    return ("projection" if any(k in name for k in PROJECTION_NAMES)
            else "attention")


def worker() -> dict:
    import torch
    import torch.nn.functional as F

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.self_attention import self_attention_fused_eval

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build(["self_attention_eval"])
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "dtypes": {}}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        tot = {"ms": 0.0, "run_ms": 0.0, "plain_run_ms": 0.0, "sdpa_ms": 0.0,
               "linear_sdpa_ms": 0.0, "projection_ms": 0.0,
               "attention_ms": 0.0}
        sites = {}
        for k, (site, ((b, n, c), calls)) in enumerate(SITES.items()):
            gen = torch.Generator(device=dev).manual_seed(800 + k)
            x = torch.randn((b, n, c), generator=gen, device=dev).to(dt)
            w = (torch.randn((3 * c, c), generator=gen, device=dev)
                 * c ** -0.5).to(dt)
            with torch.no_grad():
                q, kk, v = F.linear(x, w).reshape(
                    b, n, 3, HEADS, c // HEADS).permute(2, 0, 3, 1, 4)
                q, kk, v = q.contiguous(), kk.contiguous(), v.contiguous()

                def kernel():
                    return self_attention_fused_eval(x, w, HEADS)

                def linear_sdpa():
                    q5 = F.linear(x, w).reshape(
                        b, n, 3, HEADS, c // HEADS).permute(2, 0, 3, 1, 4)
                    return F.scaled_dot_product_attention(q5[0], q5[1],
                                                          q5[2])

                row = {"ms": cuda_ms(kernel),
                       "run_ms": run_ms(kernel),
                       "plain_run_ms": run_ms(
                           lambda: self_attention_fused_eval(
                               x, w, HEADS, impl="plain"), reps=5),
                       "sdpa_ms": cuda_ms(
                           lambda: F.scaled_dot_product_attention(q, kk, v)),
                       "linear_sdpa_ms": cuda_ms(linear_sdpa)}
                split, names = split_ms(kernel, _part, TRACED)
            row["projection_ms"] = split.get("projection", 0.0)
            row["attention_ms"] = split.get("attention", 0.0)
            row["traced_kernels_ms"] = names
            sites[site] = row
            for key in tot:
                tot[key] += calls * row[key]
            del x, w, q, kk, v
            torch.cuda.empty_cache()
        out["dtypes"][dtype] = {"per_eval_forward": tot, "sites": sites}
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
        print("bench_sa_eval: no CUDA device", file=sys.stderr)
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
                dt: r["per_eval_forward"] for dt, r in res["dtypes"].items()}}),
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
