"""Time kernel #15 (`mlp_fused`) per Swin-B training step of arm A on the
GPU, and compare checkouts of this repository in turns.

    python -m gdl_tpu_torch.bench_mlp [--roots DIR [DIR ...]] [--out F]

A batch-32 dual Swin-B step under `--fuse_mlp 1` makes 48 forward calls
of #15: 2 encoders x depth (2, 2, 18, 2) blocks, at x [M, C] = [100352,
128], [25088, 256], [6272, 512], [1568, 1024] with hidden = 4C. For each
dtype (float32, TF32 off; bfloat16) the script times, at each stage
shape, with CUDA events: the kernel (`mlp_fused_fwd`, median of 20 single
calls after a warm-up; `run_ms`: a run of 20 calls between two events, so
that the host's time to enqueue a call hides behind the card's work) and
the library chain `F.linear` -> `F.gelu` -> `F.linear` that computes the
same function, and sums them over the 48 calls. A torch.profiler trace of
ten calls at each shape splits the kernel's device time into fc1 (with
its bias and GELU) and fc2 (with its bias) by kernel symbol; a version
whose one kernel does both is filed under "fused". Each row also gives
the bound (the larger of the bytes moved once over 3.35 TB/s and the
operations over 67 TFLOP/s f32 or 989 bf16) and g's round trip through
device memory (written once by fc1, read once by fc2), which the bound
does not count.

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

# (M, C) of each Swin-B stage at batch 32 and the calls of #15 a step
STAGES = {"stage0": ((100352, 128), 4), "stage1": ((25088, 256), 4),
          "stage2": ((6272, 512), 36), "stage3": ((1568, 1024), 4)}
TRACED = 10
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}
MARK = "bench_mlp "  # the result line, among whatever else is printed


def mlp_part(name: str) -> str:
    """fc1 or fc2 by the epilogue in #15's kernel symbol; "fused" for a
    version whose one kernel does both."""
    if "Fc1" in name:
        return "fc1"
    if "Fc2" in name:
        return "fc2"
    return "fused" if "mlp" in name else "other"


def cost(m: int, c: int, itemsize: int):
    """(bytes, operations, g round-trip bytes) of one call at hidden = 4C:
    x, o, both weights and biases moved once; 2 operations a multiply-add
    of the two products; g [M, 4C] written and read once."""
    return ((2 * m * c + 8 * c * c + 5 * c) * itemsize, 16 * m * c * c,
            2 * m * 4 * c * itemsize)


def worker() -> dict:
    import torch
    import torch.nn.functional as F

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.mlp import mlp_fused_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build(["mlp_fused"])
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "dtypes": {}}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        keys = ("ms", "run_ms", "library_ms", "library_run_ms", "bound_ms",
                "g_round_trip_ms", "fc1_ms", "fc2_ms", "fused_ms")
        tot = dict.fromkeys(keys, 0.0)
        stages = {}
        for k, (stage, ((m, c), calls)) in enumerate(STAGES.items()):
            hidden = 4 * c
            gen = torch.Generator(device=dev).manual_seed(900 + k)

            def rand(*shape, std=1.0):
                return (torch.randn(shape, generator=gen, device=dev)
                        * std).to(dt)

            args = (rand(m, c), rand(hidden, c, std=c ** -0.5),
                    rand(hidden, std=0.1), rand(c, hidden, std=hidden ** -0.5),
                    rand(c, std=0.1))
            with torch.no_grad():
                def kernel():
                    return mlp_fused_fwd(*args)

                def chain():
                    return F.linear(F.gelu(F.linear(args[0], args[1], args[2]),
                                           approximate="none"),
                                    args[3], args[4])

                nbytes, ops, g_bytes = cost(m, c, args[0].element_size())
                row = {"M": m, "C": c, "hidden": hidden, "calls": calls,
                       "ms": cuda_ms(kernel), "run_ms": run_ms(kernel),
                       "library_ms": cuda_ms(chain),
                       "library_run_ms": run_ms(chain),
                       "bound_ms": 1e3 * max(nbytes / HBM_BYTES_S,
                                             ops / PEAK_OPS_S[dtype]),
                       "g_round_trip_bytes": g_bytes,
                       "g_round_trip_ms": 1e3 * g_bytes / HBM_BYTES_S}
                split, names = split_ms(kernel, mlp_part, TRACED)
            for part in ("fc1", "fc2", "fused"):
                row[part + "_ms"] = split.get(part, 0.0)
            row["traced_kernels_ms"] = names
            stages[stage] = row
            for key in tot:
                tot[key] += calls * row[key]
            del args
            torch.cuda.empty_cache()
        tot["bound_share"] = tot["bound_ms"] / tot["run_ms"]
        out["dtypes"][dtype] = {"per_step": tot, "stages": stages}
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
        print("bench_mlp: no CUDA device", file=sys.stderr)
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
