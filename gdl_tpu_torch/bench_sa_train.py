"""Time kernels #10 (`self_attention_fused_fwd`) and #12
(`self_attention_qkv_fwd`) per mmformer_n training step on the GPU, and
compare checkouts of this repository in turns.

    python -m gdl_tpu_torch.bench_sa_train [--roots DIR [DIR ...]] [--out F]

One training step of mmformer_n at batch 64 makes 7 attention forwards:
4 at x [64, 196, 512] and 3 at [64, 392, 512], 8 heads, dropout 0.1 drawn
in the kernel. #10 runs them under SA_FUSED_QKV = True (the default),
#12 under False, on a qkv projected outside. For each dtype (float32,
TF32 off; bfloat16) the script times, with CUDA events, at each shape:
- #10 and #12 with the mask drawn in the kernel (mode 2): the median of
  20 single calls (`ms`) and a run of 20 calls between two events
  (`run_ms`, where the host's time to enqueue hides behind the card's);
- #12 without dropout and with the mask read from memory (mode 1);
- a torch.profiler split of #10 into its projection and its attention,
  and of #13 (the eval forward on the same x, w) the same way;
- the plain versions (three calls each: they draw the mask with torch
  integer ops and are a cross-check, not a yardstick);
- `F.scaled_dot_product_attention` on the same q, k, v, without dropout
  and with dropout_p = 0.1 (the nearest single library call; it writes no
  p residual);
and sums them over the 7 launches. Then, for #12 without dropout, a sweep
over N at batch 64 (`sweep`): the kernel's device time by the profiler,
the blocks of the row tile, the blocks the card holds at once and the
time per wave of them, for the per-block cost that does not scale with
N.

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
RATE = 0.1
TRACED = 10
PLAIN_REPS = 3
SWEEP_N = (16, 32, 64, 128, 196, 256, 392)
# kernel names of the projection, in this version and in earlier ones
PROJECTION_NAMES = ("gemm", "proj")
MARK = "bench_sa_train "  # the result line, among whatever else is printed


def _part(name: str) -> str:
    return ("projection" if any(k in name for k in PROJECTION_NAMES)
            else "attention")


def _resident_blocks(n: int, itemsize: int) -> dict:
    """The row tile's blocks per (batch, head) and how many the card
    holds at once at head dim 64: R = 64 rows a block; in bf16 two
    blocks an SM where the tile and four chunk buffers fit in half an
    SM's shared memory (`ring_depth` in kernels/self_attention_rows.cuh),
    in f32 one (its 168 registers a thread)."""
    kc, ldk = (128, 68) if itemsize == 4 else (64, 72)
    lds = (n + 15) // 16 * 16 + 8
    s_floats = 64 * max(lds, 128 if itemsize == 4 else 0)
    base = 4 * (s_floats + 3 * 64) + itemsize * 64 * ldk
    slot = itemsize * kc * ldk
    want = min(2 * ((n + kc - 1) // kc), 8)
    two = (itemsize == 2 and base <= 115712
           and (115712 - base) // slot >= min(want, 4))
    return {"row_blocks": (n + 63) // 64, "per_sm": 2 if two else 1,
            "resident": 132 * (2 if two else 1)}


def worker() -> dict:
    import torch
    import torch.nn.functional as F

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.dropout import fold_seed_words
    from gdl_tpu_torch.ops.self_attention import (
        make_dropout,
        self_attention_fused_eval,
        self_attention_fused_fwd,
        self_attention_qkv_fwd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build(["self_attention_train", "self_attention_eval"])
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "dtypes": {}}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        tot, sites = {}, {}
        for k, (site, ((b, n, c), calls)) in enumerate(SITES.items()):
            gen = torch.Generator(device=dev).manual_seed(800 + k)
            x = torch.randn((b, n, c), generator=gen, device=dev).to(dt)
            w = (torch.randn((3 * c, c), generator=gen, device=dev)
                 * c ** -0.5).to(dt)
            words = fold_seed_words(gen, dev)
            drops = {mode: make_dropout(x, HEADS, RATE, mode != "none",
                                        "hbm" if mode == "hbm" else "kernel",
                                        seed_words=words)
                     for mode in ("none", "hbm", "kernel")}
            drop = drops["kernel"]
            with torch.no_grad():
                qkv = F.linear(x, w)
                q, kk, v = (t.contiguous() for t in qkv.reshape(
                    b, n, 3, HEADS, c // HEADS).permute(2, 0, 3, 1, 4))

                def k10():
                    return self_attention_fused_fwd(x, w, HEADS, drop=drop)

                def k12(mode="kernel"):
                    return self_attention_qkv_fwd(qkv, HEADS,
                                                  drop=drops[mode])

                row = {"k10_ms": cuda_ms(k10), "k10_run_ms": run_ms(k10),
                       "k12_ms": cuda_ms(k12), "k12_run_ms": run_ms(k12),
                       "k12_none_ms": cuda_ms(lambda: k12("none")),
                       "k12_hbm_ms": cuda_ms(lambda: k12("hbm")),
                       "k10_plain_ms": cuda_ms(
                           lambda: self_attention_fused_fwd(
                               x, w, HEADS, drop=drop, impl="plain"),
                           reps=PLAIN_REPS, warmup=1),
                       "k12_plain_ms": cuda_ms(
                           lambda: self_attention_qkv_fwd(
                               qkv, HEADS, drop=drop, impl="plain"),
                           reps=PLAIN_REPS, warmup=1),
                       "sdpa_ms": cuda_ms(
                           lambda: F.scaled_dot_product_attention(q, kk, v)),
                       "sdpa_dropout_ms": cuda_ms(
                           lambda: F.scaled_dot_product_attention(
                               q, kk, v, dropout_p=RATE))}
                split, names = split_ms(k10, _part, TRACED)
                split13, _ = split_ms(
                    lambda: self_attention_fused_eval(x, w, HEADS), _part,
                    TRACED)
            row["k10_projection_ms"] = split.get("projection", 0.0)
            row["k10_attention_ms"] = split.get("attention", 0.0)
            row["k13_attention_ms"] = split13.get("attention", 0.0)
            row["traced_kernels_ms"] = names
            sites[site] = row
            for key, val in row.items():
                if key != "traced_kernels_ms":
                    tot[key] = tot.get(key, 0.0) + calls * val
            del x, w, qkv, q, kk, v, drops, drop
            torch.cuda.empty_cache()
        sweep = []
        for n in SWEEP_N:
            gen = torch.Generator(device=dev).manual_seed(n)
            qkv = torch.randn((64, n, 3 * 512), generator=gen,
                              device=dev).to(dt)
            with torch.no_grad():  # device time: the host's hides here
                split, _ = split_ms(
                    lambda: self_attention_qkv_fwd(qkv, HEADS),
                    lambda name: "kernel", TRACED)
            ms = split.get("kernel", 0.0)
            blocks = _resident_blocks(n, qkv.element_size())
            total = blocks["row_blocks"] * HEADS * 64
            waves = -(-total // blocks["resident"])
            sweep.append({"N": n, "ms": ms, "blocks": total, "waves": waves,
                          "us_per_wave": 1e3 * ms / waves, **blocks})
            del qkv
        out["dtypes"][dtype] = {"per_step": tot, "sites": sites,
                                "sweep": sweep}
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
        print("bench_sa_train: no CUDA device", file=sys.stderr)
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
