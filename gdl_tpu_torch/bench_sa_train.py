"""Time kernels #10 (`self_attention_fused_fwd`), #12
(`self_attention_qkv_fwd`) and #11 (`self_attention_fused_bwd`) per
mmformer_n training step on the GPU, and compare checkouts of this
repository in turns.

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
- #11 on #10's qkv and p residuals with the mask drawn in the kernel, as
  the step runs it: the single-call median, a run of 20 calls, a
  torch.profiler split into part A (dp, ds, dq) and part B (dk, dv) (also
  without dropout: the cost of drawing the mask again), the
  plain version, the bound (`bwd_cost`: qkv, p, dout read once, dqkv
  written once, four products) and the ds scratch's round trip between
  the two launches in bytes (not counted in the bound);
- the nearest library backward, NOT on the same inputs: one SDPA forward
  without dropout, then a run of 20 `torch.autograd.grad(out, (q, k, v),
  dout, retain_graph=True)` calls (it recomputes p and reads no p
  residual and no mask);
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
# #11's part B, in this version and in the first design; the rest is A
BWD_PART_B_NAMES = ("sa_bwd_keys_kernel", "sa_bwd_kv_kernel")
MARK = "bench_sa_train "  # the result line, among whatever else is printed
# the card's peaks (H100 SXM data sheet): memory, SIMT f32, bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {2: 989e12, 4: 67e12}


def _part(name: str) -> str:
    return ("projection" if any(k in name for k in PROJECTION_NAMES)
            else "attention")


def _bwd_part(name: str) -> str:
    return ("part_b" if any(k in name for k in BWD_PART_B_NAMES)
            else "part_a")


def bwd_cost(b: int, n: int, c: int, heads: int, itemsize: int) -> dict:
    """One launch of #11: the bytes it must move (qkv, p and dout read
    once, dqkv written once; a mask drawn in the kernel moves no more),
    its operations (4 products of 2 b n^2 c, 6 per score element), the
    bound (the larger of bytes / 3.35 TB/s and operations / the dtype's
    peak) and the ds scratch's round trip between its two launches
    (written by part A, read by part B; not in the bound)."""
    tokens, scores = b * n * c, b * heads * n * n
    nbytes = (3 * tokens + scores + tokens + 3 * tokens) * itemsize
    ops = 8 * b * n * n * c + 6 * scores
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * ops / PEAK_OPS_PER_S[itemsize]
    return {"bytes": nbytes, "operations": ops,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "ds_round_trip_bytes": 2 * scores * itemsize}


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
            row.update(_time_backward(x, w, q, kk, v, drops, gen))
            sites[site] = row
            for key, val in row.items():
                if not isinstance(val, dict) and not isinstance(val, str):
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


def _time_backward(x, w, q, k, v, drops, gen) -> dict:
    """#11 at one site (see the module's docstring), and the library
    backward beside it. Also #11 without dropout (`k11_none_*`), whose
    part B forms p_d without drawing the mask: the split's difference is
    what drawing it again costs."""
    import torch
    import torch.nn.functional as F

    from gdl_tpu_torch.ops.self_attention import (
        self_attention_fused_bwd,
        self_attention_fused_fwd,
    )

    b, n, c = x.shape
    drop = drops["kernel"]
    dout = torch.randn((b, n, c), generator=gen, device=x.device).to(x.dtype)
    with torch.no_grad():
        _, qkv, p = self_attention_fused_fwd(x, w, HEADS, drop=drop)

        def k11():
            return self_attention_fused_bwd(qkv, p, dout, HEADS, drop=drop)

        row = {"k11_ms": cuda_ms(k11), "k11_run_ms": run_ms(k11),
               "k11_plain_ms": cuda_ms(
                   lambda: self_attention_fused_bwd(qkv, p, dout, HEADS,
                                                    drop=drop, impl="plain"),
                   reps=PLAIN_REPS, warmup=1)}
        split, names = split_ms(k11, _bwd_part, TRACED)

        def k11_none():
            return self_attention_fused_bwd(qkv, p, dout, HEADS,
                                            drop=drops["none"])

        row["k11_none_run_ms"] = run_ms(k11_none)
        split_none, _ = split_ms(k11_none, _bwd_part, TRACED)
    row["k11_part_a_ms"] = split.get("part_a", 0.0)
    row["k11_part_b_ms"] = split.get("part_b", 0.0)
    row["k11_none_part_a_ms"] = split_none.get("part_a", 0.0)
    row["k11_none_part_b_ms"] = split_none.get("part_b", 0.0)
    row["k11_traced_kernels_ms"] = names
    cost = bwd_cost(b, n, c, HEADS, x.element_size())
    row.update({"k11_" + key: val for key, val in cost.items()})
    # the library's backward, on q, k, v without dropout: not the same
    # inputs (it recomputes p, reads no p residual and no mask)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qg, kg, vg)
    g4 = dout.reshape(b, n, HEADS, c // HEADS).transpose(1, 2).contiguous()

    def library():
        return torch.autograd.grad(out, (qg, kg, vg), g4, retain_graph=True)

    row["sdpa_bwd_ms"] = cuda_ms(library)
    row["sdpa_bwd_run_ms"] = run_ms(library)
    del qkv, p, dout, out, qg, kg, vg, g4
    return row


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
