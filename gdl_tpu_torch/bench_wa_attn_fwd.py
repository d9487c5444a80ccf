"""Time the window-attention forwards that run on one device body (kernels
#1, #2, #5, #6's and #7's forward, #8 and #9: `window_attention_fwd.cuh`)
per Swin-B pass on the GPU, and compare checkouts of this repository in
turns.

    python -m gdl_tpu_torch.bench_wa_attn_fwd [--roots DIR [DIR ...]]
        [--out F]

A dual Swin-B pass makes 48 calls of each: 2 encoders x depth (2, 2, 18,
2) blocks at C = 128 .. 1024, heads 4 .. 32, windows of 49 tokens; odd
blocks are shifted (a mask) wherever the window does not cover the map.
Every kernel runs at the batch-32 training shapes (Bw = 2048, 512, 128,
32) but #1, the serving forward, which runs at the batch-16 request's
(Bw = 1024, 256, 64, 16). For each dtype (float32, TF32 off; bfloat16),
on seeded x, W, b, relative-position bias and shift mask, with qkv from
the plain projection and q, k, v [Bw, H, N, d] its heads, the script
times with CUDA events, and sums over the 48 calls, each kernel through
its op:

  "5"      window_attention_qkv_fwd (out and p)
  "6_fwd"  the same with transposed=False
  "7_fwd"  window_attention_qkv_recompute_fwd (out, no p)
  "8"      window_attention_bhnd
  "9"      window_attention_packed
  "2"      window_attention_qkv_fused_fwd (the projection, then #5's body)
  "1"      window_attention_qkv_fused_eval (the projection, then #7's)

each as the median of 20 single calls after a warm-up (`ms`) and in a run
of 20 calls between two events (`run_ms`: the host's time to enqueue a
call hides behind the card's work), its plain version (`plain_ms`), its
bound (`bound_ms`: the larger of the bytes moved once over 3.35 TB/s and
the operations over 67 TFLOP/s f32 or 989 bf16, as
`chip_smoke.attention_cost` counts them: kinds qkv_savep, attn_fwd,
savep, eval) and the library call that computes the same function in
runs of 20 (`library_run_ms`): `F.scaled_dot_product_attention` on the
same q, k, v with the bias + mask as its float mask (made beforehand,
not timed; it writes no p), and for #1 and #2 `F.linear` first. A
torch.profiler trace of ten calls gives each kernel's device time a call
(`device_ms`: where a call's kernels take less time than the op
wrapper's host code, as the bf16 forwards do at Swin-B stages 2 and 3,
a run of calls measures the host), and splits #1's and #2's into their
projection (the GEMM tile with the wa2::ProjBias epilogue) and their
attention (wa_fwd_kernel). A SHA-256 digest of each kernel's outputs at
every site shows whether two checkouts give the same bits.

With --roots, each DIR (a checkout of this repository, e.g. the parent
commit unpacked by `git archive`) is timed in a process of its own, in
the order given, so that `--roots parent . . parent` compares two
versions on one card in turns; every pair of roots is reported with
whether their forwards' bits are equal. Each process builds its
checkout's kernels. Every result names the card; without CUDA the script
exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
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
# kernel -> (the kind of chip_smoke.attention_cost that bounds it, batch)
KERNELS = {"5": ("qkv_savep", 32), "6_fwd": ("qkv_savep", 32),
           "7_fwd": ("attn_fwd", 32), "8": ("attn_fwd", 32),
           "9": ("attn_fwd", 32), "2": ("savep", 32), "1": ("eval", 16)}
TRACED = 10
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}
MARK = "bench_wa_attn_fwd "  # the result line, among whatever else


def calls_per_pass(depth: int, res: int) -> dict:
    """{masked: calls} of one pass at a stage: even blocks unshifted, odd
    blocks shifted where the window does not cover the map; 2 encoders."""
    shifted = depth // 2 if res > WINDOW else 0
    return {m: 2 * k for m, k in ((False, depth - shifted), (True, shifted))
            if k}


def sites(batch: int):
    """(stage, bw, c, heads, res, masked, calls) of each shape of one pass
    at `batch` clips."""
    for stage, ((c, heads, res), bw16, depth) in STAGES.items():
        for masked, calls in calls_per_pass(depth, res).items():
            yield stage, bw16 * batch // 16, c, heads, res, masked, calls


def cost(kind: str, bw: int, c: int, heads: int, masked: bool, res: int,
         itemsize: int):
    """(bytes, operations) of one call, every input read once and every
    output written once, the bias [H, N, N] and mask [nW, N, N] in f32; 2
    operations a multiply-add, 5 a score for the softmax. kind
    "attn_fwd" (#7's forward, #8, #9): q, k, v in, out out; "qkv_savep"
    (#5, #6's forward): also p out; "eval" (#1) and "savep" (#2): x, W, b
    in, out out (#2: also the qkv and p residuals), and the projection."""
    tokens, scores = bw * N * c, bw * heads * N * N
    masks = (heads + ((res // WINDOW) ** 2 if masked else 0)) * N * N * 4
    attn_ops = 4 * bw * N * N * c + 5 * scores
    if kind == "attn_fwd":
        return 4 * tokens * itemsize + masks, attn_ops
    if kind == "qkv_savep":
        return (4 * tokens + scores) * itemsize + masks, attn_ops
    nbytes = (2 * tokens + 3 * c * c + 3 * c) * itemsize + masks
    if kind == "savep":
        nbytes += (3 * tokens + scores) * itemsize
    return nbytes, 2 * bw * N * c * 3 * c + attn_ops


def bound_ms(nbytes: float, ops: float, dtype: str) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[dtype])


def pass_bound(kernel: str, dtype: str) -> float:
    """The bound of one pass of `kernel` (48 calls, each call's summed)."""
    kind, batch = KERNELS[kernel]
    itemsize = 4 if dtype == "float32" else 2
    return sum(calls * bound_ms(*cost(kind, bw, c, heads, masked, res,
                                      itemsize), dtype)
               for _, bw, c, heads, res, masked, calls in sites(batch))


def part_of(name: str) -> str:
    """The part of #1 or #2 a kernel symbol belongs to: the projection
    (the GEMM tile with the wa2 epilogue) or the attention (the forward
    body, wa_fwd_kernel); "other" for anything else."""
    if "wa2::" in name:
        return "projection"
    if "wa_fwd_kernel" in name:
        return "attention"
    return "other"


def stage_tensors(bw, c, heads, res, masked, dt, dev, seed):
    """x, w, b in dt, bias [H, N, N] f32, mask [nW, N, N] f32 or None, the
    plain projection's qkv and its heads q, k, v [Bw, H, N, d], and SDPA's
    float mask [Bw, H, N, N] in dt."""
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
        _, qkv, _ = wa.window_attention_qkv_fused_fwd(x, w, b, bias, mask,
                                                      heads, impl="plain")
    q, k, v = (z.contiguous() for z in qkv.reshape(
        bw, N, 3, heads, c // heads).permute(2, 0, 3, 1, 4))
    am = bias[None]
    if mask is not None:
        am = (am + mask[:, None]).repeat(bw // mask.shape[0], 1, 1, 1)
    am = am.expand(bw, heads, N, N).to(dt).contiguous()
    return dict(x=x, w=w, b=b, bias=bias, mask=mask, qkv=qkv, q=q, k=k, v=v,
                am=am)


def calls(t: dict, heads: int, batch: int) -> dict:
    """kernel -> (the kernel's call, its plain version's call, the library
    call) for the kernels of a pass at `batch`."""
    import torch.nn.functional as F

    from gdl_tpu_torch.ops import window_attention as wa

    x, w, b, bias, mask, qkv = (t[k] for k in ("x", "w", "b", "bias", "mask",
                                               "qkv"))
    q, k, v, am = t["q"], t["k"], t["v"], t["am"]
    bw, n, c = x.shape

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=am)

    def linear_sdpa():
        qp, kp, vp = F.linear(x, w, b).reshape(bw, n, 3, heads,
                                               c // heads).permute(
            2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(qp, kp, vp, attn_mask=am)
        return out.transpose(1, 2).reshape(bw, n, c)

    def pair(fn, *args, **kw):
        return (lambda: fn(*args, **kw),
                lambda: fn(*args, impl="plain", **kw))

    if batch == 16:
        return {"1": (*pair(wa.window_attention_qkv_fused_eval, x, w, b,
                            bias, mask, heads), linear_sdpa)}
    return {
        "5": (*pair(wa.window_attention_qkv_fwd, qkv, bias, mask, heads),
              sdpa),
        "6_fwd": (*pair(wa.window_attention_qkv_fwd, qkv, bias, mask, heads,
                        transposed=False), sdpa),
        "7_fwd": (*pair(wa.window_attention_qkv_recompute_fwd, qkv, bias,
                        mask, heads), sdpa),
        "8": (*pair(wa.window_attention_bhnd, q, k, v, bias, mask), sdpa),
        "9": (*pair(wa.window_attention_packed, q, k, v, bias, mask), sdpa),
        "2": (*pair(wa.window_attention_qkv_fused_fwd, x, w, b, bias, mask,
                    heads), linear_sdpa),
    }


def _digest(h, out) -> None:
    import torch

    for z in (out if isinstance(out, (tuple, list)) else (out,)):
        z = z.detach().contiguous()
        z = z.view(torch.int16 if z.element_size() == 2 else torch.int32)
        h.update(z.cpu().numpy().tobytes())


def worker() -> dict:
    import torch

    from gdl_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build(["window_attention_train", "window_attention_eval",
                   "window_attention_bhnd"])
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "dtypes": {}}
    keys = ("ms", "run_ms", "device_ms", "plain_ms", "library_run_ms",
            "projection_ms", "attention_ms")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        tot = {kern: dict.fromkeys(keys, 0.0) for kern in KERNELS}
        digests = {kern: hashlib.sha256() for kern in KERNELS}
        rows = {}
        for batch in (32, 16):
            for i, (stage, bw, c, heads, res, masked, ncalls) in enumerate(
                    sites(batch)):
                t = stage_tensors(bw, c, heads, res, masked, dt, dev,
                                  300 + i)
                site = f"b{batch}_{stage}{'_shifted' if masked else ''}"
                rows[site] = {}
                with torch.no_grad():
                    for kern, (kernel, plain, library) in calls(
                            t, heads, batch).items():
                        row = {"ms": cuda_ms(kernel),
                               "run_ms": run_ms(kernel),
                               "plain_ms": cuda_ms(plain, reps=3, warmup=1),
                               "library_run_ms": run_ms(library)}
                        parts, _ = split_ms(kernel, part_of, TRACED)
                        row["device_ms"] = sum(parts.values())
                        if kern in ("1", "2"):
                            row["projection_ms"] = parts.get("projection",
                                                             0.0)
                            row["attention_ms"] = parts.get("attention", 0.0)
                        rows[site][kern] = row
                        for key, val in row.items():
                            tot[kern][key] += ncalls * val
                        _digest(digests[kern], kernel())
                del t
                torch.cuda.empty_cache()
        for kern in KERNELS:
            tot[kern]["bound_ms"] = pass_bound(kern, dtype)
            tot[kern]["bound_share"] = (tot[kern]["bound_ms"]
                                        / tot[kern]["run_ms"])
        out["dtypes"][dtype] = {
            "per_pass": tot,
            "sha256": {k: h.hexdigest() for k, h in digests.items()},
            "sites": rows}
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
        print("bench_wa_attn_fwd: no CUDA device", file=sys.stderr)
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
                dt: r["per_pass"] for dt, r in res["dtypes"].items()}}),
                flush=True)
        for dt in runs[0]["dtypes"]:
            pairs = [[i, j, runs[i]["dtypes"][dt]["sha256"]
                      == runs[j]["dtypes"][dt]["sha256"]]
                     for i in range(len(runs))
                     for j in range(i + 1, len(runs))]
            print(json.dumps({"dtype": dt, "bits_equal": pairs}), flush=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
