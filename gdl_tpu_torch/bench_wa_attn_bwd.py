"""Time the window-attention backwards that share one device body (kernels
#4, #4-delta, #6's and #7's backward, and #3's attention stage) per
batch-32 Swin-B pass on the GPU, and compare checkouts of this repository
in turns.

    python -m gdl_tpu_torch.bench_wa_attn_bwd [--roots DIR [DIR ...]]
        [--out F]

A batch-32 dual Swin-B pass makes 48 calls of each: 2 encoders x depth
(2, 2, 18, 2) blocks at the window batches Bw = 2048, 512, 128, 32 of 49
tokens, C = 128 .. 1024, heads 4 .. 32; odd blocks are shifted (a mask
in the forward) wherever the window does not cover the map. For each
dtype (float32, TF32 off; bfloat16) the script makes the saved qkv, p
and out of each stage shape with the plain forward on seeded x, W, b,
relative-position bias and shift mask, then times with CUDA events, and
sums over the 48 calls, each kernel through its op:

  "4"        window_attention_qkv_fused_bwd (the saved p)
  "4_delta"  the same with delta (attention_delta of out and dout,
             made beforehand)
  "6"        the same with transposed=False
  "7"        window_attention_qkv_recompute_bwd (p computed again)
  "3"        window_attention_qkv_fused_bwd_fused (with dx, dW, db)

each as the median of 20 single calls after a warm-up (`ms`) and in a run
of 20 calls between two events (`run_ms`: the host's time to enqueue a
call hides behind the card's work), its plain version (`plain_ms`) and
its bound (`bound_ms`: the larger of the bytes moved once over 3.35 TB/s
and the operations over 67 TFLOP/s f32 or 989 bf16, counted as
`chip_smoke.attention_cost` counts them). A torch.profiler trace of ten
calls at each shape splits each call's device time into the attention
body (`body_ms`: the wa_bwd_* kernel), #3's projection products
(`products_ms`) and the partial sums (`sums_ms`, torch's reductions);
#3's `body_ms` is its attention stage.

As a library reference on other inputs (as for #11): q, k, v
[Bw, H, N, d] and the bias + mask as SDPA's float mask, all requiring
grad, through `F.scaled_dot_product_attention` once, then
`torch.autograd.grad` of its output in runs of 20 (`library_run_ms`; it
recomputes p and writes the mask's gradient per window).

The same run times, per pass in runs of 20 calls, the forwards that share
the library or the ops with these (#2, #5, #6's and #7's forward, #1, #8,
#9) and records a SHA-256 digest of their outputs at every site, so that
`--roots parent . . parent` shows that they kept their bits and times.

With --roots, each DIR (a checkout of this repository, e.g. the parent
commit unpacked by `git archive`) is timed in a process of its own, in
the order given. Each process builds its checkout's kernels. Every result
names the card; without CUDA the script exits 2 and prints no result.
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
BATCH = 32
# (Bw, C, heads, feature-map side) of each Swin-B stage at batch 32, and
# its depth; a pass runs both encoders
STAGES = {"stage0": ((2048, 128, 4, 56), 2), "stage1": ((512, 256, 8, 28), 2),
          "stage2": ((128, 512, 16, 14), 18), "stage3": ((32, 1024, 32, 7), 2)}
# kernel -> the kind of chip_smoke.attention_cost that bounds it
KINDS = {"4": "bwd", "4_delta": "bwd_delta", "6": "bwd",
         "7": "bwd_recompute", "3": "bwd_fused"}
TRACED = 10
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}
MARK = "bench_wa_attn_bwd "  # the result line, among whatever else


def calls_per_pass(depth: int, res: int) -> dict:
    """{masked: calls} of one pass at a stage: even blocks unshifted, odd
    blocks shifted where the window does not cover the map; 2 encoders."""
    shifted = depth // 2 if res > WINDOW else 0
    return {m: 2 * k for m, k in ((False, depth - shifted), (True, shifted))
            if k}


def sites():
    """(stage, bw, c, heads, res, masked, calls) of each shape of a pass."""
    for stage, ((bw, c, heads, res), depth) in STAGES.items():
        for masked, calls in calls_per_pass(depth, res).items():
            yield stage, bw, c, heads, res, masked, calls


def cost(kind: str, bw: int, c: int, heads: int, masked: bool, res: int,
         itemsize: int):
    """(bytes, operations) of one call, every input read once and every
    output written once, bias-sized tensors in f32; 2 operations a
    multiply-add, 6 a score for the softmax backward (11 with the softmax
    again). kind "bwd" (#4, #6): qkv, p, dout in, dqkv, dbias out, four
    N x N x d products; "bwd_delta": also delta in; "bwd_recompute" (#7):
    qkv, dout, bias and the shift mask in, no p, the scores again;
    "bwd_fused" (#3): qkv, p, dout, x, W in, dx, dW, db, dbias out, also
    the two projection products."""
    tokens, scores = bw * N * c, bw * heads * N * N
    small = heads * N * N * 4
    if kind == "bwd_fused":
        nbytes = (6 * tokens + scores + 6 * c * c + 3 * c) * itemsize + small
        return nbytes, 8 * bw * N * N * c + 6 * scores + 12 * bw * N * c * c
    if kind == "bwd_recompute":
        nw = (res // WINDOW) ** 2 if masked else 0
        return ((7 * tokens) * itemsize + 2 * small + nw * N * N * 4,
                10 * bw * N * N * c + 11 * scores)
    delta = bw * heads * N * 4 if kind == "bwd_delta" else 0
    return ((7 * tokens + scores) * itemsize + small + delta,
            8 * bw * N * N * c + 6 * scores)


def bound_ms(nbytes: float, ops: float, dtype: str) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[dtype])


def pass_bound(kernel: str, dtype: str) -> float:
    """The bound of one pass of `kernel` (48 calls, each call's summed)."""
    itemsize = 4 if dtype == "float32" else 2
    return sum(calls * bound_ms(*cost(KINDS[kernel], bw, c, heads, masked,
                                      res, itemsize), dtype)
               for _, bw, c, heads, res, masked, calls in sites())


def body_part(name: str) -> str:
    """Where a kernel symbol of these calls belongs: the attention body
    (the wa_bwd_* kernels), #3's projection products (the GEMM tile with
    the wa3 epilogues) or the partial sums (torch's reductions)."""
    if "wa3::" in name:
        return "products"
    if "wa_bwd_" in name:
        return "body"
    return "sums"


def stage_tensors(bw, c, heads, res, masked, dt, dev, seed):
    """x, w, bias [H, N, N] f32, mask [nW, N, N] f32 or None, and the
    plain forward's qkv, p, out, with a seeded dout."""
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
        out, qkv, p = wa.window_attention_qkv_fused_fwd(x, w, b, bias, mask,
                                                        heads, impl="plain")
    dout = rand(bw, N, c).to(dt)
    return dict(x=x, w=w, b=b, bias=bias, mask=mask, qkv=qkv, p=p, out=out,
                dout=dout)


def calls(t: dict, heads: int):
    """kernel -> (the kernel's call, its plain version's call)."""
    from gdl_tpu_torch.ops import window_attention as wa

    qkv, p, dout = t["qkv"], t["p"], t["dout"]
    delta = wa.attention_delta(t["out"], dout, heads)

    def pair(fn, *args, **kw):
        return (lambda: fn(*args, **kw),
                lambda: fn(*args, impl="plain", **kw))

    return {
        "4": pair(wa.window_attention_qkv_fused_bwd, qkv, p, dout, heads),
        "4_delta": pair(wa.window_attention_qkv_fused_bwd, qkv, p, dout,
                        heads, delta=delta),
        "6": pair(wa.window_attention_qkv_fused_bwd, qkv, p, dout, heads,
                  transposed=False),
        "7": pair(wa.window_attention_qkv_recompute_bwd, qkv, t["bias"],
                  t["mask"], dout, heads),
        "3": pair(wa.window_attention_qkv_fused_bwd_fused, qkv, p, dout,
                  t["x"], t["w"], heads),
    }


def library_grad(t: dict, heads: int):
    """SDPA forward once on q, k, v and the float mask (bias + mask), all
    requiring grad → a call of torch.autograd.grad of its output."""
    import torch
    import torch.nn.functional as F

    qkv, bias, mask = t["qkv"], t["bias"], t["mask"]
    bw, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = (z.detach().contiguous().requires_grad_(True) for z in
               qkv.reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1,
                                                                4))
    am = bias[None]
    if mask is not None:
        am = (am + mask[:, None]).repeat(bw // mask.shape[0], 1, 1, 1)
    am = am.expand(bw, heads, n, n).to(qkv.dtype).contiguous()
    am.requires_grad_(True)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
    g = t["dout"].reshape(bw, n, heads, c // heads).transpose(1, 2)
    return lambda: torch.autograd.grad(out, (q, k, v, am), g,
                                       retain_graph=True)


def forwards(t: dict, heads: int) -> dict:
    """The forwards that must keep their bits and times → {name: call}."""
    from gdl_tpu_torch.ops import window_attention as wa

    x, w, b, bias, mask, qkv = (t[k] for k in ("x", "w", "b", "bias", "mask",
                                               "qkv"))
    bw, n, c3 = qkv.shape
    q, k, v = (z.contiguous() for z in qkv.reshape(
        bw, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4))
    return {
        "2": lambda: wa.window_attention_qkv_fused_fwd(x, w, b, bias, mask,
                                                       heads),
        "5": lambda: wa.window_attention_qkv_fwd(qkv, bias, mask, heads),
        "6_fwd": lambda: wa.window_attention_qkv_fwd(qkv, bias, mask, heads,
                                                     transposed=False),
        "7_fwd": lambda: wa.window_attention_qkv_recompute_fwd(qkv, bias,
                                                               mask, heads),
        "1": lambda: wa.window_attention_qkv_fused_eval(x, w, b, bias, mask,
                                                        heads),
        "8": lambda: wa.window_attention_bhnd(q, k, v, bias, mask),
        "9": lambda: wa.window_attention_packed(q, k, v, bias, mask),
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
    keys = ("ms", "run_ms", "plain_ms", "body_ms", "products_ms", "sums_ms")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        tot = {kern: dict.fromkeys(keys, 0.0) for kern in KINDS}
        fwd_ms, digests, lib_ms = {}, {}, 0.0
        rows = {}
        for k, (stage, bw, c, heads, res, masked, ncalls) in enumerate(
                sites()):
            t = stage_tensors(bw, c, heads, res, masked, dt, dev, 300 + k)
            site = f"{stage}{'_shifted' if masked else ''}"
            rows[site] = {}
            with torch.no_grad():
                for kern, (kernel, plain) in calls(t, heads).items():
                    row = {"ms": cuda_ms(kernel), "run_ms": run_ms(kernel),
                           "plain_ms": cuda_ms(plain, reps=5, warmup=1)}
                    parts, _ = split_ms(kernel, body_part, TRACED)
                    for part in ("body", "products", "sums"):
                        row[part + "_ms"] = parts.get(part, 0.0)
                    rows[site][kern] = row
                    for key in keys:
                        tot[kern][key] += ncalls * row[key]
                for name, fn in forwards(t, heads).items():
                    fwd_ms[name] = fwd_ms.get(name, 0.0) + ncalls * run_ms(fn)
                    h = digests.setdefault(name, hashlib.sha256())
                    _digest(h, fn())
            lib_ms += ncalls * run_ms(library_grad(t, heads))
            del t
            torch.cuda.empty_cache()
        for kern in KINDS:
            tot[kern]["bound_ms"] = pass_bound(kern, dtype)
            tot[kern]["bound_share"] = (tot[kern]["bound_ms"]
                                        / tot[kern]["run_ms"])
        out["dtypes"][dtype] = {
            "per_pass": tot, "library_run_ms": lib_ms,
            "forwards_run_ms": fwd_ms,
            "forwards_sha256": {k: h.hexdigest() for k, h in
                                digests.items()},
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
        print("bench_wa_attn_bwd: no CUDA device", file=sys.stderr)
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
                dt: {"per_pass": r["per_pass"],
                     "library_run_ms": r["library_run_ms"],
                     "forwards_run_ms": r["forwards_run_ms"]}
                for dt, r in res["dtypes"].items()}}), flush=True)
        for dt in runs[0]["dtypes"]:
            same = all(r["dtypes"][dt]["forwards_sha256"]
                       == runs[0]["dtypes"][dt]["forwards_sha256"]
                       for r in runs)
            print(json.dumps({"forwards_bits_equal_across_roots": same,
                              "dtype": dt}), flush=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
