"""Time the dropout-mask generator (kernel #14, `kernels/dropout_mask.cu`)
per mmformer_n training step and the stem max-pool's backward (kernel #16,
`kernels/maxpool_bwd.cu`) per ResNet-18 or mmformer_n step on the GPU, and
compare checkouts of this repository in turns.

    python -m gdl_tpu_torch.bench_mask_pool [--roots DIR [DIR ...]]
        [--out F]

A batch-64 mmformer_n step draws 28 masks at rate 0.1 (`MASK_CALLS`: per
block three of [B*N, 512] and one of [B*N, 4096], N = 196 for the four
intra blocks and 392 for the three inter ones); a batch-64 step of either
model pools two stems (`POOL_SHAPES`: x [64, 112, 112, 64] visual and
[64, 129, 94, 64] audio, channel-last). For each dtype (float32,
bfloat16), on seed words drawn from a seeded generator and seeded
x = relu(randn) and g = randn, the script times each kernel through its
op at every shape and sums over the step:

  "14"  prng_dropout_mask (28 calls)
  "16"  max_pool_3x3_s2_bwd (2 calls)

each as the median of 20 single calls after a warm-up (`ms`), in a run of
20 calls between two events (`run_ms`), and by a torch.profiler trace of
ten calls (`device_ms`: the kernel's own device time, without the op
wrapper's host code; a trace that holds fewer of the kernel's records
than calls, as when the tracer drops a buffer of them, is taken again);
its plain version (`plain_ms`); the library call that computes the same
function, in runs of 20 (`library_run_ms`:
`torch.rand` + compare + `torch.where`; `aten.max_pool2d_with_indices_
backward` on the NCHW views with the forward's indices made beforehand);
and its bound (`bound_ms`: the larger of the bytes moved once over 3.35
TB/s and the operations over 67 TFLOP/s, as `chip_smoke.mask_cost` and
`chip_smoke.pool_cost` count them; `bound_share` = bound / device time).
A SHA-256 digest of each kernel's outputs at every shape shows whether
two checkouts give the same bits.

With --roots, each DIR (a checkout of this repository, e.g. the parent
commit unpacked by `git archive`) is timed in a process of its own, in
the order given, so that `--roots parent . . parent` compares two
versions on one card in turns; every pair of roots is reported with
whether their outputs' bits are equal. Each process builds its
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
)

RATE = 0.1
# the masks of one mmformer_n step, {[rows, cols]: calls}
MASK_CALLS = {(12544, 512): 12, (12544, 4096): 4, (25088, 512): 9,
              (25088, 4096): 3}
# the stems' activations [B, H, W, C] reaching the pool, one call each
POOL_SHAPES = {"visual": (64, 112, 112, 64), "audio": (64, 129, 94, 64)}
KERNEL_SYMBOLS = {"14": "dropout_mask_kernel", "16": "maxpool_bwd_kernel"}
TRACED = 10
TRACE_TRIES = 3
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12  # float32; the integer work of #14 is counted at it
MARK = "bench_mask_pool "  # the result line, among whatever else


def mask_cost(numel: int, itemsize: int):
    """(bytes, operations) of one mask: every element written once and
    the two seed words read; 98 integer operations a group of four (10
    Philox rounds of 2 wide multiplies, 3 xors and 2 key additions, then
    4 compares and selects)."""
    return numel * itemsize + 8, 98 * ((numel + 3) // 4)


def pool_cost(shape, itemsize: int):
    """(bytes, operations) of one pool backward: x read once, g read once,
    dx written once; 9 compares and an add a cotangent."""
    b, h, w, c = shape
    g = b * ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1) * c
    return (2 * b * h * w * c + g) * itemsize, 10 * g


def bound_ms(nbytes: float, ops: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S)


def step_bound(kernel: str, dtype: str) -> float:
    """The bound of one step of `kernel`, each call's summed."""
    itemsize = 4 if dtype == "float32" else 2
    if kernel == "14":
        return sum(n * bound_ms(*mask_cost(r * c, itemsize))
                   for (r, c), n in MASK_CALLS.items())
    return sum(bound_ms(*pool_cost(s, itemsize)) for s in POOL_SHAPES.values())


def calls_of(kernel: str):
    """(shape, calls a step) of each call of `kernel`'s step."""
    if kernel == "14":
        return list(MASK_CALLS.items())
    return [(s, 1) for s in POOL_SHAPES.values()]


def kernel_ms(fn, symbol: str, traced: int = TRACED) -> float:
    """Device ms of one call of `fn`, which launches the kernel `symbol`
    once: a torch.profiler trace of `traced` calls, taken again (at most
    TRACE_TRIES times in all) while it holds fewer records of `symbol`
    than calls. It lives here, not in bench_common: a checkout timed by
    --roots brings its own bench_common, which may predate it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(traced):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if symbol in ev.key]
        if sum(ev.count for ev in evs) >= traced:
            us = sum(getattr(ev, "device_time_total", None)
                     or ev.cuda_time_total for ev in evs)
            return us / 1e3 / traced
    raise RuntimeError(f"the tracer kept no record of {traced} launches "
                       f"of {symbol} in {TRACE_TRIES} traces")


def _digest(h, out) -> None:
    import torch

    z = out.detach().contiguous()
    z = z.view(torch.int16 if z.element_size() == 2 else torch.int32)
    h.update(z.cpu().numpy().tobytes())


def mask_calls(shape, dt, dev, seed):
    """(kernel call, plain call, library call) of one mask shape."""
    import torch

    from gdl_tpu_torch.ops.dropout import (
        fold_seed_words,
        keep_threshold,
        prng_dropout_mask,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    words = fold_seed_words(gen, dev)
    kept = torch.tensor(1.0 / (1.0 - RATE)).to(dt).to(dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    thresh = keep_threshold(RATE) / 2.0 ** 32

    def library():
        return torch.where(torch.rand(shape, device=dev) < thresh, kept, zero)

    return (lambda: prng_dropout_mask(words, shape, RATE, dt),
            lambda: prng_dropout_mask(words, shape, RATE, dt, impl="plain"),
            library)


def pool_calls(shape, dt, dev, seed):
    """(kernel call, plain call, library call) of one stem's pool."""
    import torch

    from gdl_tpu_torch.ops.maxpool import max_pool_3x3_s2_bwd

    b, h, w, c = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn(shape, generator=gen, device=dev)).to(dt)
    g = torch.randn((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c),
                    generator=gen, device=dev).to(dt)
    aten = torch.ops.aten
    args = ([3, 3], [2, 2], [1, 1], [1, 1], False)
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    _, idx = aten.max_pool2d_with_indices(xn, *args)
    return (lambda: max_pool_3x3_s2_bwd(x, g),
            lambda: max_pool_3x3_s2_bwd(x, g, impl="plain"),
            lambda: aten.max_pool2d_with_indices_backward(gn, xn, *args, idx))


def worker() -> dict:
    import torch

    from gdl_tpu_torch import kernels

    kernels.build(["dropout_mask", "maxpool_bwd"])
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "dtypes": {}}
    keys = ("ms", "run_ms", "device_ms", "plain_ms", "library_run_ms")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        tot = {k: dict.fromkeys(keys, 0.0) for k in KERNEL_SYMBOLS}
        digests = {k: hashlib.sha256() for k in KERNEL_SYMBOLS}
        rows = {}
        for kern, make in (("14", mask_calls), ("16", pool_calls)):
            symbol = KERNEL_SYMBOLS[kern]
            for i, (shape, ncalls) in enumerate(calls_of(kern)):
                kernel, plain, library = make(shape, dt, dev, 500 + i)
                with torch.no_grad():
                    row = {"calls": ncalls, "ms": cuda_ms(kernel),
                           "run_ms": run_ms(kernel),
                           "plain_ms": cuda_ms(plain, reps=3, warmup=1),
                           "library_run_ms": run_ms(library)}
                    row["device_ms"] = kernel_ms(kernel, symbol)
                    _digest(digests[kern], kernel())
                rows[f"{kern}_{'x'.join(map(str, shape))}"] = row
                for key in keys:
                    tot[kern][key] += ncalls * row[key]
                del kernel, plain, library
                torch.cuda.empty_cache()
        for kern in KERNEL_SYMBOLS:
            tot[kern]["bound_ms"] = step_bound(kern, dtype)
            tot[kern]["bound_share"] = (tot[kern]["bound_ms"]
                                        / tot[kern]["device_ms"])
        out["dtypes"][dtype] = {
            "per_step": tot,
            "sha256": {k: h.hexdigest() for k, h in digests.items()},
            "shapes": rows}
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
        print("bench_mask_pool: no CUDA device", file=sys.stderr)
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
