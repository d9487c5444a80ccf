#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gdl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each printing one JSON line:
  a. device   the card's name and count, and its name and power limit
              as nvidia-smi reports them;
  b. build    nvcc builds every CUDA kernel of the path from the sources
              in gdl_tpu_torch/kernels (one process per source);
  c. parity   each kernel against its plain PyTorch version on the card,
              at the shapes the serving path gives it (dual Swin-B,
              batch 16), in float32 and bfloat16, with median times of
              both (CUDA events, 20 reps);
  d. serve    the serving path at full Swin-B width (CREMA-D, fps 1):
              seeded weights are torch.save-d as a reference-schema .pth,
              loaded through gdl_tpu_torch.serve.load_from_checkpoint, and
              4 requests of 16 raw synthetic clips go through the eval
              step, in float32 and in bf16 autocast; launch counts are
              reset just before and read just after this run; the logits
              are held to the same weights run with the plain attention;
  e. kernels  one line per kernel: route, source, the TPU kernel it
              replaces, launches in phase d, error and times.
Then the nvidia-smi line, and last {"ok": true, "device": {...}}.

Exits non-zero without the ok line when CUDA is unavailable or any phase
fails. Uses one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

BATCH = 16
N_REQUESTS = 4
REPS = 20
KERNEL = "window_attention_qkv_fused_eval"
TOL = {"float32": dict(atol=2e-4, rtol=2e-4), "bfloat16": dict(atol=3e-2,
                                                               rtol=0.0)}
# serving logits, kernel path vs plain path with the same weights
SERVE_ATOL = {"float32": 1e-3, "bfloat16": 5e-2}
MIN_ARGMAX_AGREE = 15  # of 16 rows per request


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of one call of fn, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# (stage, windows at batch 16, C, heads, map side) of dual Swin-B at 224²
STAGES = [(0, 1024, 128, 4, 56), (1, 256, 256, 8, 28), (2, 64, 512, 16, 14),
          (3, 16, 1024, 32, 7)]
DEPTHS = (2, 2, 18, 2)


def phase_parity(failures):
    import numpy as np
    import torch

    from gdl_tpu_torch.models.swin import (
        relative_position_index,
        shift_attn_mask,
    )
    from gdl_tpu_torch.ops.window_attention import (
        window_attention_qkv_fused_eval,
    )

    dev = torch.device("cuda")
    results = []
    for stage, bw, c, heads, res in STAGES:
        rng = np.random.default_rng(100 + stage)
        n = 49
        x = rng.standard_normal((bw, n, c)).astype(np.float32)
        w = (rng.standard_normal((3 * c, c)) * c ** -0.5).astype(np.float32)
        b = (rng.standard_normal(3 * c) * 0.1).astype(np.float32)
        table = (rng.standard_normal((169, heads)) * 0.5).astype(np.float32)
        bias = np.ascontiguousarray(table[relative_position_index(7).reshape(
            -1)].reshape(n, n, heads).transpose(2, 0, 1))
        bias_t = torch.from_numpy(bias).to(dev)
        masks = [None]
        if res > 7:
            masks.append(torch.from_numpy(shift_attn_mask(res, res, 7, 3))
                         .to(dev))
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            xs, ws, bs = (torch.from_numpy(a).to(dev, dt) for a in (x, w, b))
            for mask in masks:
                def run(impl, mask=mask):
                    return window_attention_qkv_fused_eval(
                        xs, ws, bs, bias_t, mask, heads, impl=impl)

                with torch.inference_mode():
                    got = run("auto")
                    want = run("plain")
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs()
                    tol = TOL[dtype]
                    bound = tol["atol"] + tol["rtol"] * want.float().abs()
                    ok = bool(torch.isfinite(got).all()) and bool(
                        (err <= bound).all())
                    ms = cuda_ms(lambda: run("auto"))
                    plain_ms = cuda_ms(lambda: run("plain"))
                row = {"phase": "parity", "kernel": KERNEL, "stage": stage,
                       "Bw": bw, "C": c, "H": heads, "N": n,
                       "mask": mask is not None, "dtype": dtype,
                       "max_abs_err": float(err.max()), **tol, "ok": ok,
                       "ms": ms, "plain_ms": plain_ms}
                emit(row)
                results.append(row)
                if not ok:
                    failures.append(f"parity stage {stage} {dtype} "
                                    f"mask={mask is not None}")
    return results


def per_request_ms(results, dtype: str, key: str) -> float:
    """Attention time of one request (both encoders, all 48 launches)
    from the per-shape medians: even blocks unshifted, odd blocks shifted
    wherever the window does not cover the map."""
    t = {(r["stage"], r["mask"]): r[key] for r in results
         if r["dtype"] == dtype}
    total = 0.0
    for (stage, _, _, _, res), depth in zip(STAGES, DEPTHS):
        for i in range(depth):
            total += t[(stage, i % 2 == 1 and res > 7)]
    return 2 * total


def phase_serve(failures):
    import torch

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.config import Config
    from gdl_tpu_torch.data.synthetic import synthetic_batch
    from gdl_tpu_torch.serve import ServedModel, build_model, \
        load_from_checkpoint

    cfg = Config(dataset="CREMAD", backbone="swin", fusion_method="concat",
                 fps=1, batch_size=BATCH)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=1234)
    n_params = sum(p.numel() for p in model.parameters())
    requests = [synthetic_batch(cfg, BATCH, seed=k)
                for k in range(N_REQUESTS)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "best_model.pth")
        torch.save({"model": {"module." + k: v for k, v in
                              model.state_dict().items()},
                    "fusion": cfg.fusion_method}, path)
        del model
        served = {}
        for impl in ("auto", "plain"):
            f32 = load_from_checkpoint(cfg, path, device="cuda",
                                       compute_dtype="float32",
                                       attn_impl=impl)
            served[(impl, "float32")] = f32
            served[(impl, "bfloat16")] = ServedModel(
                f32.model, cfg, "cuda", torch.bfloat16)
    setup_s = time.perf_counter() - t0

    def drive(impl, dtype):
        outs, ms = [], []
        for batch in requests:
            t = time.perf_counter()
            res = served[(impl, dtype)].eval_batch(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            outs.append(res)
        return outs, sorted(ms)[len(ms) // 2]

    for key in served:  # warm-up: allocator, cuDNN and kernel load
        drive(*key)

    dtypes = ("float32", "bfloat16")
    kernels.reset_launch_counts()
    kern = {dt: drive("auto", dt) for dt in dtypes}
    launches = dict(kernels.launch_counts)
    plain = {dt: drive("plain", dt) for dt in dtypes}

    expected = 2 * sum(DEPTHS) * N_REQUESTS * len(dtypes)
    if launches[KERNEL] != expected:
        failures.append(f"serve: {launches[KERNEL]} kernel launches, "
                        f"expected {expected}")
    for dt in dtypes:
        worst, agree_min = 0.0, BATCH
        for got, want in zip(kern[dt][0], plain[dt][0]):
            for g, w in zip(got["logits"], want["logits"]):
                if tuple(g.shape) != (BATCH, cfg.n_classes) or not bool(
                        torch.isfinite(g).all()):
                    failures.append(f"serve {dt}: bad logits {g.shape}")
                worst = max(worst, float((g - w).abs().max()))
            for k in ("pred", "pred_a", "pred_v"):
                agree_min = min(agree_min,
                                int((got[k] == want[k]).sum()))
        ok = worst <= SERVE_ATOL[dt] and agree_min >= MIN_ARGMAX_AGREE
        if not ok:
            failures.append(f"serve {dt}: max |dlogit| {worst}, argmax "
                            f"agreement {agree_min}/{BATCH}")
        emit({"phase": "serve", "dtype": dt, "batch": BATCH,
              "requests": N_REQUESTS, "params": n_params,
              "ms_per_request": kern[dt][1],
              "clips_per_s": BATCH / kern[dt][1] * 1e3,
              "plain_ms_per_request": plain[dt][1],
              "plain_clips_per_s": BATCH / plain[dt][1] * 1e3,
              "max_abs_logit_err": worst, "atol": SERVE_ATOL[dt],
              "min_argmax_agree": agree_min, "ok": ok,
              "setup_s": setup_s})
    return launches, expected


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every result line to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("CUDA is not available; nothing was run")
        return 2
    from gdl_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures: list = []
    record = {}
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    record["device"] = {"phase": "device", "name": name,
                        "count": torch.cuda.device_count(),
                        "nvidia_smi": smi, "torch": torch.__version__,
                        "cuda": torch.version.cuda}
    emit(record["device"])

    t = time.perf_counter()
    built = kernels.build()
    record["build"] = {"phase": "build",
                       "seconds": time.perf_counter() - t,
                       "kernels": {k: {"seconds": v["seconds"],
                                       "ptxas": [ln.strip() for ln in
                                                 v["ptxas"].splitlines()
                                                 if "Used" in ln]}
                                   for k, v in built.items()}}
    emit(record["build"])

    try:
        parity = phase_parity(failures)
    except Exception:  # report and go on to the next phase
        traceback.print_exc()
        failures.append("parity raised")
        parity = []
    record["parity"] = parity

    launches, expected = {KERNEL: 0}, 0
    try:
        launches, expected = phase_serve(failures)
    except Exception:
        traceback.print_exc()
        failures.append("serve raised")

    f32 = [r for r in parity if r["dtype"] == "float32"]
    entry = {"name": KERNEL, "route": "cuda",
             "source": "gdl_tpu_torch/kernels/window_attention_eval.cu",
             "replaces": "gdl_tpu/ops/window_attention.py:1530",
             "launches": launches[KERNEL],
             "max_abs_err": max((r["max_abs_err"] for r in f32),
                                default=None)}
    if len(f32) == 7:
        entry["ms"] = per_request_ms(parity, "float32", "ms")
        entry["plain_ms"] = per_request_ms(parity, "float32", "plain_ms")
    record["kernels"] = {"kernels": [entry]}
    record["failures"] = failures
    record["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    if launches[KERNEL] == 0:
        failures.append(f"{KERNEL} was never launched on the serving path")
    if failures:
        for f in failures:
            log(f"FAILED: {f}")
        return 1
    emit(record["kernels"])
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
