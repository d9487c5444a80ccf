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
  e. train parity
              the training kernels #2 (save-p forward) and #4 (attention
              backward) against their plain versions at the shapes the
              training path gives them (dual Swin-B, batch 32), in
              float32 and bfloat16: out, qkv and p; dqkv and dbias; and
              the whole op's dx, dW, db and dbias against the plain op;
              median times of both (CUDA events, 20 reps);
  f. train    the DGL training path at full Swin-B width (VGGSound, fps
              1, batch 32, concat DGL, alpha 4, droppath 0.1, SGD, clip
              40; benchmarks/run_all.py swin_dgl_bs32): seeded weights go
              to two arms, the kernels and the plain attention, each
              taking 1 warm-up + 4 steps on the same raw synthetic
              batches (preprocessed inside the step) with identically
              seeded generators, in float32 and under bf16 autocast;
              launch counts are reset just before and read just after
              each step; losses and float32 parameters of the two arms
              are held to each other; then 8 more steps per arm, in
              turns, give the median ms/step;
  g. kernels  one line per kernel: route, source, the TPU kernel it
              replaces, launches on its path (d for #1, the kernel arm
              of f for #2 and #4), error and times.
Then the nvidia-smi line, and last {"ok": true, "device": {...}}.

Exits non-zero without the ok line when CUDA is unavailable or any phase
fails. Uses one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
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

SAVEP = "window_attention_qkv_fused_savep"
BWD = "window_attention_qkv_fused_bwd"
TRAIN_BATCH = 32
TRAIN_STEPS = 4  # after one warm-up step
TIME_ROUNDS = 8  # timed steps per arm after the checked ones
# training kernels vs their plain versions: forward outputs elementwise
# (atol + rtol·|want|); gradients by their largest error against the
# reference's largest |value|
TRAIN_FWD_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
                 "bfloat16": dict(atol=3e-2, rtol=1e-2)}
TRAIN_GRAD_FRAC = {"float32": 2e-4, "bfloat16": 2e-2}
# the training path, kernel arm vs plain arm
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
PARAM_ATOL = 1e-4  # float32 parameters after the checked steps


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


def stage_inputs(stage, bw, c, heads, res, dev):
    """Seeded x [Bw,49,C], w [3C,C], b [3C] (numpy f32), the relative
    position bias [H,49,49] and the masks the stage's blocks use."""
    import numpy as np
    import torch

    from gdl_tpu_torch.models.swin import (
        relative_position_index,
        shift_attn_mask,
    )

    rng = np.random.default_rng(100 + stage)
    n = 49
    x = rng.standard_normal((bw, n, c)).astype(np.float32)
    w = (rng.standard_normal((3 * c, c)) * c ** -0.5).astype(np.float32)
    b = (rng.standard_normal(3 * c) * 0.1).astype(np.float32)
    table = (rng.standard_normal((169, heads)) * 0.5).astype(np.float32)
    bias = np.ascontiguousarray(table[relative_position_index(7).reshape(
        -1)].reshape(n, n, heads).transpose(2, 0, 1))
    masks = [None]
    if res > 7:
        masks.append(torch.from_numpy(shift_attn_mask(res, res, 7, 3))
                     .to(dev))
    return (x, w, b), torch.from_numpy(bias).to(dev), masks


def phase_parity(failures):
    import torch

    from gdl_tpu_torch.ops.window_attention import (
        window_attention_qkv_fused_eval,
    )

    dev = torch.device("cuda")
    results = []
    n = 49
    for stage, bw, c, heads, res in STAGES:
        arrays, bias_t, masks = stage_inputs(stage, bw, c, heads, res, dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            xs, ws, bs = (torch.from_numpy(a).to(dev, dt) for a in arrays)
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


def per_pass_ms(results, dtype: str, key: str) -> float:
    """Attention time of one request or training step (both encoders, all
    48 launches) from the per-shape medians: even blocks unshifted, odd
    blocks shifted wherever the window does not cover the map."""
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


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _fwd_ok(got, want, dtype) -> bool:
    tol = TRAIN_FWD_TOL[dtype]
    bound = tol["atol"] + tol["rtol"] * want.float().abs()
    return bool(_finite(got)) and bool(
        ((got.float() - want.float()).abs() <= bound).all())


def _grad_ok(got, want, dtype) -> bool:
    return bool(_finite(got)) and _max_err(got, want) <= (
        TRAIN_GRAD_FRAC[dtype] * float(want.float().abs().max()))


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def phase_train_parity(failures):
    """Kernels #2 and #4, and the training op they make up, against their
    plain versions at the batch-32 training shapes."""
    import torch

    from gdl_tpu_torch.ops.window_attention import (
        window_attention_qkv_fused,
        window_attention_qkv_fused_bwd,
        window_attention_qkv_fused_fwd,
    )

    dev = torch.device("cuda")
    scale_b = TRAIN_BATCH // BATCH
    results = []
    for stage, bw16, c, heads, res in STAGES:
        bw = bw16 * scale_b
        arrays, bias_t, masks = stage_inputs(stage, bw, c, heads, res, dev)
        gen = torch.Generator(device=dev).manual_seed(200 + stage)
        dout32 = torch.randn((bw, 49, c), generator=gen, device=dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            args = [torch.from_numpy(a).to(dev, dt) for a in arrays]
            dout = dout32.to(dt)
            for mask in masks:
                errs, oks = {}, []
                with torch.no_grad():
                    got = window_attention_qkv_fused_fwd(*args, bias_t, mask,
                                                         heads)
                    want = window_attention_qkv_fused_fwd(
                        *args, bias_t, mask, heads, impl="plain")
                    for name, g, w in zip(("out", "qkv", "p"), got, want):
                        errs[name] = _max_err(g, w)
                        oks.append(_fwd_ok(g, w, dtype))
                    _, qkv, p = want
                    gb = window_attention_qkv_fused_bwd(qkv, p, dout, heads)
                    wb = window_attention_qkv_fused_bwd(qkv, p, dout, heads,
                                                        impl="plain")
                    for name, g, w in zip(("dqkv", "dbias"), gb, wb):
                        errs[name] = _max_err(g, w)
                        oks.append(_grad_ok(g, w, dtype))
                grads = {}
                for impl in ("auto", "plain"):
                    leaves = [a.clone().requires_grad_(True)
                              for a in args + [bias_t]]
                    out = window_attention_qkv_fused(
                        *leaves[:3], leaves[3], mask, heads, impl=impl)
                    out.backward(dout)
                    grads[impl] = [t.grad for t in leaves]
                    del out, leaves
                for name, g, w in zip(("op_dx", "op_dW", "op_db",
                                       "op_dbias"), grads["auto"],
                                      grads["plain"]):
                    errs[name] = _max_err(g, w)
                    oks.append(_grad_ok(g, w, dtype))
                del grads
                with torch.no_grad():
                    times = {
                        "fwd_ms": cuda_ms(lambda: window_attention_qkv_fused_fwd(
                            *args, bias_t, mask, heads)),
                        "fwd_plain_ms": cuda_ms(
                            lambda: window_attention_qkv_fused_fwd(
                                *args, bias_t, mask, heads, impl="plain")),
                        "bwd_ms": cuda_ms(lambda: window_attention_qkv_fused_bwd(
                            qkv, p, dout, heads)),
                        "bwd_plain_ms": cuda_ms(
                            lambda: window_attention_qkv_fused_bwd(
                                qkv, p, dout, heads, impl="plain")),
                    }
                torch.cuda.synchronize()
                ok = all(oks)
                row = {"phase": "train_parity", "kernels": [SAVEP, BWD],
                       "stage": stage, "Bw": bw, "C": c, "H": heads, "N": 49,
                       "mask": mask is not None, "dtype": dtype,
                       "max_abs_err": errs, "fwd_tol": TRAIN_FWD_TOL[dtype],
                       "grad_frac_of_max": TRAIN_GRAD_FRAC[dtype], "ok": ok,
                       **times}
                emit(row)
                results.append(row)
                if not ok:
                    failures.append(f"train parity stage {stage} {dtype} "
                                    f"mask={mask is not None}")
    return results


def phase_train(failures, smi: str):
    """The DGL training path, kernel arm and plain arm, from one set of
    seeded weights. Returns the kernel arm's launch counts."""
    import torch

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.config import Config
    from gdl_tpu_torch.data.preprocess import make_train_preprocess
    from gdl_tpu_torch.data.synthetic import synthetic_batch
    from gdl_tpu_torch.models.swin import WindowAttention
    from gdl_tpu_torch.serve import build_model
    from gdl_tpu_torch.train.dgl import make_dgl_train_step
    from gdl_tpu_torch.train.optim import make_optimizer

    dev = torch.device("cuda")
    cfg = Config(dataset="VGGSound", backbone="swin", fusion_method="concat",
                 modality="full", fps=1, batch_size=TRAIN_BATCH,
                 log_grad_csv=False)
    t0 = time.perf_counter()
    base = build_model(cfg, seed=4321)  # droppath 0.1, on the CPU
    n_params = sum(p.numel() for p in base.parameters())
    batches = [synthetic_batch(cfg, TRAIN_BATCH, seed=300 + k)
               for k in range(1 + TRAIN_STEPS)]
    setup_s = time.perf_counter() - t0
    expected = 2 * sum(DEPTHS)  # per step, of each training kernel
    kernel_launches = {SAVEP: 0, BWD: 0}

    def drive(step, batch, dtype):
        """One step → (metrics, host ms, launch counts of this step)."""
        kernels.reset_launch_counts()
        t = time.perf_counter()
        with torch.autocast(dev.type, dtype=torch.bfloat16,
                            enabled=dtype == "bfloat16"):
            m = step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        return ({k: float(v) for k, v in m.items()}, ms,
                dict(kernels.launch_counts))

    def run_arm(impl, dtype):
        model = copy.deepcopy(base).to(dev)
        for m in model.modules():
            if isinstance(m, WindowAttention):
                m.attn_impl = impl
        opt = make_optimizer(cfg, model.parameters(), steps_per_epoch=100)
        gen = torch.Generator(device=dev).manual_seed(cfg.random_seed)
        step = make_dgl_train_step(model, cfg, opt, clip_norm=40.0,
                                   preprocess=make_train_preprocess(cfg, dev),
                                   generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [drive(step, batch, dtype) for batch in batches]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return dict(model=model, step=step, peak=peak,
                    metrics=[r[0] for r in runs], ms=[r[1] for r in runs],
                    launches=[r[2] for r in runs])

    for dtype in ("float32", "bfloat16"):
        # arms in turns: plain first in f32, kernel first in bf16
        order = ("plain", "auto") if dtype == "float32" else ("auto",
                                                              "plain")
        arms = {impl: run_arm(impl, dtype) for impl in order}
        param_err = None  # after the checked steps, before the timed ones
        if dtype == "float32":
            with torch.no_grad():
                param_err = max(
                    float((a - b).abs().max()) for a, b in
                    zip(arms["auto"]["model"].parameters(),
                        arms["plain"]["model"].parameters()))
        # timing: TIME_ROUNDS more steps per arm in turns (P,K,K,P,...);
        # the checked steps above include allocator and autotuning warm-up
        timed = {impl: [] for impl in arms}
        for r in range(TIME_ROUNDS):
            for impl in (order if r % 2 == 0 else order[::-1]):
                batch = batches[r % len(batches)]
                timed[impl].append(drive(arms[impl]["step"], batch,
                                         dtype)[1])
        for impl in order:
            arm, ms = arms[impl], sorted(timed[impl])
            med = ms[len(ms) // 2]
            emit({"phase": "train", "dtype": dtype,
                  "arm": "kernel" if impl == "auto" else "plain",
                  "batch": TRAIN_BATCH, "ms_per_step": med,
                  "clips_per_s": TRAIN_BATCH / med * 1e3,
                  "timed_step_ms": timed[impl],
                  "checked_step_ms": arm["ms"], "peak_mem_gib": arm["peak"],
                  "loss": [m["loss"] for m in arm["metrics"]],
                  "grad_norm": [m["grad_norm"] for m in arm["metrics"]],
                  "params": n_params, "setup_s": setup_s,
                  "nvidia_smi": smi})
        k_metrics, k_launch = (arms["auto"][k] for k in ("metrics",
                                                         "launches"))
        p_metrics, p_launch = (arms["plain"][k] for k in ("metrics",
                                                          "launches"))
        problems = []
        for i, (lk, lp) in enumerate(zip(k_launch, p_launch)):
            if (lk[SAVEP], lk[BWD], lk[KERNEL]) != (expected, expected, 0):
                problems.append(f"step {i}: kernel arm launches {lk}")
            if any(lp.values()):
                problems.append(f"step {i}: plain arm launches {lp}")
            for name in (SAVEP, BWD):
                kernel_launches[name] += lk[name]
        worst_rel = 0.0
        for i, (mk, mp) in enumerate(zip(k_metrics, p_metrics)):
            for key in ("loss", "loss_a", "loss_v", "loss_f"):
                a, b = mk[key], mp[key]
                if not (math.isfinite(a) and math.isfinite(b)):
                    problems.append(f"step {i}: {key} not finite")
                    continue
                worst_rel = max(worst_rel, abs(a - b) / max(abs(b), 1e-12))
        if worst_rel > LOSS_RTOL[dtype]:
            problems.append(f"losses differ by {worst_rel} relative")
        if param_err is not None and param_err > PARAM_ATOL:
            problems.append(f"parameters differ by {param_err}")
        ok = not problems
        emit({"phase": "train_check", "dtype": dtype,
              "max_rel_loss_diff": worst_rel, "loss_rtol": LOSS_RTOL[dtype],
              "max_abs_param_diff": param_err,
              "param_atol": PARAM_ATOL if dtype == "float32" else None,
              "launches_per_step": expected, "problems": problems, "ok": ok})
        failures.extend(f"train {dtype}: {p}" for p in problems)
        del arms
        torch.cuda.empty_cache()
    return kernel_launches


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

    try:
        train_parity = phase_train_parity(failures)
    except Exception:
        traceback.print_exc()
        failures.append("train parity raised")
        train_parity = []
    record["train_parity"] = train_parity

    train_launches = {SAVEP: 0, BWD: 0}
    try:
        train_launches = phase_train(failures, smi)
    except Exception:
        traceback.print_exc()
        failures.append("train raised")

    f32 = [r for r in parity if r["dtype"] == "float32"]
    t32 = [r for r in train_parity if r["dtype"] == "float32"]
    src = "gdl_tpu_torch/kernels/"
    entries = [
        {"name": KERNEL, "route": "cuda",
         "source": src + "window_attention_eval.cu",
         "replaces": "gdl_tpu/ops/window_attention.py:1530",
         "launches": launches[KERNEL],
         "max_abs_err": max((r["max_abs_err"] for r in f32), default=None)},
        {"name": SAVEP, "route": "cuda",
         "source": src + "window_attention_train.cu",
         "replaces": "gdl_tpu/ops/window_attention.py:1227",
         "launches": train_launches[SAVEP],
         "max_abs_err": max((max(r["max_abs_err"][k] for k in
                                 ("out", "qkv", "p")) for r in t32),
                            default=None)},
        {"name": BWD, "route": "cuda",
         "source": src + "window_attention_train.cu",
         "replaces": "gdl_tpu/ops/window_attention.py:937",
         "launches": train_launches[BWD],
         "max_abs_err": max((max(r["max_abs_err"][k] for k in
                                 ("dqkv", "dbias")) for r in t32),
                            default=None)},
    ]
    # per request (#1, batch 16) or per training step (#2, #4, batch 32):
    # the sum over the 48 launches of the float32 per-shape medians
    if len(f32) == 7:
        entries[0]["ms"] = per_pass_ms(parity, "float32", "ms")
        entries[0]["plain_ms"] = per_pass_ms(parity, "float32",
                                                "plain_ms")
    if len(t32) == 7:
        for entry, key in ((entries[1], "fwd"), (entries[2], "bwd")):
            entry["ms"] = per_pass_ms(train_parity, "float32", key + "_ms")
            entry["plain_ms"] = per_pass_ms(train_parity, "float32",
                                            key + "_plain_ms")
    record["kernels"] = {"kernels": entries}
    record["failures"] = failures
    record["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    if launches[KERNEL] == 0:
        failures.append(f"{KERNEL} was never launched on the serving path")
    for k in (SAVEP, BWD):
        if train_launches[k] == 0:
            failures.append(f"{k} was never launched on the training path")
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
