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
              both and of F.linear + SDPA with bias + mask as its float
              mask, the same work in two library calls (CUDA events, 20
              reps);
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
              median times of both, and of F.linear + SDPA beside #2
              (CUDA events, 20 reps);
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
  h. maxpool parity
              kernel #16 (the stem max-pool's backward) against its plain
              version and against aten.max_pool2d_with_indices_backward
              at the two stem shapes of the ResNet path (batch 64), in
              float32 and bfloat16, on a ReLU-like input (half the values
              exactly 0) and on an all-equal input: dx must be BIT-EQUAL
              to the plain version's and across two runs; the library
              sums the (at most four) cotangents that meet in an element
              in another order, so it is held to 4 eps of the sum of
              their magnitudes; median times of all three (CUDA events,
              20 reps);
  i. resnet   the flagship training path at full ResNet-18 width
              (CREMA-D, fps 1, batch 64, concat DGL, alpha 5, lr 2e-3,
              SGD, clip 40; bench.py's _measure_dgl config) through
              build_harness, a Loader over a SyntheticDataset,
              train_one_epoch and evaluate: seeded weights go to two
              arms, the kernel and the plain max-pool backward, in
              float32 and under bf16 autocast; 3 checked steps (cuDNN
              set to its deterministic algorithms) whose losses, float32
              parameters and BatchNorm running statistics are held to
              each other, with exactly 2 launches of #16 per
              kernel-arm step and none on the plain arm or at eval; then
              timed steps per arm, in turns, over batches collected
              beforehand, and one loader-fed epoch; one pass of evaluate;
              the best .pth written by the loop's writer is read back by
              run_eval and by serve.load_from_checkpoint to the same
              accuracies and predictions;
  j. sa parity
              the fused self-attention kernels #10 (training forward),
              #11 (backward) and #13 (eval forward) against their plain
              versions at the two shapes the mmformer path gives them
              ([64, 196, 512] and [64, 392, 512], 8 heads), in float32
              and bfloat16, with no dropout, a mask read from memory and
              a mask drawn in the kernel: out, qkv and p; dqkv; the whole
              op's dx and dW; the bits the kernel drew must be the plain
              generator's. Kernel #12 (the training forward on a given
              qkv, the SA_FUSED_QKV = False path) on the qkv of the
              plain forward: out and p against its plain version and
              BIT-EQUAL to #10's and to a rerun, the keep mask it writes
              equal to the generator's. Kernel #14 (the dropout-mask
              generator) must be BIT-EQUAL to its plain version at the
              four mask shapes of a transformer block. Median times of
              kernel and plain (CUDA events), of
              F.scaled_dot_product_attention on the same q, k, v, of
              F.linear + SDPA on its split output (#13's work in two
              library calls), and of torch.rand + compare for the masks;
  k. mmformer the intermediate-fusion path at full width (mmformer_n on
              CREMA-D, fps 1, batch 64, width 64, embed 512, 8 heads,
              mlp 4096, 196 + 196 -> 392 tokens, shared unimodal
              streams, AUXI loss, SGD, clip 40; benchmarks/run_all.py
              bench_intermediate) through main_intermediate's
              build_model and build_harness, a Loader over a
              SyntheticDataset, train_one_epoch and evaluate: seeded
              weights go to two arms, the kernels and their plain
              versions, with identically seeded generators (so both draw
              the same dropout masks and PE noise), in float32 and under
              bf16 autocast; 1 + 3 checked steps whose losses, float32
              parameters and BatchNorm statistics are held to each
              other, with exactly 7 launches of #10, 7 of #11, 28 of #14
              and 2 of #16 per kernel-arm step and none on the plain
              arm; timed steps per arm, in turns; an eval pass with 7
              launches of #13 per batch and none of the others; the .pth
              written by the loop's writer is served back through
              serve.load_intermediate_from_checkpoint to the same
              predictions;
  l. flag parity
              the kernels of the Swin flag paths against their plain
              versions at the four Swin-B stage shapes of batch 32
              (shifted and unshifted), in float32 and bfloat16: #5 (the
              save-p forward on a qkv computed outside: out and p), the
              BWD_DELTA body of #4 (dqkv and dbias from given row sums;
              also against the default #4) and #3 (attention and
              projection backward: dx, dW, db and dbias; also against #4
              followed by the three GEMMs), and #15 (the fused MLP) at
              the four MLP shapes [Bw*49, C] -> 4C -> C; each bit-equal
              across two runs; median times of kernel and plain (CUDA
              events), of F.scaled_dot_product_attention on the same q,
              k, v with bias + mask as its mask (#5), of #4 + three
              torch.matmul (#3) and of F.linear -> F.gelu -> F.linear
              (#15); by a torch.profiler trace, #3's device time split
              into its three launches (attention into the dqkv
              workspace, dx, dW's K-split partials) and the partial sums,
              and #15's into its fc1 and fc2 launches; #3's runs, dW
              splits, partial bytes and dqkv round trip;
  m. flag train
              phase f's configuration, nothing cut, built through Config
              flags, serve.build_model and build_harness from one seed,
              in float32 and under bf16 autocast, three arms:
              A  --fuse_qkv_gemm 0 --fuse_mlp 1 with BWD_DELTA: per step
                 exactly 48 of #5, 48 of #4-delta and 48 of #15 (every
                 stage is inside mlp_kernel_supported), 0 of #2, #4, #3;
              B  the default flags with FUSED_PROJECTION_BACKWARD: 48 of
                 #2 and, by fused_bwd_supported, k = 48 of #3 and 48 - k
                 = 0 of #4; 0 of #5 and #15. (gdl_tpu sends stage 3,
                 C = 1024, to the split instead: its dW slab 3C^2 * 4 =
                 12.6 MB exceeds _DW_SLAB_FEASIBLE and the "auto" cap,
                 so it makes 44 of #3 and 4 of #4 a step; the port's #3
                 has no slab and both routes compute the same function);
              plain  attn_impl="plain": no launch.
              One eval pass per arm before any step (equal weights): arm
              A, whose qkv is not fused, runs the plain eval attention
              (0 of #1) and 48 of #15, arm B 48 of #1; logits held to
              each other.
              Then 1 warm-up + 3 checked steps per arm: losses and
              float32 parameters of A and B held to the plain arm; then
              6 timed steps per arm, in turns (median ms/step, clips/s,
              peak memory);
  n. variant parity
              the kernels that only an argument reaches, at the seven
              batch-32 Swin-B stage shapes, in float32 and bfloat16:
              #6 (window_attention_qkv with transposed=False: out and p,
              dqkv and dbias; also within 1e-6 in f32 of #5 and #4 on
              the same inputs, the same function), #7 (save_p=False: out
              bit-equal to #5's; the backward that computes p again,
              against its plain version and, in f32, against #4 at phase
              l's bars; in bf16 only its own plain version, whose p is
              unrounded in ds), #8 and #9 (q, k, v [B, H, N, D]: against
              window_attention_ref, bit-equal to each other and to #5);
              each bit-equal across two runs; median times of kernel,
              plain version and SDPA with bias + mask as a float mask
              (for #7's pair SDPA forward + backward through autograd).
              Then their path: the 48 attention sites of a dual Swin-B
              pass through window_attention_qkv (transposed=False, and
              save_p=False; forward and backward), window_attention_bhnd
              and window_attention(use_pallas=True), float32, with the
              launch counts reset just before and read just after:
              exactly 48 of each of the six kernels;
  o. mmformer switch
              phase k's training path under SA_FUSED_QKV = False (the
              qkv projection as nn.Linear, kernel #12 on its output):
              the switch's kernel arm, its plain arm and the default
              kernel arm from one seed, float32 and bf16 autocast; 1 + 3
              checked steps per arm, exactly 7 of #12, 7 of #11, 28 of
              #14, 2 of #16 and none of #10 per kernel-arm step; losses,
              float32 parameters and BN statistics against the plain arm
              at phase k's bars; the same attention seed words as the
              default arm and losses within its bars of the default
              arm's; timed steps of the switch and default arms in turns;
  g. kernels  one line per kernel: route, source, the TPU kernel it
              replaces, launches on its path (d for #1, the kernel arm
              of f for #2 and #4, of i for #16, of k for #10, #11, #13
              and #14, arm A of m for #5, #4-delta and #15, arm B of m
              for #3 (with its stages and dqkv's round trip in bytes
              beside the bound), n's path for #6, #7, #8 and #9 (#6 and #7 a
              forward and a backward entry each), the switch's kernel
              arm of o for #12), error, times, the roofline bound of the same
              work (bytes moved once over 3.35 TB/s against operations
              over the float32 peak of 67 TFLOP/s; the times are the
              float32 ones) and, where one PyTorch call computes the
              function, that call's time; beside #1 and #2, F.linear +
              SDPA and the qkv traffic between their two launches.
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


POOL = "max_pool_3x3_s2_bwd"
RESNET_BATCH = 64
RESNET_WIDTH = 64  # ResNet-18's own stem width, stages [2, 2, 2, 2]
# stem activations [B, H, W, C] reaching the pool at batch 64, width 64:
# visual 224² frames and audio 257×188 spectrograms after the 7×7/2 conv
POOL_SHAPES = {"visual": (RESNET_BATCH, 112, 112, 64),
               "audio": (RESNET_BATCH, 129, 94, 64)}
RESNET_CHECKED_STEPS = 3  # the first includes cuDNN's autotuning
RESNET_TIMED_STEPS = 6    # per timed call
RESNET_TIME_ROUNDS = 8    # timed calls per arm, in turns
# ResNet path, kernel arm vs plain arm, checked under cuDNN's
# deterministic algorithms. The two backward passes are bit-equal
# (phase h), so the arms should agree far inside these tolerances.
RESNET_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
RESNET_PARAM_ATOL = 1e-4  # float32 parameters after the checked steps
RESNET_STAT_ATOL = {"float32": 1e-4, "bfloat16": 2e-2}  # BN running stats

SA_FWD = "self_attention_fused_fwd"
SA_BWD = "self_attention_fused_bwd"
SA_EVAL = "self_attention_fused_eval"
SA_QKV_FWD = "self_attention_qkv_fwd"  # 12
MASK = "prng_dropout_mask"
MM_BATCH = 64
MM_HEADS = 8
MM_RATE = 0.1  # the transformer blocks' dropout and attention-dropout rate
# x [B, N, C] of the attention calls of one mmformer_n step with shared
# streams, and how many calls a step makes at each (4 intra, 3 inter)
SA_SHAPES = {"intra": (MM_BATCH, 196, 512), "inter": (MM_BATCH, 392, 512)}
SA_CALLS = {"intra": 4, "inter": 3}
# the dropout masks of one step: per block three of [B*N, 512] (after
# proj, after the attention branch, after fc2) and one of [B*N, 4096]
MASK_CALLS = {(12544, 512): 12, (12544, 4096): 4, (25088, 512): 9,
              (25088, 4096): 3}
SA_REPS = 10        # timed launches per kernel and shape
SA_PLAIN_REPS = 3   # the plain versions are slow and only a cross-check
MM_CHECKED_STEPS = 4  # 1 + 3; the first includes cuDNN's autotuning
MM_TIMED_STEPS = 3    # per timed call
MM_TIME_ROUNDS = 4    # timed calls per arm, in turns
MM_EVAL_BATCHES = 2
MM_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
MM_PARAM_ATOL = 1e-4
MM_STAT_ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
# launches of one kernel-arm training step and of one eval forward
MM_STEP_LAUNCHES = {SA_FWD: 7, SA_BWD: 7, MASK: 28, POOL: 2}
MM_EVAL_LAUNCHES = {SA_EVAL: 7}
# ... and of one step under SA_FUSED_QKV = False: #12 in place of #10
MM_SWITCH_LAUNCHES = {SA_QKV_FWD: 7, SA_BWD: 7, MASK: 28, POOL: 2}

QKV_SAVEP = "window_attention_qkv_savep"             # 5
BWD_DELTA_K = "window_attention_qkv_fused_bwd_delta"   # 4, BWD_DELTA body
BWD_FUSED = "window_attention_qkv_fused_bwd_fused"     # 3
MLP = "mlp_fused"                                      # 15
QKV_SAVEP_ROWS = "window_attention_qkv_savep_rows"    # 6, forward
BWD_ROWS = "window_attention_qkv_bwd_rows"             # 6, backward
QKV_FWD = "window_attention_qkv_fwd"                   # 7, forward
BWD_RECOMPUTE = "window_attention_qkv_bwd_recompute"   # 7, backward
BHND = "window_attention_bhnd"                         # 8
PACKED = "window_attention_packed"                     # 9
VARIANT_KERNELS = (QKV_SAVEP_ROWS, BWD_ROWS, QKV_FWD, BWD_RECOMPUTE, BHND,
                   PACKED)
FLAG_STEPS = 3        # checked steps per arm after one warm-up step
FLAG_TIME_ROUNDS = 6  # timed steps per arm, in turns

# NVIDIA H100 SXM data-sheet peaks (dense), for the roofline bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


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

    from gdl_tpu_torch.bench_wa_fwd import linear_sdpa
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
                    am = attn_mask(bias_t, mask, bw, dt)
                    lib_ms = cuda_ms(lambda: linear_sdpa(xs, ws, bs, am,
                                                         heads))
                    del am
                row = {"phase": "parity", "kernel": KERNEL, "stage": stage,
                       "Bw": bw, "C": c, "H": heads, "N": n,
                       "mask": mask is not None, "dtype": dtype,
                       "max_abs_err": float(err.max()), **tol, "ok": ok,
                       "ms": ms, "plain_ms": plain_ms,
                       "linear_sdpa_ms": lib_ms}
                emit(row)
                results.append(row)
                if not ok:
                    failures.append(f"parity stage {stage} {dtype} "
                                    f"mask={mask is not None}")
    return results


def attn_mask(bias, mask, bw: int, dt):
    """bias [H, N, N] + mask[i % nW] of window i, as SDPA's additive mask
    [Bw, H, N, N] in dt."""
    am = bias[None]
    if mask is not None:
        am = (am + mask[:, None]).repeat(bw // mask.shape[0], 1, 1, 1)
    return am.expand(bw, *bias.shape).to(dt).contiguous()


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


def attention_cost(kind: str, bw: int, c: int, heads: int, masked: bool,
                   res: int, itemsize: int):
    """(bytes, operations) of one launch of an attention kernel: every
    input read once, every output written once; 2 operations per
    multiply-add of the products, 5 per softmax element.
    kind: 'eval' (#1), 'savep' (#2), 'bwd' (#4, #6's backward),
    'bwd_delta' (#4 with the row sums given), 'bwd_fused' (#3),
    'qkv_savep' (#5, #6's forward), 'attn_fwd' (#7's forward, #8, #9) or
    'bwd_recompute' (#7's backward)."""
    n = 49
    tokens, scores = bw * n * c, bw * heads * n * n
    small = heads * n * n * 4  # the bias, or dbias, in float32
    nw = (res // 7) ** 2 if masked else 0
    if kind == "attn_fwd":  # q, k, v (or qkv), bias, mask in; out out
        return ((4 * tokens) * itemsize + small + nw * n * n * 4,
                4 * bw * n * n * c + 5 * scores)
    if kind == "bwd_recompute":
        # qkv, dout, bias, mask in; dqkv, dbias out; the scores again and
        # the 4 backward products
        return ((3 * tokens + tokens + 3 * tokens) * itemsize + 2 * small
                + nw * n * n * 4, 10 * bw * n * n * c + 11 * scores)
    if kind in ("bwd", "bwd_delta"):
        # qkv, p, dout (and delta, f32) in; dqkv, dbias out; 4 products
        delta = bw * heads * n * 4 if kind == "bwd_delta" else 0
        return ((3 * tokens + scores + tokens + 3 * tokens) * itemsize
                + small + delta, 8 * bw * n * n * c + 6 * scores)
    if kind == "bwd_fused":
        # qkv, p, dout, x, W in; dx, dW, db, dbias out; the 4 attention
        # products and the 2 projection products (bench_wa_bwd.cost)
        from gdl_tpu_torch.bench_wa_bwd import cost

        return cost(bw, c, heads, itemsize)[:2]
    if kind == "qkv_savep":  # qkv, bias, mask in; out, p out; 2 products
        return ((4 * tokens + scores) * itemsize + small + nw * n * n * 4,
                4 * bw * n * n * c + 5 * scores)
    nbytes = ((2 * tokens + 3 * c * c + 3 * c) * itemsize + small
              + nw * n * n * 4)
    if kind == "savep":
        nbytes += (3 * tokens + scores) * itemsize
    return nbytes, 2 * bw * n * c * 3 * c + 4 * bw * n * n * c + 5 * scores


def bound_ms(nbytes: float, ops: float, dtype: str = "float32"):
    """The least time the card could take → (ms, 'bytes' | 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def per_pass_bound(kind: str, batch: int, dtype: str = "float32") -> dict:
    """The bound of one request or training step (both encoders, all 48
    launches), each launch's bound summed as per_pass_ms sums the times."""
    itemsize = 4 if dtype == "float32" else 2
    total = {"ms": 0.0, "bytes": 0.0, "operations": 0.0,
             "by": {"bytes": 0, "operations": 0}}
    for (stage, bw16, c, heads, res), depth in zip(STAGES, DEPTHS):
        for i in range(depth):
            nbytes, ops = attention_cost(kind, bw16 * batch // BATCH, c,
                                         heads, i % 2 == 1 and res > 7, res,
                                         itemsize)
            ms, by = bound_ms(nbytes, ops, dtype)
            total["ms"] += 2 * ms
            total["bytes"] += 2 * nbytes
            total["operations"] += 2 * ops
            total["by"][by] += 2
    return total


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

    from gdl_tpu_torch.bench_wa_fwd import linear_sdpa
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
                    am = attn_mask(bias_t, mask, bw, dt)
                    times["fwd_linear_sdpa_ms"] = cuda_ms(
                        lambda: linear_sdpa(*args, am, heads))
                    del am
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


def other_arms_bytes(model) -> int:
    """Device memory held when an arm's steps begin, less the arm's own
    parameters: what earlier arms keep (parameters, gradients, momentum).
    max_memory_allocated counts it into every later arm's peak."""
    import torch

    own = sum(p.numel() * p.element_size() for p in model.parameters())
    return torch.cuda.memory_allocated() - own


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
        others = other_arms_bytes(model)
        runs = [drive(step, batch, dtype) for batch in batches]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return dict(model=model, step=step, peak=peak,
                    peak_over_start=peak - others / 2 ** 30,
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
                  "peak_mem_over_arm_start_gib": arm["peak_over_start"],
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


def _bit_equal(a, b) -> bool:
    import torch

    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return bool(torch.equal(a.view(view), b.view(view)))


def phase_maxpool_parity(failures):
    """Kernel #16 against its plain version (bit-equal) and against the
    library's max-pool backward, at the two stem shapes."""
    import torch

    from gdl_tpu_torch.bench_common import run_ms
    from gdl_tpu_torch.ops.maxpool import max_pool_3x3_s2_bwd

    dev = torch.device("cuda")
    aten = torch.ops.aten
    pool_args = ([3, 3], [2, 2], [1, 1], [1, 1], False)
    results = []
    for stem, shape in POOL_SHAPES.items():
        b, h, w, c = shape
        gshape = (b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c)
        gen = torch.Generator(device=dev).manual_seed(
            600 + len(results))
        x32 = torch.relu(torch.randn(shape, generator=gen, device=dev))
        g32 = torch.randn(gshape, generator=gen, device=dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            g = g32.to(dt)
            for kind in ("relu", "equal"):
                x = (x32.to(dt) if kind == "relu"
                     else torch.full(shape, 0.5, dtype=dt, device=dev))
                with torch.no_grad():
                    got = max_pool_3x3_s2_bwd(x, g)
                    again = max_pool_3x3_s2_bwd(x, g)
                    want = max_pool_3x3_s2_bwd(x, g, impl="plain")
                    # the library call, on NCHW views of the same memory
                    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
                    _, idx = aten.max_pool2d_with_indices(xn, *pool_args)
                    lib = aten.max_pool2d_with_indices_backward(
                        gn, xn, *pool_args, idx).permute(0, 2, 3, 1)
                    # Σ|g| over the cotangents that meet in each element
                    mag = max_pool_3x3_s2_bwd(x, g.abs()).float()
                    torch.cuda.synchronize()
                    eps = torch.finfo(dt).eps
                    lib_err = (got.float() - lib.float()).abs()
                    checks = {
                        "bit_equal_plain": _bit_equal(got, want),
                        "bit_equal_rerun": _bit_equal(got, again),
                        "library_within_4eps": bool(
                            (lib_err <= 4 * eps * mag).all()),
                        "finite": _finite(got),
                        "mass": bool(torch.isclose(
                            got.double().sum(), g.double().sum(),
                            rtol=1e-2 if dtype == "bfloat16" else 1e-5,
                            atol=1.0)),
                    }
                    row = {"phase": "maxpool_parity", "kernel": POOL,
                           "stem": stem, "x": list(shape), "dtype": dtype,
                           "input": kind,
                           "max_abs_err": _max_err(got, want),
                           "max_abs_err_vs_library": float(lib_err.max()),
                           **checks}
                    if kind == "relu":
                        row["ms"] = cuda_ms(
                            lambda: max_pool_3x3_s2_bwd(x, g))
                        row["run_ms"] = run_ms(
                            lambda: max_pool_3x3_s2_bwd(x, g))
                        row["plain_ms"] = cuda_ms(
                            lambda: max_pool_3x3_s2_bwd(x, g, impl="plain"),
                            reps=5, warmup=1)
                        row["library_ms"] = cuda_ms(
                            lambda: aten.max_pool2d_with_indices_backward(
                                gn, xn, *pool_args, idx))
                        nbytes, ops = pool_cost(shape, x.element_size())
                        row["bytes"], row["operations"] = nbytes, ops
                        row["bound_ms"], row["bound_by"] = bound_ms(
                            nbytes, ops, dtype)
                    del got, again, want, lib, mag, lib_err, idx
                row["ok"] = all(checks.values())
                emit(row)
                results.append(row)
                if not row["ok"]:
                    failures.append(f"maxpool parity {stem} {dtype} {kind}: "
                                    f"{checks}")
        del x32, g32
        torch.cuda.empty_cache()
    return results


def phase_resnet(failures, smi: str):
    """The flagship ResNet-18 DGL training path through the port's loop,
    kernel arm and plain arm. Returns the kernel arms' launch count of
    #16 over the checked steps."""
    import contextlib

    import torch

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.config import Config
    from gdl_tpu_torch.data.loader import Loader
    from gdl_tpu_torch.data.synthetic import SyntheticDataset
    from gdl_tpu_torch.serve import build_model, load_from_checkpoint
    from gdl_tpu_torch.train.loop import (
        build_harness,
        evaluate,
        run_eval,
        train_one_epoch,
    )
    from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint

    def quiet():  # the loop prints the reference's progress lines
        return contextlib.redirect_stdout(sys.stderr)

    total_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        def config(dtype):
            return Config(dataset="CREMAD", fusion_method="concat",
                          modality="full", fps=1, batch_size=RESNET_BATCH,
                          learning_rate=2e-3, alpha=5.0, modulation="Normal",
                          log_grad_csv=False, compute_dtype=dtype,
                          num_workers=8, ckpt_path=tmp,
                          encoder_width=RESNET_WIDTH)

        cfg0 = config("float32")
        train_set = SyntheticDataset(
            cfg0, size=RESNET_BATCH * RESNET_CHECKED_STEPS, seed=500)
        # a sample is drawn from seed + index: the three sets share none
        test_set = SyntheticDataset(cfg0, size=2 * RESNET_BATCH, seed=9000)
        timed_set = SyntheticDataset(
            cfg0, size=RESNET_BATCH * RESNET_TIMED_STEPS, seed=2000)

        def loader(ds, shuffle, workers=8):
            return Loader(ds, RESNET_BATCH, shuffle=shuffle, drop_last=True,
                          num_workers=workers, seed=cfg0.random_seed)

        t0 = time.perf_counter()
        timed_batches = list(loader(timed_set, False))
        host_ms_per_batch = ((time.perf_counter() - t0) * 1e3
                             / len(timed_batches))

        def run_arm(impl, dtype):
            cfg = config(dtype)
            model = build_model(cfg, attn_impl=impl, seed=777)
            h = build_harness(cfg, model, steps_per_epoch=100)
            steps = []
            inner = h.train_step

            def recording(batch):
                before = dict(kernels.launch_counts)
                m = inner(batch)
                steps.append((m, {k: v - before[k] for k, v in
                                  kernels.launch_counts.items()}))
                return m

            h.train_step = recording
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            # the checked steps ask cuDNN for its deterministic algorithms:
            # its default float32 weight-gradient kernels sum with atomics,
            # and a last-bit difference in a stem weight flips first-maximum
            # choices in the pool and ReLU, so two runs of ONE arm drift
            # apart as far as the two arms do. The timed steps run with the
            # default setting.
            torch.backends.cudnn.deterministic = True
            try:
                with quiet():
                    train_one_epoch(h, loader(train_set, True), 0)
                torch.cuda.synchronize()
            finally:
                torch.backends.cudnn.deterministic = False
            launched = dict(kernels.launch_counts)
            return dict(cfg=cfg, h=h, launched=launched,
                        peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                        metrics=[{k: float(v) for k, v in m.items()}
                                 for m, _ in steps],
                        launches=[c for _, c in steps])

        def timed_call(arm, batches):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with quiet():
                train_one_epoch(arm["h"], batches, 1)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3 / len(timed_batches)

        for dtype in ("float32", "bfloat16"):
            order = ("plain", "auto") if dtype == "float32" else ("auto",
                                                                  "plain")
            arms = {impl: run_arm(impl, dtype) for impl in order}
            ka, pa = arms["auto"], arms["plain"]
            problems = []
            # launches: exactly 2 of #16 per kernel-arm step, nothing else
            want = {k: 0 for k in kernels.launch_counts}
            for i, (lk, lp) in enumerate(zip(ka["launches"],
                                             pa["launches"])):
                if lk != dict(want, **{POOL: 2}):
                    problems.append(f"step {i}: kernel arm launches {lk}")
                if lp != want:
                    problems.append(f"step {i}: plain arm launches {lp}")
            if len(ka["launches"]) != RESNET_CHECKED_STEPS:
                problems.append(f"{len(ka['launches'])} steps ran")
            total_launches += ka["launched"][POOL]
            worst_rel = 0.0
            for i, (mk, mp) in enumerate(zip(ka["metrics"], pa["metrics"])):
                for key in ("loss", "loss_a", "loss_v", "loss_f",
                            "grad_norm"):
                    a, b = mk[key], mp[key]
                    if not (math.isfinite(a) and math.isfinite(b)):
                        problems.append(f"step {i}: {key} not finite")
                        continue
                    worst_rel = max(worst_rel,
                                    abs(a - b) / max(abs(b), 1e-12))
            if worst_rel > RESNET_LOSS_RTOL[dtype]:
                problems.append(f"losses differ by {worst_rel} relative")
            km, pm = ka["h"].model, pa["h"].model
            with torch.no_grad():
                param_err = max(float((a - b).abs().max()) for a, b in
                                zip(km.parameters(), pm.parameters()))
                stat_err = max(float((a - b).abs().max()) for (n, a), (_, b)
                               in zip(km.named_buffers(), pm.named_buffers())
                               if "running" in n)
                tracked = {int(b) for n, b in km.named_buffers()
                           if n.endswith("num_batches_tracked")}
            if dtype == "float32" and param_err > RESNET_PARAM_ATOL:
                problems.append(f"parameters differ by {param_err}")
            if stat_err > RESNET_STAT_ATOL[dtype]:
                problems.append(f"BN running stats differ by {stat_err}")
            if tracked != {RESNET_CHECKED_STEPS}:
                problems.append(f"BN updates per step: {tracked}")

            # timing over batches collected beforehand, arms in turns
            timed = {impl: [] for impl in arms}
            for impl in order:  # untimed: cuDNN's default algorithms
                timed_call(arms[impl], timed_batches)
            for r in range(RESNET_TIME_ROUNDS):
                for impl in (order if r % 2 == 0 else order[::-1]):
                    timed[impl].append(timed_call(arms[impl], timed_batches))
            # and one epoch fed by the Loader (host decode in the loop)
            fed = {impl: timed_call(arms[impl], loader(timed_set, False))
                   for impl in order}

            # eval: no launches; then the .pth round trip
            kernels.reset_launch_counts()
            with quiet():
                accs = evaluate(ka["h"], loader(test_set, False))
            if any(kernels.launch_counts.values()):
                problems.append(f"eval launched {kernels.launch_counts}")
            if not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
                problems.append(f"accuracies {accs}")
            path = save_best_checkpoint(ka["cfg"], km, 1, accs[0])
            with quiet():
                accs2 = run_eval(ka["cfg"], build_model(ka["cfg"], seed=1),
                                 test_set, path)
            if tuple(accs2) != tuple(accs):
                problems.append(f"run_eval from the .pth: {accs2} != {accs}")
            served = load_from_checkpoint(ka["cfg"], path, "cuda")
            batch = next(iter(loader(test_set, False)))
            mine = ka["h"].eval_step(batch)
            theirs = served.eval_batch(batch)
            for k in ("pred", "pred_a", "pred_v"):
                if not torch.equal(mine[k], theirs[k]):
                    problems.append(f"served {k} differs from the loop's")
            if tuple(mine["logits"][0].shape) != (RESNET_BATCH, 6):
                problems.append("bad logits shape")
            os.remove(path)

            n_params = sum(p.numel() for p in km.parameters())
            for impl in order:
                arm, ms = arms[impl], sorted(timed[impl])
                med = ms[len(ms) // 2]
                emit({"phase": "resnet", "dtype": dtype,
                      "arm": "kernel" if impl == "auto" else "plain",
                      "batch": RESNET_BATCH, "ms_per_step": med,
                      "clips_per_s": RESNET_BATCH / med * 1e3,
                      "timed_call_ms_per_step": timed[impl],
                      "loader_fed_ms_per_step": fed[impl],
                      "loader_fed_clips_per_s":
                          RESNET_BATCH / fed[impl] * 1e3,
                      "host_ms_per_batch_alone": host_ms_per_batch,
                      "peak_mem_gib": arm["peak"],
                      "loss": [m["loss"] for m in arm["metrics"]],
                      "grad_norm": [m["grad_norm"] for m in arm["metrics"]],
                      "params": n_params, "nvidia_smi": smi})
            ok = not problems
            emit({"phase": "resnet_check", "dtype": dtype,
                  "max_rel_loss_diff": worst_rel,
                  "loss_rtol": RESNET_LOSS_RTOL[dtype],
                  "max_abs_param_diff": param_err,
                  "param_atol": (RESNET_PARAM_ATOL if dtype == "float32"
                                 else None),
                  "max_abs_bn_stat_diff": stat_err,
                  "bn_stat_atol": RESNET_STAT_ATOL[dtype],
                  "launches_per_step": 2, "eval_acc": list(accs),
                  "problems": problems, "ok": ok})
            failures.extend(f"resnet {dtype}: {p}" for p in problems)
            del arms, ka, pa, km, pm, served
            torch.cuda.empty_cache()
    return total_launches


def sa_cost(kind: str, b: int, n: int, c: int, heads: int, itemsize: int):
    """(bytes, operations) of one launch of a self-attention kernel:
    every input read once, every output written once (the qkv scratch of
    the eval kernel and the ds scratch of the backward are the kernels'
    own and do not count; a mask drawn in the kernel moves 8 bytes of
    seed); 2 operations per multiply-add of the products, 5 per softmax
    element (6 in the backward). kind: 'fwd' (#10), 'bwd' (#11),
    'qkv_fwd' (#12) or 'eval' (#13)."""
    tokens, scores = b * n * c, b * heads * n * n
    if kind == "bwd":  # qkv, p, dout in; dqkv out; 4 products
        return ((3 * tokens + scores + tokens + 3 * tokens) * itemsize,
                8 * b * n * n * c + 6 * scores)
    if kind == "qkv_fwd":  # qkv in; out and p out; 2 products
        return ((4 * tokens + scores) * itemsize + 8,
                4 * b * n * n * c + 5 * scores)
    nbytes = (2 * tokens + 3 * c * c) * itemsize  # x, w in; out
    if kind == "fwd":  # plus the qkv and p residuals
        nbytes += (3 * tokens + scores) * itemsize
    return nbytes, 2 * b * n * c * 3 * c + 4 * b * n * n * c + 5 * scores


def pool_cost(shape, itemsize: int):
    """(bytes, operations) of one backward of the 3x3 / 2 max pool on x
    [B, H, W, C]: x read once, the cotangent g [B, ho, wo, C] read once,
    dx written once; 9 compares and an add a cotangent."""
    b, h, w, c = shape
    g = b * ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1) * c
    return (2 * b * h * w * c + g) * itemsize, 10 * g


def mask_cost(numel: int, itemsize: int):
    """(bytes, operations) of one dropout mask: nothing read but two
    seed words, every element written once; per group of four elements
    Philox4x32-10 does 10 rounds of 2 wide multiplies (a low and a high
    half each), 3 xors and 2 key additions, then 4 compares and selects:
    98 integer operations, counted against the float32 rate (the table
    of peaks has no integer one)."""
    return numel * itemsize + 8, 98 * ((numel + 3) // 4)


def phase_sa_parity(failures):
    """Kernels #10, #11, #13 and the op they make up against their plain
    versions at the mmformer shapes; kernel #14 bit-equal to its plain
    version. Returns (attention rows, mask rows)."""
    import torch
    import torch.nn.functional as F

    from gdl_tpu_torch.bench_common import run_ms
    from gdl_tpu_torch.ops.dropout import (
        fold_seed_words,
        keep_threshold,
        prng_dropout_mask,
    )
    from gdl_tpu_torch.ops.self_attention import (
        make_dropout,
        self_attention_fused,
        self_attention_fused_bwd,
        self_attention_fused_eval,
        self_attention_fused_fwd,
        self_attention_qkv_fwd,
    )

    dev = torch.device("cuda")
    rows, mask_rows = [], []
    for k, (site, (b, n, c)) in enumerate(SA_SHAPES.items()):
        gen = torch.Generator(device=dev).manual_seed(800 + k)
        x32 = torch.randn((b, n, c), generator=gen, device=dev)
        w32 = torch.randn((3 * c, c), generator=gen, device=dev) * c ** -0.5
        g32 = torch.randn((b, n, c), generator=gen, device=dev)
        words = fold_seed_words(gen, dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x, w, dout = x32.to(dt), w32.to(dt), g32.to(dt)
            for mode in ("none", "hbm", "kernel"):
                drop = make_dropout(x, MM_HEADS, MM_RATE, mode != "none",
                                    "hbm" if mode == "hbm" else "kernel",
                                    seed_words=words)
                errs, oks = {}, []
                with torch.no_grad():
                    got = self_attention_fused_fwd(
                        x, w, MM_HEADS, drop=drop, return_keep=True)
                    want = self_attention_fused_fwd(
                        x, w, MM_HEADS, drop=drop, impl="plain",
                        return_keep=True)
                    for name, a, r in zip(("out", "qkv", "p"), got, want):
                        errs[name] = _max_err(a, r)
                        oks.append(_fwd_ok(a, r, dtype))
                    keep_rate = None
                    if mode == "kernel":  # the bits the kernel drew
                        oks.append(bool(torch.equal(got[3], want[3])))
                        keep_rate = float(got[3].float().mean())
                        sigma = (MM_RATE * (1 - MM_RATE)
                                 / got[3].numel()) ** 0.5
                        oks.append(abs(keep_rate - (1 - MM_RATE))
                                   <= 5 * sigma)
                    _, qkv, p, _ = want
                    # #12 on the qkv #10 projected: #10's row tile without
                    # the projection, so #10's out, p and keep bits to the
                    # bit; with and without the keep mask written out
                    g12 = self_attention_qkv_fwd(got[1], MM_HEADS, drop=drop,
                                                 return_keep=True)
                    a12 = self_attention_qkv_fwd(got[1], MM_HEADS, drop=drop)
                    w12 = self_attention_qkv_fwd(got[1], MM_HEADS, drop=drop,
                                                 impl="plain",
                                                 return_keep=True)
                    for name, a, r in zip(("out", "p"), g12, w12):
                        errs["qkv_op_" + name] = _max_err(a, r)
                        oks.append(_fwd_ok(a, r, dtype))
                    same = [torch.equal(g12[0], a12[0]),
                            torch.equal(g12[1], a12[1]),
                            torch.equal(g12[0], got[0]),
                            torch.equal(g12[1], got[2])]
                    if mode == "kernel":
                        same += [torch.equal(g12[2], w12[2]),
                                 torch.equal(g12[2], got[3])]
                    qkv_op_same = all(same)
                    oks.append(qkv_op_same)
                    del got, want, g12, a12, w12
                    gb = self_attention_fused_bwd(qkv, p, dout, MM_HEADS,
                                                  drop=drop)
                    wb = self_attention_fused_bwd(qkv, p, dout, MM_HEADS,
                                                  drop=drop, impl="plain")
                    errs["dqkv"] = _max_err(gb, wb)
                    oks.append(_grad_ok(gb, wb, dtype))
                    del gb, wb
                grads = {}
                for impl in ("auto", "plain"):
                    xl = x.clone().requires_grad_(True)
                    wl = w.clone().requires_grad_(True)
                    out = self_attention_fused(
                        xl, wl, MM_HEADS, dropout_rate=MM_RATE,
                        seed_words=words, train=mode != "none",
                        dropout_impl="hbm" if mode == "hbm" else "kernel",
                        mask=drop.mask, impl=impl)
                    out.backward(dout)
                    grads[impl] = (xl.grad, wl.grad)
                    del out, xl, wl
                for name, a, r in zip(("op_dx", "op_dW"), grads["auto"],
                                      grads["plain"]):
                    errs[name] = _max_err(a, r)
                    oks.append(_grad_ok(a, r, dtype))
                del grads
                with torch.no_grad():
                    times = {
                        "fwd_ms": cuda_ms(lambda: self_attention_fused_fwd(
                            x, w, MM_HEADS, drop=drop), reps=SA_REPS),
                        "fwd_plain_ms": cuda_ms(
                            lambda: self_attention_fused_fwd(
                                x, w, MM_HEADS, drop=drop, impl="plain"),
                            reps=SA_PLAIN_REPS, warmup=1),
                        "bwd_ms": cuda_ms(lambda: self_attention_fused_bwd(
                            qkv, p, dout, MM_HEADS, drop=drop),
                            reps=SA_REPS),
                        "bwd_plain_ms": cuda_ms(
                            lambda: self_attention_fused_bwd(
                                qkv, p, dout, MM_HEADS, drop=drop,
                                impl="plain"),
                            reps=SA_PLAIN_REPS, warmup=1),
                        "qkv_fwd_ms": cuda_ms(lambda: self_attention_qkv_fwd(
                            qkv, MM_HEADS, drop=drop), reps=SA_REPS),
                        "qkv_fwd_plain_ms": cuda_ms(
                            lambda: self_attention_qkv_fwd(
                                qkv, MM_HEADS, drop=drop, impl="plain"),
                            reps=SA_PLAIN_REPS, warmup=1),
                    }
                    q, kk, v = (t.contiguous() for t in qkv.reshape(
                        b, n, 3, MM_HEADS, c // MM_HEADS).permute(
                            2, 0, 3, 1, 4))
                    if mode == "kernel":  # the library call with dropout
                        times["sdpa_dropout_ms"] = cuda_ms(
                            lambda: F.scaled_dot_product_attention(
                                q, kk, v, dropout_p=MM_RATE), reps=SA_REPS)
                    if mode == "none":  # the eval kernel, and the library
                        ge = self_attention_fused_eval(x, w, MM_HEADS)
                        we = self_attention_fused_eval(x, w, MM_HEADS,
                                                       impl="plain")
                        errs["eval_out"] = _max_err(ge, we)
                        oks.append(_fwd_ok(ge, we, dtype))
                        del ge, we
                        times["eval_ms"] = cuda_ms(
                            lambda: self_attention_fused_eval(x, w, MM_HEADS),
                            reps=SA_REPS)
                        times["eval_plain_ms"] = cuda_ms(
                            lambda: self_attention_fused_eval(
                                x, w, MM_HEADS, impl="plain"),
                            reps=SA_PLAIN_REPS, warmup=1)
                        times["sdpa_ms"] = cuda_ms(
                            lambda: F.scaled_dot_product_attention(q, kk, v),
                            reps=SA_REPS)

                        def linear_sdpa():  # #13's work in two library calls
                            q5 = F.linear(x, w).reshape(
                                b, n, 3, MM_HEADS, c // MM_HEADS).permute(
                                    2, 0, 3, 1, 4)
                            return F.scaled_dot_product_attention(
                                q5[0], q5[1], q5[2])

                        times["eval_linear_sdpa_ms"] = cuda_ms(
                            linear_sdpa, reps=SA_REPS)
                    del q, kk, v
                torch.cuda.synchronize()
                ok = all(oks)
                row = {"phase": "sa_parity",
                       "kernels": [SA_FWD, SA_BWD, SA_EVAL, SA_QKV_FWD],
                       "site": site,
                       "B": b, "N": n, "C": c, "H": MM_HEADS, "dtype": dtype,
                       "dropout": mode, "rate": MM_RATE if mode != "none"
                       else 0.0, "keep_rate": keep_rate,
                       "max_abs_err": errs, "fwd_tol": TRAIN_FWD_TOL[dtype],
                       "grad_frac_of_max": TRAIN_GRAD_FRAC[dtype],
                       "qkv_op_bit_equal_to_fused_and_rerun": qkv_op_same,
                       "ok": ok, **times}
                emit(row)
                rows.append(row)
                if not ok:
                    failures.append(f"sa parity {site} {dtype} {mode}: "
                                    f"{errs}")
                del qkv, p, drop
                torch.cuda.empty_cache()
        del x32, w32, g32

    keep = 1.0 - MM_RATE
    for k, shape in enumerate(MASK_CALLS):
        gen = torch.Generator(device=dev).manual_seed(900 + k)
        words = fold_seed_words(gen, dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            got = prng_dropout_mask(words, shape, MM_RATE, dt)
            want = prng_dropout_mask(words, shape, MM_RATE, dt, impl="plain")
            other = prng_dropout_mask(fold_seed_words(gen, dev), shape,
                                      MM_RATE, dt)
            kept = torch.tensor(1.0 / keep).to(dt)
            rate = float((got != 0).float().mean())
            sigma = (MM_RATE * keep / got.numel()) ** 0.5
            checks = {
                "bit_equal_plain": _bit_equal(got, want),
                "values": bool(((got == 0) | (got == kept.to(dev))).all()),
                "keep_rate_ok": abs(rate - keep) <= 5 * sigma,
                "other_seed_differs": not torch.equal(got, other),
            }
            err = _max_err(got, want)
            del want, other
            thresh = keep_threshold(MM_RATE) / 2.0 ** 32
            zero = torch.zeros((), dtype=dt, device=dev)

            def library():
                return torch.where(torch.rand(shape, device=dev) < thresh,
                                   kept.to(dev), zero)

            nbytes, ops = mask_cost(got.numel(), got.element_size())
            bound, by = bound_ms(nbytes, ops)
            row = {"phase": "mask_parity", "kernel": MASK,
                   "shape": list(shape), "dtype": dtype, "rate": MM_RATE,
                   "keep_rate": rate, "max_abs_err": err, **checks,
                   "ok": all(checks.values()),
                   "ms": cuda_ms(lambda: prng_dropout_mask(
                       words, shape, MM_RATE, dt), reps=SA_REPS),
                   "run_ms": run_ms(lambda: prng_dropout_mask(
                       words, shape, MM_RATE, dt)),
                   "plain_ms": cuda_ms(lambda: prng_dropout_mask(
                       words, shape, MM_RATE, dt, impl="plain"),
                       reps=SA_PLAIN_REPS, warmup=1),
                   "library_ms": cuda_ms(library, reps=SA_REPS),
                   "bytes": nbytes, "operations": ops, "bound_ms": bound,
                   "bound_by": by}
            emit(row)
            mask_rows.append(row)
            if not row["ok"]:
                failures.append(f"mask parity {shape} {dtype}: {checks}")
            del got
            torch.cuda.empty_cache()
    return rows, mask_rows


class MmRun:
    """Phase k's configuration (mmformer_n on CREMA-D, batch 64, width 64,
    shared streams) and its data, for the arms of phases k and o: seeded
    weights, identically seeded generators, batches collected before the
    timed calls."""

    def __init__(self, tmp):
        from gdl_tpu_torch.config import Config
        from gdl_tpu_torch.data.loader import Loader
        from gdl_tpu_torch.data.synthetic import SyntheticDataset

        self.tmp, self._config, self._loader = tmp, Config, Loader
        cfg0 = self.config("float32")
        self.train_set = SyntheticDataset(
            cfg0, size=MM_BATCH * MM_CHECKED_STEPS, seed=1500)
        test_set = SyntheticDataset(
            cfg0, size=MM_BATCH * MM_EVAL_BATCHES, seed=19000)
        timed_set = SyntheticDataset(
            cfg0, size=MM_BATCH * MM_TIMED_STEPS, seed=12000)
        self.seed = cfg0.random_seed
        self.timed_batches = list(self.loader(timed_set, False))
        self.test_batches = list(self.loader(test_set, False))

    def config(self, dtype):
        return self._config(dataset="CREMAD", fps=1, batch_size=MM_BATCH,
                            modulation="Normal", log_grad_csv=False,
                            compute_dtype=dtype, num_workers=8,
                            ckpt_path=self.tmp, encoder_width=RESNET_WIDTH)

    def loader(self, ds, shuffle):
        return self._loader(ds, MM_BATCH, shuffle=shuffle, drop_last=True,
                            num_workers=8, seed=self.seed)

    @staticmethod
    def switched(fused_qkv: bool):
        """models/transformer.py's SA_FUSED_QKV for the length of a call."""
        import contextlib

        from gdl_tpu_torch.models import transformer

        @contextlib.contextmanager
        def ctx():
            before = transformer.SA_FUSED_QKV
            transformer.SA_FUSED_QKV = fused_qkv
            try:
                yield
            finally:
                transformer.SA_FUSED_QKV = before
        return ctx()

    def run_arm(self, impl, dtype, fused_qkv=True, hook=None):
        """Build an arm through main_intermediate and take the checked
        steps (cuDNN's deterministic algorithms), recording each step's
        metrics and launch counts."""
        import torch

        from gdl_tpu_torch import kernels, main_intermediate
        from gdl_tpu_torch.train.loop import train_one_epoch

        cfg = self.config(dtype)
        model, kind = main_intermediate.build_model(
            "mmformer_n", cfg.n_classes, cfg.encoder_width,
            share_streams=True, impl=impl, seed=777)
        h = main_intermediate.build_harness(cfg, model, kind,
                                            steps_per_epoch=100)
        steps = []
        inner = h.train_step

        def recording(batch):
            before = dict(kernels.launch_counts)
            m = inner(batch)
            steps.append((m, {k: v - before[k] for k, v in
                              kernels.launch_counts.items()}))
            return m

        h.train_step = recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        # cuDNN's deterministic algorithms for the checked steps, as in
        # the ResNet phase; the timed steps run with the default
        torch.backends.cudnn.deterministic = True
        try:
            with quiet(), self.switched(fused_qkv):
                train_one_epoch(h, self.loader(self.train_set, True), 0)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        h.train_step = inner
        launched = dict(kernels.launch_counts)
        return dict(cfg=cfg, h=h, kind=kind, launched=launched,
                    fused_qkv=fused_qkv,
                    peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                    metrics=[{k: float(v) for k, v in m.items()}
                             for m, _ in steps],
                    launches=[c for _, c in steps])

    def timed_call(self, arm):
        import torch

        from gdl_tpu_torch.train.loop import train_one_epoch

        torch.cuda.synchronize()
        t = time.perf_counter()
        with quiet(), self.switched(arm["fused_qkv"]):
            train_one_epoch(arm["h"], self.timed_batches, 1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / len(self.timed_batches)

    @staticmethod
    def compare(ka, pa, dtype, problems, keys=("loss", "loss_a", "loss_v",
                                                "loss_f", "grad_norm")):
        """Worst relative metric difference of two arms' checked steps,
        their largest parameter and BN-statistic differences."""
        import torch

        worst_rel = 0.0
        for i, (mk, mp) in enumerate(zip(ka["metrics"], pa["metrics"])):
            for key in keys:
                a, b = mk[key], mp[key]
                if not (math.isfinite(a) and math.isfinite(b)):
                    problems.append(f"step {i}: {key} not finite")
                    continue
                worst_rel = max(worst_rel, abs(a - b) / max(abs(b), 1e-12))
        km, pm = ka["h"].model, pa["h"].model
        with torch.no_grad():
            param_err = max(float((a - b).abs().max()) for a, b in
                            zip(km.parameters(), pm.parameters()))
            stat_err = max(float((a - b).abs().max()) for (n, a), (_, b)
                           in zip(km.named_buffers(), pm.named_buffers())
                           if "running" in n)
        return worst_rel, param_err, stat_err

    @staticmethod
    def check_launches(ka, pa, want, zero, problems):
        for i, (lk, lp) in enumerate(zip(ka["launches"], pa["launches"])):
            if lk != want:
                problems.append(f"step {i}: kernel arm launches {lk}")
            if lp != zero:
                problems.append(f"step {i}: plain arm launches {lp}")
        if len(ka["launches"]) != MM_CHECKED_STEPS:
            problems.append(f"{len(ka['launches'])} steps ran")


def quiet():  # the loop prints the reference's progress lines
    import contextlib

    return contextlib.redirect_stdout(sys.stderr)


def phase_mmformer(failures, smi: str):
    """The mmformer_n training and eval path through main_intermediate's
    functions, kernel arm and plain arm. Returns the kernel arms' launch
    counts over the checked steps and over the eval pass."""
    import torch

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.serve import load_intermediate_from_checkpoint
    from gdl_tpu_torch.train.loop import evaluate
    from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint

    zero = {k: 0 for k in kernels.launch_counts}
    totals = {"train": dict(zero), "eval": dict(zero)}
    with tempfile.TemporaryDirectory() as tmp:
        run = MmRun(tmp)
        test_batches = run.test_batches
        for dtype in ("float32", "bfloat16"):
            order = ("plain", "auto") if dtype == "float32" else ("auto",
                                                                  "plain")
            arms = {impl: run.run_arm(impl, dtype) for impl in order}
            ka, pa = arms["auto"], arms["plain"]
            problems = []
            run.check_launches(ka, pa, dict(zero, **MM_STEP_LAUNCHES), zero,
                               problems)
            for k, v in ka["launched"].items():
                totals["train"][k] += v
            worst_rel, param_err, stat_err = run.compare(ka, pa, dtype,
                                                         problems)
            if worst_rel > MM_LOSS_RTOL[dtype]:
                problems.append(f"losses differ by {worst_rel} relative")
            km = ka["h"].model
            tracked = {n: int(b) for n, b in km.named_buffers()
                       if n.endswith("num_batches_tracked")}
            if dtype == "float32" and param_err > MM_PARAM_ATOL:
                problems.append(f"parameters differ by {param_err}")
            if stat_err > MM_STAT_ATOL[dtype]:
                problems.append(f"BN running stats differ by {stat_err}")
            # with shared streams a token-projection BatchNorm runs twice
            # a step (live input, zero input), every other one once
            for n, count in tracked.items():
                per_step = 2 if n.startswith("project") else 1
                if count != per_step * MM_CHECKED_STEPS:
                    problems.append(f"{n} = {count}")

            timed = {impl: [] for impl in arms}
            for impl in order:  # untimed: cuDNN's default algorithms
                run.timed_call(arms[impl])
            for r in range(MM_TIME_ROUNDS):
                for impl in (order if r % 2 == 0 else order[::-1]):
                    timed[impl].append(run.timed_call(arms[impl]))

            # eval: 7 launches of #13 per batch, nothing else
            evals = {}
            for impl in order:
                h = arms[impl]["h"]
                with quiet():
                    evaluate(h, test_batches)  # warm-up
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                with quiet():
                    accs = evaluate(h, test_batches)
                torch.cuda.synchronize()
                evals[impl] = dict(
                    accs=accs, launches=dict(kernels.launch_counts),
                    ms=(time.perf_counter() - t) * 1e3 / len(test_batches))
            want_eval = {k: v * MM_EVAL_BATCHES for k, v in
                         dict(zero, **MM_EVAL_LAUNCHES).items()}
            if evals["auto"]["launches"] != want_eval:
                problems.append(f"eval launched {evals['auto']['launches']}")
            if evals["plain"]["launches"] != zero:
                problems.append(f"plain eval launched "
                                f"{evals['plain']['launches']}")
            for k, v in evals["auto"]["launches"].items():
                totals["eval"][k] += v
            accs = evals["auto"]["accs"]
            if not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
                problems.append(f"accuracies {accs}")

            # the .pth round trip through the server
            path = save_best_checkpoint(ka["cfg"], km, 1, accs[0])
            served = load_intermediate_from_checkpoint(
                ka["cfg"], "mmformer_n", path, "cuda", share_streams=True)
            mine = ka["h"].eval_step(
                {k: torch.as_tensor(v).to("cuda")
                 for k, v in test_batches[0].items()})
            theirs = served.eval_batch(test_batches[0])
            for k in ("pred", "pred_a", "pred_v"):
                if not torch.equal(mine[k], theirs[k]):
                    problems.append(f"served {k} differs from the loop's")
            logits = theirs["logits"][0]
            if tuple(logits.shape) != (MM_BATCH, 6) or not _finite(logits):
                problems.append("bad served logits")
            os.remove(path)

            n_params = sum(p.numel() for p in km.parameters())
            for impl in order:
                arm, ms = arms[impl], sorted(timed[impl])
                med = ms[len(ms) // 2]
                emit({"phase": "mmformer", "dtype": dtype,
                      "arm": "kernel" if impl == "auto" else "plain",
                      "batch": MM_BATCH, "ms_per_step": med,
                      "clips_per_s": MM_BATCH / med * 1e3,
                      "timed_call_ms_per_step": timed[impl],
                      "eval_ms_per_batch": evals[impl]["ms"],
                      "eval_clips_per_s":
                          MM_BATCH / evals[impl]["ms"] * 1e3,
                      "peak_mem_gib": arm["peak"],
                      "loss": [m["loss"] for m in arm["metrics"]],
                      "grad_norm": [m["grad_norm"] for m in arm["metrics"]],
                      "params": n_params, "nvidia_smi": smi})
            ok = not problems
            emit({"phase": "mmformer_check", "dtype": dtype,
                  "max_rel_loss_diff": worst_rel,
                  "loss_rtol": MM_LOSS_RTOL[dtype],
                  "max_abs_param_diff": param_err,
                  "param_atol": (MM_PARAM_ATOL if dtype == "float32"
                                 else None),
                  "max_abs_bn_stat_diff": stat_err,
                  "bn_stat_atol": MM_STAT_ATOL[dtype],
                  "launches_per_step": MM_STEP_LAUNCHES,
                  "launches_per_eval_batch": MM_EVAL_LAUNCHES,
                  "eval_acc": list(accs), "problems": problems, "ok": ok})
            failures.extend(f"mmformer {dtype}: {p}" for p in problems)
            del arms, ka, pa, km, served, mine, theirs
            torch.cuda.empty_cache()
    return totals


def phase_mmformer_switch(failures, smi: str):
    """Phase k's training path under SA_FUSED_QKV = False: the qkv
    projection is nn.Linear (cuBLAS) and the attention kernel #12 on its
    output. Three arms from one seed: the switch's kernel arm, its plain
    arm and the default kernel arm (switch True), each with identically
    seeded generators. Returns the switch's kernel arm's launch counts over
    its checked steps."""
    import torch

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.models import transformer

    zero = {k: 0 for k in kernels.launch_counts}
    total = dict(zero)
    words_of = {}
    fold = transformer.fold_seed_words

    def recording_words(name):
        def fold_and_keep(gen, device):
            w = fold(gen, device)
            words_of.setdefault(name, []).append(w.cpu())
            return w
        return fold_and_keep

    with tempfile.TemporaryDirectory() as tmp:
        run = MmRun(tmp)
        arms_def = {"switch": ("auto", False), "plain": ("plain", False),
                    "default": ("auto", True)}
        for dtype in ("float32", "bfloat16"):
            arms = {}
            try:
                for name, (impl, fused) in arms_def.items():
                    transformer.fold_seed_words = recording_words(name)
                    arms[name] = run.run_arm(impl, dtype, fused)
            finally:
                transformer.fold_seed_words = fold
            ka, pa, da = arms["switch"], arms["plain"], arms["default"]
            problems = []
            want = dict(zero, **MM_SWITCH_LAUNCHES)
            run.check_launches(ka, pa, want, zero, problems)
            for k, v in ka["launched"].items():
                total[k] += v
            worst_rel, param_err, stat_err = run.compare(ka, pa, dtype,
                                                         problems)
            if worst_rel > MM_LOSS_RTOL[dtype]:
                problems.append(f"losses differ from the plain arm's by "
                                f"{worst_rel} relative")
            if dtype == "float32" and param_err > MM_PARAM_ATOL:
                problems.append(f"parameters differ by {param_err}")
            if stat_err > MM_STAT_ATOL[dtype]:
                problems.append(f"BN running stats differ by {stat_err}")
            # against the default arm: the same dropout masks (the same
            # seed words drawn in the same order), losses apart only by
            # the projection's order of summation
            same_words = (len(words_of["switch"]) == len(words_of["default"])
                          and all(torch.equal(a, b) for a, b in zip(
                              words_of["switch"], words_of["default"])))
            if not same_words:
                problems.append("the switch's arm drew other seed words")
            vs_default, param_vs_default, _ = run.compare(
                ka, da, dtype, problems, keys=("loss", "loss_a", "loss_v",
                                               "loss_f"))
            if vs_default > MM_LOSS_RTOL[dtype]:
                problems.append(f"losses differ from the default arm's by "
                                f"{vs_default} relative")
            words_of.clear()

            timed = {name: [] for name in ("switch", "default")}
            order = list(timed)
            for name in order:
                run.timed_call(arms[name])
            for r in range(MM_TIME_ROUNDS):
                for name in (order if r % 2 == 0 else order[::-1]):
                    timed[name].append(run.timed_call(arms[name]))
            for name in order:
                ms = sorted(timed[name])
                med = ms[len(ms) // 2]
                emit({"phase": "mmformer_switch", "dtype": dtype,
                      "arm": name, "SA_FUSED_QKV": arms[name]["fused_qkv"],
                      "batch": MM_BATCH, "ms_per_step": med,
                      "clips_per_s": MM_BATCH / med * 1e3,
                      "timed_call_ms_per_step": timed[name],
                      "peak_mem_gib": arms[name]["peak"],
                      "loss": [m["loss"] for m in arms[name]["metrics"]],
                      "launches_per_step": {
                          k: v for k, v in arms[name]["launches"][-1].items()
                          if v},
                      "nvidia_smi": smi})
            ok = not problems
            emit({"phase": "mmformer_switch_check", "dtype": dtype,
                  "max_rel_loss_diff_vs_plain": worst_rel,
                  "max_rel_loss_diff_vs_default": vs_default,
                  "loss_rtol": MM_LOSS_RTOL[dtype],
                  "max_abs_param_diff_vs_plain": param_err,
                  "max_abs_param_diff_vs_default": param_vs_default,
                  "param_atol": (MM_PARAM_ATOL if dtype == "float32"
                                 else None),
                  "max_abs_bn_stat_diff": stat_err,
                  "same_seed_words_as_default": same_words,
                  "launches_per_step": MM_SWITCH_LAUNCHES,
                  "problems": problems, "ok": ok})
            failures.extend(f"mmformer switch {dtype}: {p}"
                            for p in problems)
            del arms, ka, pa, da
            torch.cuda.empty_cache()
    return total


def mlp_cost(m: int, c: int, itemsize: int):
    """(bytes, operations) of one launch of the fused MLP (#15) at hidden
    = 4C: x and o and both weights and biases moved once; 2 operations
    per multiply-add of the two products (16·M·C²). The bound is the
    function's: g's round trip between the kernel's two products is not
    counted."""
    from gdl_tpu_torch.bench_mlp import cost

    return cost(m, c, itemsize)[:2]


def phase_flag_parity(failures):
    """Kernels #5, #4-delta and #3 against their plain versions and the
    ported default kernels at the batch-32 training shapes, and #15 at the
    four MLP shapes; each bit-equal across two runs; times of kernel,
    plain version and library yardstick."""
    import torch
    import torch.nn.functional as F

    from gdl_tpu_torch.bench_common import split_ms
    from gdl_tpu_torch.bench_mlp import mlp_part
    from gdl_tpu_torch.bench_wa_bwd import cost as wa_bwd_cost
    from gdl_tpu_torch.bench_wa_bwd import wa_bwd_part
    from gdl_tpu_torch.ops import mlp as mlp_ops
    from gdl_tpu_torch.ops import window_attention as wa

    dev = torch.device("cuda")
    scale_b = TRAIN_BATCH // BATCH
    attn_rows, mlp_rows = [], []
    for stage, bw16, c, heads, res in STAGES:
        bw, n, d = bw16 * scale_b, 49, c // heads
        arrays, bias_t, masks = stage_inputs(stage, bw, c, heads, res, dev)
        gen = torch.Generator(device=dev).manual_seed(200 + stage)
        dout32 = torch.randn((bw, n, c), generator=gen, device=dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x, w, b = (torch.from_numpy(a).to(dev, dt) for a in arrays)
            dout = dout32.to(dt)
            for mask in masks:
                errs, oks, equal = {}, [], []

                def check(name, got, want, again, ok_fn):
                    errs[name] = _max_err(got, want)
                    oks.append(ok_fn(got, want, dtype))
                    if again is not None:
                        equal.append(_bit_equal(got, again))

                with torch.no_grad():
                    out, qkv, p = wa.window_attention_qkv_fused_fwd(
                        x, w, b, bias_t, mask, heads, impl="plain")
                    # ---- #5 -------------------------------------------
                    g5 = wa.window_attention_qkv_fwd(qkv, bias_t, mask, heads)
                    a5 = wa.window_attention_qkv_fwd(qkv, bias_t, mask, heads)
                    w5 = wa.window_attention_qkv_fwd(qkv, bias_t, mask, heads,
                                                     impl="plain")
                    for name, g, a, wnt in zip(("out", "p"), g5, a5, w5):
                        check("qkv_" + name, g, wnt, a, _fwd_ok)
                    # the library yardstick: SDPA on the same q (unscaled),
                    # k, v with the bias and mask as one additive mask
                    q5 = qkv.reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
                    q_, k_, v_ = (t.contiguous() for t in q5)
                    am = attn_mask(bias_t, mask, bw, dt)
                    sd = F.scaled_dot_product_attention(q_, k_, v_,
                                                        attn_mask=am)
                    errs["sdpa_vs_plain"] = _max_err(
                        sd.permute(0, 2, 1, 3).reshape(bw, n, c), w5[0])
                    # ---- #4-delta -------------------------------------
                    delta = wa.attention_delta(out, dout, heads)
                    gd = wa.window_attention_qkv_fused_bwd(qkv, p, dout, heads,
                                                           delta=delta)
                    ad = wa.window_attention_qkv_fused_bwd(qkv, p, dout, heads,
                                                           delta=delta)
                    wd = wa.window_attention_qkv_fused_bwd(
                        qkv, p, dout, heads, impl="plain", delta=delta)
                    k4 = wa.window_attention_qkv_fused_bwd(qkv, p, dout, heads)
                    for name, g, a, wnt, dflt in zip(("dqkv", "dbias"), gd, ad,
                                                     wd, k4):
                        check("delta_" + name, g, wnt, a, _grad_ok)
                        check("delta_vs_k4_" + name, g, dflt, None, _grad_ok)
                    # ---- #3 -------------------------------------------
                    g3 = wa.window_attention_qkv_fused_bwd_fused(
                        qkv, p, dout, x, w, heads)
                    a3 = wa.window_attention_qkv_fused_bwd_fused(
                        qkv, p, dout, x, w, heads)
                    w3 = wa.window_attention_qkv_fused_bwd_fused(
                        qkv, p, dout, x, w, heads, impl="plain")

                    def split():  # #4, then the three library GEMMs
                        dq, dbias = wa.window_attention_qkv_fused_bwd(
                            qkv, p, dout, heads)
                        return (*wa._projection_bwd(dq, x, w), dbias)

                    s3 = split()
                    for name, g, a, wnt, s in zip(("dx", "dW", "db", "dbias"),
                                                  g3, a3, w3, s3):
                        check("fused_" + name, g, wnt, a, _grad_ok)
                        check("fused_vs_split_" + name, g, s, None, _grad_ok)
                    del g5, a5, w5, sd, gd, ad, wd, k4, g3, a3, w3, s3
                    plain = dict(reps=5, warmup=1)
                    times = {
                        "qkv_ms": cuda_ms(lambda: wa.window_attention_qkv_fwd(
                            qkv, bias_t, mask, heads)),
                        "qkv_plain_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_fwd(
                                qkv, bias_t, mask, heads, impl="plain"),
                            **plain),
                        "sdpa_ms": cuda_ms(
                            lambda: F.scaled_dot_product_attention(
                                q_, k_, v_, attn_mask=am)),
                        "delta_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_fused_bwd(
                                qkv, p, dout, heads, delta=delta)),
                        "delta_plain_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_fused_bwd(
                                qkv, p, dout, heads, impl="plain",
                                delta=delta), **plain),
                        "delta_make_ms": cuda_ms(
                            lambda: wa.attention_delta(out, dout, heads)),
                        "k4_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_fused_bwd(
                                qkv, p, dout, heads)),
                        "fused_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_fused_bwd_fused(
                                qkv, p, dout, x, w, heads)),
                        "fused_plain_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_fused_bwd_fused(
                                qkv, p, dout, x, w, heads, impl="plain"),
                            **plain),
                        "split_ms": cuda_ms(split),
                    }
                    # #3's device ms of one call by stage (torch.profiler)
                    parts, _ = split_ms(
                        lambda: wa.window_attention_qkv_fused_bwd_fused(
                            qkv, p, dout, x, w, heads), wa_bwd_part, traced=5)
                    for part in ("attention", "dx", "dw", "sums"):
                        times[f"fused_{part}_ms"] = parts.get(part, 0.0)
                    del q_, k_, v_, am, q5, delta, out, qkv, p
                torch.cuda.synchronize()
                ok = all(oks) and all(equal)
                runs = -(-bw // wa._bwd_windows_per_block(bw, heads))
                splits = -(-bw * n // wa._fused_bwd_split(bw * n, c))
                row = {"phase": "flag_parity",
                       "kernels": [wa.QKV_SAVEP_KERNEL_NAME,
                                   wa.BWD_DELTA_KERNEL_NAME,
                                   wa.BWD_FUSED_KERNEL_NAME],
                       "stage": stage, "Bw": bw, "C": c, "H": heads, "N": n,
                       "mask": mask is not None, "dtype": dtype,
                       "max_abs_err": errs, "fwd_tol": TRAIN_FWD_TOL[dtype],
                       "grad_frac_of_max": TRAIN_GRAD_FRAC[dtype],
                       "bit_equal_rerun": all(equal),
                       "fused_runs": runs, "fused_dw_splits": splits,
                       "fused_dw_partial_bytes": splits * 3 * c * c * 4,
                       "fused_dqkv_round_trip_bytes": wa_bwd_cost(
                           bw, c, heads, x.element_size())[2],
                       "ok": ok, **times}
                emit(row)
                attn_rows.append(row)
                if not ok:
                    failures.append(f"flag parity stage {stage} {dtype} "
                                    f"mask={mask is not None}: {errs}")
            # ---- #15 at this stage's MLP shape ----------------------------
            m, hidden = bw * n, 4 * c
            rng_m = torch.Generator(device=dev).manual_seed(900 + stage)

            def rand(*shape, std=1.0):
                return (torch.randn(shape, generator=rng_m, device=dev)
                        * std).to(dt)

            args = (rand(m, c), rand(hidden, c, std=c ** -0.5),
                    rand(hidden, std=0.1), rand(c, hidden, std=hidden ** -0.5),
                    rand(c, std=0.1))
            with torch.no_grad():
                got = mlp_ops.mlp_fused_fwd(*args)
                again = mlp_ops.mlp_fused_fwd(*args)
                want = mlp_ops.mlp_fused_fwd(*args, impl="plain")

                def chain():  # the library's calls, exact GELU
                    return F.linear(F.gelu(F.linear(args[0], args[1], args[2]),
                                           approximate="none"),
                                    args[3], args[4])

                lib = chain()
                torch.cuda.synchronize()
                nbytes, ops = mlp_cost(m, c, args[0].element_size())
                bound, by = bound_ms(nbytes, ops, dtype)
                row = {"phase": "flag_parity", "kernel": mlp_ops.KERNEL_NAME,
                       "stage": stage, "M": m, "C": c, "hidden": hidden,
                       "dtype": dtype, "max_abs_err": _max_err(got, want),
                       "max_abs_err_vs_library": _max_err(got, lib),
                       "fwd_tol": TRAIN_FWD_TOL[dtype],
                       "bit_equal_rerun": _bit_equal(got, again),
                       "supported": mlp_ops.mlp_kernel_supported(m, c, hidden,
                                                                 dt),
                       "ms": cuda_ms(lambda: mlp_ops.mlp_fused_fwd(*args)),
                       "plain_ms": cuda_ms(
                           lambda: mlp_ops.mlp_fused_fwd(*args, impl="plain"),
                           reps=5, warmup=1),
                       "library_ms": cuda_ms(chain),
                       "bytes": nbytes, "operations": ops,
                       "bound_ms": bound, "bound_by": by}
                # device ms of one call by product (torch.profiler)
                split, _ = split_ms(lambda: mlp_ops.mlp_fused_fwd(*args),
                                    mlp_part, traced=5)
                row["fc1_ms"] = split.get("fc1", 0.0)
                row["fc2_ms"] = split.get("fc2", 0.0)
                row["ok"] = (_fwd_ok(got, want, dtype)
                             and _fwd_ok(got, lib, dtype)
                             and row["bit_equal_rerun"] and row["supported"])
                del got, again, want, lib, args
            emit(row)
            mlp_rows.append(row)
            if not row["ok"]:
                failures.append(f"flag parity mlp stage {stage} {dtype}: "
                                f"{row['max_abs_err']}")
        del dout32
        torch.cuda.empty_cache()
    return attn_rows, mlp_rows


def swin_sites():
    """(stage, masked) of the 48 attention sites of a dual Swin-B pass:
    even blocks unshifted, odd blocks shifted wherever the window does not
    cover the map, both encoders."""
    return [(stage, i % 2 == 1 and res > 7)
            for _ in range(2)
            for (stage, _, _, _, res), depth in zip(STAGES, DEPTHS)
            for i in range(depth)]


def phase_variant_parity(failures):
    """Kernels #6 (forward and backward), #7 (forward and backward), #8 and
    #9 against their plain versions and the kernels they share a function
    with, at the batch-32 Swin-B stage shapes; each bit-equal across two
    runs; times of kernel, plain version and library yardstick. Then their
    path: the 48 attention sites of a dual Swin-B pass, each called once
    through the user's entry points (window_attention_qkv with
    save_p=True, transposed=False and with save_p=False, forward and
    backward; window_attention_bhnd; window_attention with use_pallas),
    float32, launch counts reset just before and read just after. Returns
    (rows, the path's launch counts)."""
    import torch
    import torch.nn.functional as F

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import window_attention as wa

    dev = torch.device("cuda")
    scale_b = TRAIN_BATCH // BATCH
    rows, site_inputs = [], {}
    for stage, bw16, c, heads, res in STAGES:
        bw, n, d = bw16 * scale_b, 49, c // heads
        arrays, bias_t, masks = stage_inputs(stage, bw, c, heads, res, dev)
        gen = torch.Generator(device=dev).manual_seed(400 + stage)
        dout32 = torch.randn((bw, n, c), generator=gen, device=dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x, w, b = (torch.from_numpy(a).to(dev, dt) for a in arrays)
            dout = dout32.to(dt)
            for mask in masks:
                errs, oks, equal = {}, [], []

                def check(name, got, want, again, ok_fn):
                    errs[name] = _max_err(got, want)
                    oks.append(ok_fn(got, want, dtype))
                    if again is not None:
                        equal.append(_bit_equal(got, again))

                def same(name, got, other, frac=False):
                    """#6 is #5 and #4's function: 1e-6 in f32 (of the
                    largest value for the sums over windows)."""
                    errs[name] = _max_err(got, other)
                    bar = 1e-6 * (float(other.float().abs().max())
                                  if frac else 1.0)
                    if dtype == "float32":
                        oks.append(errs[name] <= bar)

                with torch.no_grad():
                    _, qkv, p = wa.window_attention_qkv_fused_fwd(
                        x, w, b, bias_t, mask, heads, impl="plain")
                    k5 = wa.window_attention_qkv_fwd(qkv, bias_t, mask, heads)
                    k4 = wa.window_attention_qkv_fused_bwd(qkv, p, dout,
                                                           heads)
                    # ---- #6 ---------------------------------------------
                    kw6 = dict(transposed=False)
                    g6 = wa.window_attention_qkv_fwd(qkv, bias_t, mask, heads,
                                                     **kw6)
                    a6 = wa.window_attention_qkv_fwd(qkv, bias_t, mask, heads,
                                                     **kw6)
                    w6 = wa.window_attention_qkv_fwd(qkv, bias_t, mask, heads,
                                                     impl="plain")
                    for name, g, a, wnt, o in zip(("out", "p"), g6, a6, w6,
                                                  k5):
                        check("rows_" + name, g, wnt, a, _fwd_ok)
                        same("rows_vs_k5_" + name, g, o)
                    gb6 = wa.window_attention_qkv_fused_bwd(qkv, p, dout,
                                                            heads, **kw6)
                    ab6 = wa.window_attention_qkv_fused_bwd(qkv, p, dout,
                                                            heads, **kw6)
                    wb6 = wa.window_attention_qkv_fused_bwd(
                        qkv, p, dout, heads, impl="plain")
                    for name, g, a, wnt, o in zip(("dqkv", "dbias"), gb6, ab6,
                                                  wb6, k4):
                        check("rows_" + name, g, wnt, a, _grad_ok)
                        same("rows_vs_k4_" + name, g, o, frac=True)
                    # ---- #7 ---------------------------------------------
                    g7 = wa.window_attention_qkv_recompute_fwd(
                        qkv, bias_t, mask, heads)
                    a7 = wa.window_attention_qkv_recompute_fwd(
                        qkv, bias_t, mask, heads)
                    w7 = wa.window_attention_qkv_recompute_fwd(
                        qkv, bias_t, mask, heads, impl="plain")
                    check("recompute_out", g7, w7, a7, _fwd_ok)
                    equal.append(_bit_equal(g7, k5[0]))
                    gb7 = wa.window_attention_qkv_recompute_bwd(
                        qkv, bias_t, mask, dout, heads)
                    ab7 = wa.window_attention_qkv_recompute_bwd(
                        qkv, bias_t, mask, dout, heads)
                    wb7 = wa.window_attention_qkv_recompute_bwd(
                        qkv, bias_t, mask, dout, heads, impl="plain")
                    for name, g, a, wnt, o in zip(("dqkv", "dbias"), gb7, ab7,
                                                  wb7, k4):
                        check("recompute_" + name, g, wnt, a, _grad_ok)
                        # in f32 #7 is #5 + #4 at phase l's bars; in bf16
                        # its unrounded p makes another function
                        errs["recompute_vs_k4_" + name] = _max_err(g, o)
                        if dtype == "float32":
                            oks.append(_grad_ok(g, o, dtype))
                    # ---- #8, #9 -----------------------------------------
                    q_, k_, v_ = (t.contiguous() for t in qkv.reshape(
                        bw, n, 3, heads, d).permute(2, 0, 3, 1, 4))
                    g8 = wa.window_attention_bhnd(q_, k_, v_, bias_t, mask)
                    a8 = wa.window_attention_bhnd(q_, k_, v_, bias_t, mask)
                    g9 = wa.window_attention_packed(q_, k_, v_, bias_t, mask)
                    a9 = wa.window_attention_packed(q_, k_, v_, bias_t, mask)
                    wr = wa.window_attention_ref(q_, k_, v_, bias_t, mask)
                    check("bhnd_out", g8, wr, a8, _fwd_ok)
                    check("packed_out", g9, wr, a9, _fwd_ok)
                    equal.append(_bit_equal(g9, g8))
                    equal.append(_bit_equal(
                        g8.transpose(1, 2).reshape(bw, n, c), k5[0]))
                    # the library yardstick: SDPA on the same q (unscaled),
                    # k, v with bias + mask as one additive float mask
                    am = attn_mask(bias_t, mask, bw, dt)
                    sd = F.scaled_dot_product_attention(q_, k_, v_,
                                                        attn_mask=am)
                    errs["sdpa_vs_plain"] = _max_err(sd, wr)
                    del g6, a6, w6, gb6, ab6, wb6, g7, a7, w7, gb7, ab7, wb7
                    del g8, a8, g9, a9, wr, sd, k4

                    def sdpa_pair():
                        leaves = [t.detach().requires_grad_(True)
                                  for t in (q_, k_, v_)]
                        with torch.enable_grad():
                            out = F.scaled_dot_product_attention(
                                *leaves, attn_mask=am)
                            out.backward(torch.ones_like(out))

                    plain = dict(reps=5, warmup=1)
                    times = {
                        "rows_fwd_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_fwd(
                                qkv, bias_t, mask, heads, **kw6)),
                        "rows_fwd_plain_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_fwd(
                                qkv, bias_t, mask, heads, impl="plain"),
                            **plain),
                        "rows_bwd_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_fused_bwd(
                                qkv, p, dout, heads, **kw6)),
                        "rows_bwd_plain_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_fused_bwd(
                                qkv, p, dout, heads, impl="plain"), **plain),
                        "recompute_fwd_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_recompute_fwd(
                                qkv, bias_t, mask, heads)),
                        "recompute_fwd_plain_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_recompute_fwd(
                                qkv, bias_t, mask, heads, impl="plain"),
                            **plain),
                        "recompute_bwd_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_recompute_bwd(
                                qkv, bias_t, mask, dout, heads)),
                        "recompute_bwd_plain_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_recompute_bwd(
                                qkv, bias_t, mask, dout, heads,
                                impl="plain"), **plain),
                        "bhnd_ms": cuda_ms(lambda: wa.window_attention_bhnd(
                            q_, k_, v_, bias_t, mask)),
                        "packed_ms": cuda_ms(
                            lambda: wa.window_attention_packed(
                                q_, k_, v_, bias_t, mask)),
                        "bhnd_plain_ms": cuda_ms(
                            lambda: wa.window_attention_ref(
                                q_, k_, v_, bias_t, mask), **plain),
                        "k5_ms": cuda_ms(lambda: wa.window_attention_qkv_fwd(
                            qkv, bias_t, mask, heads)),
                        "k4_ms": cuda_ms(
                            lambda: wa.window_attention_qkv_fused_bwd(
                                qkv, p, dout, heads)),
                        "sdpa_ms": cuda_ms(
                            lambda: F.scaled_dot_product_attention(
                                q_, k_, v_, attn_mask=am)),
                        "sdpa_pair_ms": cuda_ms(sdpa_pair),
                    }
                    times["packed_plain_ms"] = times["bhnd_plain_ms"]
                    if dtype == "float32":
                        site_inputs[(stage, mask is not None)] = dict(
                            qkv=qkv, bias=bias_t, mask=mask, dout=dout,
                            heads=heads, q=q_, k=k_, v=v_)
                    del am, p, k5
                torch.cuda.synchronize()
                ok = all(oks) and all(equal)
                row = {"phase": "variant_parity",
                       "kernels": [wa.QKV_SAVEP_ROWS_KERNEL_NAME,
                                   wa.BWD_ROWS_KERNEL_NAME,
                                   wa.QKV_FWD_KERNEL_NAME,
                                   wa.BWD_RECOMPUTE_KERNEL_NAME,
                                   wa.BHND_KERNEL_NAME,
                                   wa.PACKED_KERNEL_NAME],
                       "stage": stage, "Bw": bw, "C": c, "H": heads, "N": n,
                       "mask": mask is not None, "dtype": dtype,
                       "head_group": wa.head_group(heads, d),
                       "max_abs_err": errs, "fwd_tol": TRAIN_FWD_TOL[dtype],
                       "grad_frac_of_max": TRAIN_GRAD_FRAC[dtype],
                       "bit_equal_rerun_and_shared": all(equal),
                       "ok": ok, **times}
                emit(row)
                rows.append(row)
                if not ok:
                    failures.append(f"variant parity stage {stage} {dtype} "
                                    f"mask={mask is not None}: {errs}")
        del dout32
        torch.cuda.empty_cache()

    # ---- the path: 48 sites through the user's entry points ---------------
    def site(inp):
        for save_p in (True, False):
            leaves = [inp["qkv"].clone().requires_grad_(True),
                      inp["bias"].clone().requires_grad_(True)]
            out = wa.window_attention_qkv(
                leaves[0].reshape(leaves[0].shape[0], 49, 3, -1), leaves[1],
                inp["mask"], inp["heads"], save_p=save_p, transposed=False)
            out.backward(inp["dout"])
        with torch.no_grad():
            args = (inp["q"], inp["k"], inp["v"], inp["bias"], inp["mask"])
            wa.window_attention_bhnd(*args)
            wa.window_attention(*args, use_pallas=True)

    for key in site_inputs:  # warm-up
        site(site_inputs[key])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    for key in swin_sites():
        site(site_inputs[key])
    torch.cuda.synchronize()
    path_ms = (time.perf_counter() - t) * 1e3
    launched = dict(kernels.launch_counts)
    want = {k: 2 * sum(DEPTHS) for k in VARIANT_KERNELS}
    ran = {k: v for k, v in launched.items() if v}
    ok = ran == want
    emit({"phase": "variant_path", "sites": len(swin_sites()),
          "launches": ran, "expected": want, "host_ms": path_ms, "ok": ok})
    if not ok:
        failures.append(f"variant path launched {ran}, expected {want}")
    del site_inputs
    torch.cuda.empty_cache()
    return rows, launched


def flag_launches(arm: str) -> dict:
    """The kernels that launch in one training step of a phase-m arm and
    how often, from the port's shape rules (`fused_bwd_supported`,
    `mlp_kernel_supported`) at the Swin-B stage shapes of batch 32; every
    other kernel launches 0 times."""
    import torch

    from gdl_tpu_torch.ops.mlp import mlp_kernel_supported
    from gdl_tpu_torch.ops.window_attention import fused_bwd_supported

    sites = 2 * sum(DEPTHS)
    if arm == "plain":
        return {}
    if arm == "A":
        n_mlp = 2 * sum(
            depth for (_, bw16, c, _, _), depth in zip(STAGES, DEPTHS)
            if mlp_kernel_supported(bw16 * TRAIN_BATCH // BATCH * 49, c,
                                    4 * c, torch.float32))
        counts = {QKV_SAVEP: sites, BWD_DELTA_K: sites, MLP: n_mlp}
    else:
        k = 2 * sum(
            depth for (_, _, c, heads, _), depth in zip(STAGES, DEPTHS)
            if fused_bwd_supported(49, c, heads, torch.float32))
        counts = {SAVEP: sites, BWD_FUSED: k, BWD: sites - k}
    return {k: v for k, v in counts.items() if v}


def phase_flag_train(failures, smi: str):
    """The Swin-B DGL training path under its non-default kernel flags:
    arm A (--fuse_qkv_gemm 0 --fuse_mlp 1, BWD_DELTA), arm B (defaults,
    FUSED_PROJECTION_BACKWARD) and the plain arm, from one set of seeded
    weights, through Config, serve.build_model and build_harness. Returns
    the launch counts of arms A and B over the checked steps."""
    import torch

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.config import Config
    from gdl_tpu_torch.data.synthetic import synthetic_batch
    from gdl_tpu_torch.ops import window_attention as wa
    from gdl_tpu_torch.serve import build_model
    from gdl_tpu_torch.train.loop import build_harness

    arms_def = {
        # name: (Config flags, attn_impl, BWD_DELTA, FUSED_PROJECTION_BACKWARD)
        "A": (dict(fuse_qkv_gemm=False, fuse_mlp=True), "auto", True, False),
        "B": ({}, "auto", False, True),
        "plain": ({}, "plain", False, False),
    }
    batches = None
    totals = {"A": {k: 0 for k in kernels.launch_counts},
              "B": {k: 0 for k in kernels.launch_counts}}

    def set_switches(name):
        wa.BWD_DELTA, wa.FUSED_PROJECTION_BACKWARD = arms_def[name][2:]

    def drive(name, fn, batch):
        """One call of an arm's step → (result, host ms, launch counts)."""
        set_switches(name)
        kernels.reset_launch_counts()
        t = time.perf_counter()
        res = fn(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        return res, ms, dict(kernels.launch_counts)

    try:
        for dtype in ("float32", "bfloat16"):
            arms = {}
            for name, (flags, impl, _, _) in arms_def.items():
                cfg = Config(dataset="VGGSound", backbone="swin",
                             fusion_method="concat", modality="full", fps=1,
                             batch_size=TRAIN_BATCH, log_grad_csv=False,
                             compute_dtype=dtype, **flags)
                if batches is None:
                    batches = [synthetic_batch(cfg, TRAIN_BATCH, seed=300 + k)
                               for k in range(1 + FLAG_STEPS)]
                model = build_model(cfg, attn_impl=impl, seed=4321)
                arms[name] = dict(h=build_harness(cfg, model,
                                                  steps_per_epoch=100))
            # ---- eval before any step: equal weights in all three ---------
            evals = {}
            for name in arms:
                arms[name]["h"].model.eval()
                res, _, counts = drive(name, arms[name]["h"].eval_step,
                                       batches[0])
                evals[name] = ([t.float() for t in res["logits"]], counts)
                arms[name]["h"].model.train()
            problems = []
            # arm A's qkv is not fused, so its eval attention is the plain
            # one; its MLPs are the kernel at eval as in training
            for name, want_eval in (
                    ("A", {k: v for k, v in flag_launches("A").items()
                           if k == MLP}),
                    ("B", {KERNEL: 2 * sum(DEPTHS)}), ("plain", {})):
                ran = {k: v for k, v in evals[name][1].items() if v}
                if ran != want_eval:
                    problems.append(f"eval launches of arm {name}: {ran}, "
                                    f"expected {want_eval}")
            eval_err = max(float((a - b).abs().max()) for a, b in
                           zip(evals["A"][0], evals["B"][0]))
            if not eval_err <= SERVE_ATOL[dtype]:
                problems.append(f"eval logits of arm A differ from the "
                                f"default model's by {eval_err}")
            # ---- 1 warm-up + FLAG_STEPS checked steps per arm --------------
            for name, arm in arms.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                others = other_arms_bytes(arm["h"].model)
                runs = [drive(name, arm["h"].train_step, b) for b in batches]
                arm["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
                arm["peak_over_start"] = arm["peak"] - others / 2 ** 30
                arm["metrics"] = [{k: float(v) for k, v in r[0].items()}
                                  for r in runs]
                arm["ms"] = [r[1] for r in runs]
                arm["launches"] = [r[2] for r in runs]
            param_err = {}
            if dtype == "float32":
                with torch.no_grad():
                    for name in ("A", "B"):
                        param_err[name] = max(
                            float((a - b).abs().max()) for a, b in
                            zip(arms[name]["h"].model.parameters(),
                                arms["plain"]["h"].model.parameters()))
            # ---- timed steps, the arms in turns ----------------------------
            order = list(arms)
            timed = {name: [] for name in arms}
            for r in range(FLAG_TIME_ROUNDS):
                for name in (order if r % 2 == 0 else order[::-1]):
                    timed[name].append(drive(name, arms[name]["h"].train_step,
                                             batches[r % len(batches)])[1])
            for name, arm in arms.items():
                ms = sorted(timed[name])
                med = ms[len(ms) // 2]
                emit({"phase": "flag_train", "dtype": dtype, "arm": name,
                      "flags": arms_def[name][0],
                      "BWD_DELTA": arms_def[name][2],
                      "FUSED_PROJECTION_BACKWARD": arms_def[name][3],
                      "batch": TRAIN_BATCH, "ms_per_step": med,
                      "clips_per_s": TRAIN_BATCH / med * 1e3,
                      "timed_step_ms": timed[name],
                      "checked_step_ms": arm["ms"],
                      "peak_mem_gib": arm["peak"],
                      "peak_mem_over_arm_start_gib": arm["peak_over_start"],
                      "loss": [m["loss"] for m in arm["metrics"]],
                      "grad_norm": [m["grad_norm"] for m in arm["metrics"]],
                      "launches_per_step": {k: v for k, v in
                                            arm["launches"][-1].items() if v},
                      "nvidia_smi": smi})
            # ---- checks -----------------------------------------------------
            worst = {}
            for name in arms:
                want = flag_launches(name)
                for i, counts in enumerate(arms[name]["launches"]):
                    if {k: v for k, v in counts.items() if v} != want:
                        problems.append(f"arm {name} step {i}: launches "
                                        f"{counts}, expected {want}")
                    if name in totals:
                        for k, v in counts.items():
                            totals[name][k] += v
            for name in ("A", "B"):
                worst[name] = 0.0
                for i, (mk, mp) in enumerate(zip(arms[name]["metrics"],
                                                 arms["plain"]["metrics"])):
                    for key in ("loss", "loss_a", "loss_v", "loss_f"):
                        a, b = mk[key], mp[key]
                        if not (math.isfinite(a) and math.isfinite(b)):
                            problems.append(f"arm {name} step {i}: {key} "
                                            f"not finite")
                            continue
                        worst[name] = max(worst[name],
                                          abs(a - b) / max(abs(b), 1e-12))
                if worst[name] > LOSS_RTOL[dtype]:
                    problems.append(f"arm {name}: losses differ from the "
                                    f"plain arm's by {worst[name]} relative")
                if name in param_err and param_err[name] > PARAM_ATOL:
                    problems.append(f"arm {name}: parameters differ from "
                                    f"the plain arm's by {param_err[name]}")
            ok = not problems
            emit({"phase": "flag_train_check", "dtype": dtype,
                  "max_rel_loss_diff": worst, "loss_rtol": LOSS_RTOL[dtype],
                  "max_abs_param_diff": param_err or None,
                  "param_atol": PARAM_ATOL if dtype == "float32" else None,
                  "eval_max_abs_logit_diff_A_vs_B": eval_err,
                  "eval_atol": SERVE_ATOL[dtype],
                  "expected_launches_per_step": {
                      name: flag_launches(name) for name in arms},
                  "problems": problems, "ok": ok})
            failures.extend(f"flag train {dtype}: {p}" for p in problems)
            del arms, evals
            torch.cuda.empty_cache()
    finally:
        wa.BWD_DELTA, wa.FUSED_PROJECTION_BACKWARD = False, False
    return totals


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
    from gdl_tpu_torch.bench_wa_fwd import pass_bound

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures: list = []
    record = {}
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    device_name = torch.cuda.get_device_name(0)
    record["device"] = {"phase": "device", "name": device_name,
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

    try:
        pool_parity = phase_maxpool_parity(failures)
    except Exception:
        traceback.print_exc()
        failures.append("maxpool parity raised")
        pool_parity = []
    record["maxpool_parity"] = pool_parity

    pool_launches = 0
    try:
        pool_launches = phase_resnet(failures, smi)
    except Exception:
        traceback.print_exc()
        failures.append("resnet raised")

    try:
        sa_parity, mask_parity = phase_sa_parity(failures)
    except Exception:
        traceback.print_exc()
        failures.append("sa parity raised")
        sa_parity, mask_parity = [], []
    record["sa_parity"], record["mask_parity"] = sa_parity, mask_parity

    mm_launches = {"train": {k: 0 for k in kernels.launch_counts},
                   "eval": {k: 0 for k in kernels.launch_counts}}
    try:
        mm_launches = phase_mmformer(failures, smi)
    except Exception:
        traceback.print_exc()
        failures.append("mmformer raised")

    try:
        flag_attn, flag_mlp = phase_flag_parity(failures)
    except Exception:
        traceback.print_exc()
        failures.append("flag parity raised")
        flag_attn, flag_mlp = [], []
    record["flag_parity"] = flag_attn + flag_mlp

    flag_launch = {arm: {k: 0 for k in kernels.launch_counts}
                   for arm in ("A", "B")}
    try:
        flag_launch = phase_flag_train(failures, smi)
    except Exception:
        traceback.print_exc()
        failures.append("flag train raised")

    variant_launch = {k: 0 for k in kernels.launch_counts}
    try:
        variant_rows, variant_launch = phase_variant_parity(failures)
    except Exception:
        traceback.print_exc()
        failures.append("variant parity raised")
        variant_rows = []
    record["variant_parity"] = variant_rows

    switch_launch = {k: 0 for k in kernels.launch_counts}
    try:
        switch_launch = phase_mmformer_switch(failures, smi)
    except Exception:
        traceback.print_exc()
        failures.append("mmformer switch raised")

    f32 = [r for r in parity if r["dtype"] == "float32"]
    t32 = [r for r in train_parity if r["dtype"] == "float32"]
    p32 = [r for r in pool_parity
           if r["dtype"] == "float32" and r["input"] == "relu"]
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
        {"name": POOL, "route": "cuda", "source": src + "maxpool_bwd.cu",
         "replaces": "gdl_tpu/ops/maxpool.py:176",
         "launches": pool_launches,
         "max_abs_err": max((r["max_abs_err"] for r in pool_parity),
                            default=None)},
    ]
    sa32 = [r for r in sa_parity if r["dtype"] == "float32"]
    sa_src = src + "self_attention_train.cu"
    entries += [
        {"name": SA_FWD, "route": "cuda", "source": sa_src,
         "replaces": "gdl_tpu/ops/self_attention.py:444",
         "launches": mm_launches["train"][SA_FWD],
         "max_abs_err": max((max(r["max_abs_err"][k] for k in
                                 ("out", "qkv", "p")) for r in sa32),
                            default=None)},
        {"name": SA_BWD, "route": "cuda", "source": sa_src,
         "replaces": "gdl_tpu/ops/self_attention.py:375",
         "launches": mm_launches["train"][SA_BWD],
         "max_abs_err": max((r["max_abs_err"]["dqkv"] for r in sa32),
                            default=None)},
        {"name": SA_EVAL, "route": "cuda",
         "source": src + "self_attention_eval.cu",
         "replaces": "gdl_tpu/ops/self_attention.py:689",
         "launches": mm_launches["eval"][SA_EVAL],
         "max_abs_err": max((r["max_abs_err"]["eval_out"] for r in sa32
                             if "eval_out" in r["max_abs_err"]),
                            default=None)},
        {"name": MASK, "route": "cuda", "source": src + "dropout_mask.cu",
         "replaces": "gdl_tpu/ops/dropout.py:82",
         "launches": mm_launches["train"][MASK],
         "max_abs_err": max((r["max_abs_err"] for r in mask_parity),
                            default=None)},
    ]
    fa32 = [r for r in flag_attn if r["dtype"] == "float32"]
    fm32 = {r["stage"]: r for r in flag_mlp if r["dtype"] == "float32"}
    wa_src = src + "window_attention_train.cu"

    def flag_err(prefix):
        return max((v for r in fa32 for k, v in r["max_abs_err"].items()
                    if k.startswith(prefix) and "_vs_" not in k),
                   default=None)

    entries += [
        {"name": QKV_SAVEP, "route": "cuda", "source": wa_src,
         "replaces": "gdl_tpu/ops/window_attention.py:968",
         "launches": flag_launch["A"][QKV_SAVEP],
         "max_abs_err": flag_err("qkv_")},
        {"name": BWD_DELTA_K, "route": "cuda", "source": wa_src,
         "replaces": "gdl_tpu/ops/window_attention.py:937 (BWD_DELTA)",
         "launches": flag_launch["A"][BWD_DELTA_K],
         "max_abs_err": flag_err("delta_")},
        {"name": BWD_FUSED, "route": "cuda", "source": wa_src,
         "replaces": "gdl_tpu/ops/window_attention.py:1340",
         "launches": flag_launch["B"][BWD_FUSED],
         "max_abs_err": flag_err("fused_")},
        {"name": MLP, "route": "cuda", "source": src + "mlp_fused.cu",
         "replaces": "gdl_tpu/ops/mlp.py:136",
         "launches": flag_launch["A"][MLP],
         "max_abs_err": max((r["max_abs_err"] for r in fm32.values()),
                            default=None)},
    ]
    for entry in entries:
        # no single PyTorch call computes #1, #2, #4, #10 or #11
        entry.update(ms=None, plain_ms=None, bound_ms=None, bound_by=None,
                     library_ms=None)
    # #5, #4-delta and #3 per training step of their arm (batch 32): the
    # sum over the 48 launches of the float32 per-shape medians. Library
    # yardsticks: scaled_dot_product_attention on the same q, k, v with
    # bias + mask as its additive mask for #5; kernel #4 followed by the
    # three torch.matmul of the split backward for #3.
    if len(fa32) == 7:
        for entry, key, lib_key, kind in (
                (entries[8], "qkv", "sdpa_ms", "qkv_savep"),
                (entries[9], "delta", None, "bwd_delta"),
                (entries[10], "fused", "split_ms", "bwd_fused")):
            entry["ms"] = per_pass_ms(flag_attn, "float32", key + "_ms")
            entry["plain_ms"] = per_pass_ms(flag_attn, "float32",
                                            key + "_plain_ms")
            entry["ms_bfloat16"] = per_pass_ms(flag_attn, "bfloat16",
                                               key + "_ms")
            if lib_key:
                entry["library_ms"] = per_pass_ms(flag_attn, "float32",
                                                  lib_key)
                entry["library_ms_bfloat16"] = per_pass_ms(
                    flag_attn, "bfloat16", lib_key)
            bound = per_pass_bound(kind, TRAIN_BATCH)
            entry["bound_ms"] = bound["ms"]
            entry["bound_by"] = max(bound["by"], key=bound["by"].get)
            entry["bound_launches_by"] = bound["by"]
            entry["bytes"], entry["operations"] = (bound["bytes"],
                                                   bound["operations"])
            entry["bound_ms_bfloat16"] = per_pass_bound(kind, TRAIN_BATCH,
                                                        "bfloat16")["ms"]
        entries[9]["delta_make_ms"] = per_pass_ms(flag_attn, "float32",
                                                  "delta_make_ms")
        # #3 by stage (attention, dx, dW, partial sums; profiler device
        # ms) and the bytes of dqkv's round trip through device memory
        # (written once, read by dx and by dW), beside the bound and not
        # counted in it
        for dtype, sfx in (("float32", ""), ("bfloat16", "_bfloat16")):
            for part in ("attention", "dx", "dw", "sums"):
                entries[10][f"{part}_ms{sfx}"] = per_pass_ms(
                    flag_attn, dtype, f"fused_{part}_ms")
            entries[10]["dqkv_round_trip_bytes" + sfx] = per_pass_ms(
                flag_attn, dtype, "fused_dqkv_round_trip_bytes")
        entries[9]["default_kernel_ms"] = per_pass_ms(flag_attn, "float32",
                                                      "k4_ms")
    # #15 per training step: 2 encoders x depth launches at each stage
    if len(fm32) == 4:
        calls = {stage: 2 * depth for (stage, *_), depth in zip(STAGES,
                                                               DEPTHS)}
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes",
                    "operations", "fc1_ms", "fc2_ms"):
            entries[11][key] = sum(n * fm32[s][key] for s, n in calls.items())
        by = {"bytes": 0, "operations": 0}
        for s, n in calls.items():
            by[fm32[s]["bound_by"]] += n
        entries[11]["bound_by"] = max(by, key=by.get)
        entries[11]["bound_launches_by"] = by
        for key in ("ms", "library_ms", "bound_ms", "fc1_ms", "fc2_ms"):
            entries[11][key + "_bfloat16"] = sum(
                calls[r["stage"]] * r[key] for r in flag_mlp
                if r["dtype"] == "bfloat16")
    # per request (#1, batch 16) or per training step (#2, #4, batch 32):
    # the sum over the 48 launches of the float32 per-shape medians. Beside
    # #1 and #2, F.linear + SDPA with bias + mask as its float mask: the
    # same work in two library calls (library_ms stays null: no one call
    # computes either)
    if len(f32) == 7:
        entries[0]["ms"] = per_pass_ms(parity, "float32", "ms")
        entries[0]["plain_ms"] = per_pass_ms(parity, "float32",
                                                "plain_ms")
        for dtype, sfx in (("float32", ""), ("bfloat16", "_bfloat16")):
            if sfx:
                entries[0]["ms" + sfx] = per_pass_ms(parity, dtype, "ms")
            entries[0]["linear_sdpa_ms" + sfx] = per_pass_ms(
                parity, dtype, "linear_sdpa_ms")
    if len(t32) == 7:
        for entry, key in ((entries[1], "fwd"), (entries[2], "bwd")):
            entry["ms"] = per_pass_ms(train_parity, "float32", key + "_ms")
            entry["plain_ms"] = per_pass_ms(train_parity, "float32",
                                            key + "_plain_ms")
            entry["ms_bfloat16"] = per_pass_ms(train_parity, "bfloat16",
                                               key + "_ms")
        for dtype, sfx in (("float32", ""), ("bfloat16", "_bfloat16")):
            entries[1]["linear_sdpa_ms" + sfx] = per_pass_ms(
                train_parity, dtype, "fwd_linear_sdpa_ms")
    # the bound of the same pass: each launch's, summed as the times are
    for entry, kind, batch in ((entries[0], "eval", BATCH),
                               (entries[1], "savep", TRAIN_BATCH),
                               (entries[2], "bwd", TRAIN_BATCH)):
        bound = per_pass_bound(kind, batch)
        entry["bound_ms"] = bound["ms"]
        entry["bound_by"] = max(bound["by"], key=bound["by"].get)
        entry["bound_launches_by"] = bound["by"]
        entry["bytes"], entry["operations"] = (bound["bytes"],
                                               bound["operations"])
        entry["bound_ms_bfloat16"] = per_pass_bound(kind, batch,
                                                    "bfloat16")["ms"]
    # #1's and #2's qkv traffic between their projection and attention
    # launches (#2 reads its qkv back, #1 writes and reads it), beside the
    # bound and not counted in it
    for entry, kind in ((entries[0], "eval"), (entries[1], "savep")):
        for dtype, sfx in (("float32", ""), ("bfloat16", "_bfloat16")):
            entry["qkv_split_bytes" + sfx] = pass_bound(kind,
                                                        dtype)["split_bytes"]
    # #16 per training step: its two launches, visual and audio stem
    if len(p32) == 2:
        for key in ("ms", "run_ms", "plain_ms", "library_ms", "bound_ms",
                    "bytes", "operations"):
            entries[3][key] = sum(r[key] for r in p32)
        entries[3]["bound_by"] = p32[0]["bound_by"]
        for key in ("ms", "run_ms", "bound_ms"):
            entries[3][key + "_bfloat16"] = sum(
                r[key] for r in pool_parity
                if r["dtype"] == "bfloat16" and r["input"] == "relu")
    # #10, #11 per training step and #13 per eval forward: the 7 launches
    # (4 at 196 tokens, 3 at 392), from the float32 per-shape medians; the
    # training kernels with the mask drawn in the kernel, as the model runs
    # them. The library call beside #13 is scaled_dot_product_attention on
    # the same q, k, v: the attention alone, without the projection.
    def sa_rows(mode):
        return {r["site"]: r for r in sa32 if r["dropout"] == mode}

    def sa_sum(rows, key):
        return sum(SA_CALLS[site] * rows[site][key] for site in SA_CALLS)

    for entry, kind, mode, key in ((entries[4], "fwd", "kernel", "fwd"),
                                   (entries[5], "bwd", "kernel", "bwd"),
                                   (entries[6], "eval", "none", "eval")):
        rows = sa_rows(mode)
        if set(rows) != set(SA_CALLS):
            continue
        entry["ms"] = sa_sum(rows, key + "_ms")
        entry["plain_ms"] = sa_sum(rows, key + "_plain_ms")
        if kind == "eval":
            entry["library_ms"] = sa_sum(rows, "sdpa_ms")
            entry["library_linear_sdpa_ms"] = sa_sum(rows,
                                                     "eval_linear_sdpa_ms")
            rows16 = {r["site"]: r for r in sa_parity
                      if r["dtype"] == "bfloat16" and r["dropout"] == mode}
            if set(rows16) == set(SA_CALLS):
                entry["library_ms_bfloat16"] = sa_sum(rows16, "sdpa_ms")
                entry["library_linear_sdpa_ms_bfloat16"] = sa_sum(
                    rows16, "eval_linear_sdpa_ms")
        total = {"ms": 0.0, "bytes": 0, "operations": 0,
                 "by": {"bytes": 0, "operations": 0}}
        for site, (b, n, c) in SA_SHAPES.items():
            nbytes, ops = sa_cost(kind, b, n, c, MM_HEADS, 4)
            ms, by = bound_ms(nbytes, ops)
            total["ms"] += SA_CALLS[site] * ms
            total["bytes"] += SA_CALLS[site] * nbytes
            total["operations"] += SA_CALLS[site] * ops
            total["by"][by] += SA_CALLS[site]
        entry["bound_ms"] = total["ms"]
        entry["bound_by"] = max(total["by"], key=total["by"].get)
        entry["bound_launches_by"] = total["by"]
        entry["bytes"], entry["operations"] = (total["bytes"],
                                               total["operations"])
        entry["ms_bfloat16"] = sum(
            SA_CALLS[r["site"]] * r[key + "_ms"] for r in sa_parity
            if r["dtype"] == "bfloat16" and r["dropout"] == mode)
        entry["bound_ms_bfloat16"] = sum(
            SA_CALLS[site] * bound_ms(*sa_cost(kind, b, n, c, MM_HEADS, 2),
                                      "bfloat16")[0]
            for site, (b, n, c) in SA_SHAPES.items())
    # #14 per training step: its 28 launches over the four mask shapes
    m32 = {tuple(r["shape"]): r for r in mask_parity
           if r["dtype"] == "float32"}
    if set(m32) == set(MASK_CALLS):
        for key in ("ms", "run_ms", "plain_ms", "library_ms", "bound_ms",
                    "bytes", "operations"):
            entries[7][key] = sum(n * m32[shape][key]
                                  for shape, n in MASK_CALLS.items())
        entries[7]["bound_by"] = m32[(25088, 4096)]["bound_by"]
        entries[7]["bound_ms_bfloat16"] = sum(
            n * bound_ms(*mask_cost(shape[0] * shape[1], 2))[0]
            for shape, n in MASK_CALLS.items())
        for key in ("ms", "run_ms"):
            entries[7][key + "_bfloat16"] = sum(
                MASK_CALLS[tuple(r["shape"])] * r[key] for r in mask_parity
                if r["dtype"] == "bfloat16")
    # #6, #7, #8, #9 per pass of the 48 Swin-B sites of batch 32 (the op
    # phase's path), from the float32 per-shape medians. Library
    # yardsticks: scaled_dot_product_attention on the same q, k, v with
    # bias + mask as its float mask, for the forwards (#6's also writes p,
    # as #5's does). No single call computes #6's backward; for #7's
    # backward SDPA forward + backward through autograd is timed beside
    # #7's pair.
    v32 = [r for r in variant_rows if r["dtype"] == "float32"]
    vsrc = {BHND: src + "window_attention_bhnd.cu",
            PACKED: src + "window_attention_bhnd.cu"}
    wa_at = "gdl_tpu/ops/window_attention.py:"
    for kname, replaces, key, lib_key, kind, errs in (
            (QKV_SAVEP_ROWS, wa_at + "639", "rows_fwd", "sdpa_ms",
             "qkv_savep", ("rows_out", "rows_p")),
            (BWD_ROWS, wa_at + "672", "rows_bwd", None, "bwd",
             ("rows_dqkv", "rows_dbias")),
            (QKV_FWD, wa_at + "582", "recompute_fwd", "sdpa_ms", "attn_fwd",
             ("recompute_out",)),
            (BWD_RECOMPUTE, wa_at + "605", "recompute_bwd", None,
             "bwd_recompute", ("recompute_dqkv", "recompute_dbias")),
            (BHND, wa_at + "210", "bhnd", "sdpa_ms", "attn_fwd",
             ("bhnd_out",)),
            (PACKED, wa_at + "325", "packed", "sdpa_ms", "attn_fwd",
             ("packed_out",))):
        entry = {"name": kname, "route": "cuda",
                 "source": vsrc.get(kname, wa_src), "replaces": replaces,
                 "launches": variant_launch[kname],
                 "max_abs_err": max((max(r["max_abs_err"][k] for k in errs)
                                     for r in v32), default=None),
                 "ms": None, "plain_ms": None, "bound_ms": None,
                 "bound_by": None, "library_ms": None}
        if len(v32) == 7:
            entry["ms"] = per_pass_ms(variant_rows, "float32", key + "_ms")
            entry["plain_ms"] = per_pass_ms(variant_rows, "float32",
                                            key + "_plain_ms")
            entry["ms_bfloat16"] = per_pass_ms(variant_rows, "bfloat16",
                                               key + "_ms")
            if lib_key:
                entry["library_ms"] = per_pass_ms(variant_rows, "float32",
                                                  lib_key)
                entry["library_ms_bfloat16"] = per_pass_ms(
                    variant_rows, "bfloat16", lib_key)
            bound = per_pass_bound(kind, TRAIN_BATCH)
            entry["bound_ms"] = bound["ms"]
            entry["bound_by"] = max(bound["by"], key=bound["by"].get)
            entry["bound_launches_by"] = bound["by"]
            entry["bytes"], entry["operations"] = (bound["bytes"],
                                                   bound["operations"])
            entry["bound_ms_bfloat16"] = per_pass_bound(kind, TRAIN_BATCH,
                                                        "bfloat16")["ms"]
            if kname == BWD_RECOMPUTE:
                entry["pair_ms"] = entry["ms"] + per_pass_ms(
                    variant_rows, "float32", "recompute_fwd_ms")
                entry["sdpa_forward_backward_ms"] = per_pass_ms(
                    variant_rows, "float32", "sdpa_pair_ms")
                entry["k5_k4_pair_ms"] = (
                    per_pass_ms(variant_rows, "float32", "k5_ms")
                    + per_pass_ms(variant_rows, "float32", "k4_ms"))
        entries.append(entry)
    # #12 per training step under SA_FUSED_QKV = False: 7 launches, from
    # the float32 per-shape medians with the mask drawn in the kernel; the
    # library call beside it is SDPA on the same q, k, v, as for #13, and
    # SDPA with dropout_p = MM_RATE beside it (neither writes p)
    entry = {"name": SA_QKV_FWD, "route": "cuda", "source": sa_src,
             "replaces": "gdl_tpu/ops/self_attention.py:339",
             "launches": switch_launch[SA_QKV_FWD],
             "max_abs_err": max((max(r["max_abs_err"][k] for k in
                                     ("qkv_op_out", "qkv_op_p"))
                                 for r in sa32), default=None),
             "ms": None, "plain_ms": None, "bound_ms": None,
             "bound_by": None, "library_ms": None}
    rows12, rows13 = sa_rows("kernel"), sa_rows("none")
    if set(rows12) == set(SA_CALLS) and set(rows13) == set(SA_CALLS):
        entry["ms"] = sa_sum(rows12, "qkv_fwd_ms")
        entry["plain_ms"] = sa_sum(rows12, "qkv_fwd_plain_ms")
        entry["library_ms"] = sa_sum(rows13, "sdpa_ms")
        entry["library_dropout_ms"] = sa_sum(rows12, "sdpa_dropout_ms")
        rows12_16 = {r["site"]: r for r in sa_parity
                     if r["dtype"] == "bfloat16" and r["dropout"] == "kernel"}
        rows13_16 = {r["site"]: r for r in sa_parity
                     if r["dtype"] == "bfloat16" and r["dropout"] == "none"}
        if set(rows12_16) == set(SA_CALLS) == set(rows13_16):
            entry["ms_bfloat16"] = sa_sum(rows12_16, "qkv_fwd_ms")
            entry["library_ms_bfloat16"] = sa_sum(rows13_16, "sdpa_ms")
            entry["library_dropout_ms_bfloat16"] = sa_sum(rows12_16,
                                                          "sdpa_dropout_ms")
        entry["bound_ms_bfloat16"] = sum(
            SA_CALLS[site] * bound_ms(*sa_cost("qkv_fwd", b, n, c, MM_HEADS,
                                               2), "bfloat16")[0]
            for site, (b, n, c) in SA_SHAPES.items())
        total = {"ms": 0.0, "bytes": 0, "operations": 0,
                 "by": {"bytes": 0, "operations": 0}}
        for site, (b, n, c) in SA_SHAPES.items():
            nbytes, ops = sa_cost("qkv_fwd", b, n, c, MM_HEADS, 4)
            ms, by = bound_ms(nbytes, ops)
            total["ms"] += SA_CALLS[site] * ms
            total["bytes"] += SA_CALLS[site] * nbytes
            total["operations"] += SA_CALLS[site] * ops
            total["by"][by] += SA_CALLS[site]
        entry["bound_ms"] = total["ms"]
        entry["bound_by"] = max(total["by"], key=total["by"].get)
        entry["bound_launches_by"] = total["by"]
        entry["bytes"], entry["operations"] = total["bytes"], total[
            "operations"]
    entries.append(entry)
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
    if pool_launches == 0:
        failures.append(f"{POOL} was never launched on the ResNet path")
    for k in (SA_FWD, SA_BWD, MASK):
        if mm_launches["train"][k] == 0:
            failures.append(f"{k} was never launched on the mmformer "
                            f"training path")
    if mm_launches["eval"][SA_EVAL] == 0:
        failures.append(f"{SA_EVAL} was never launched on the mmformer "
                        f"eval path")
    for arm, names in (("A", (QKV_SAVEP, BWD_DELTA_K, MLP)),
                       ("B", (BWD_FUSED,))):
        for k in names:
            if flag_launch[arm][k] == 0:
                failures.append(f"{k} was never launched on arm {arm} of "
                                f"the flag training path")
    for k in VARIANT_KERNELS:
        if variant_launch[k] == 0:
            failures.append(f"{k} was never launched on the variant path")
    if switch_launch[SA_QKV_FWD] == 0:
        failures.append(f"{SA_QKV_FWD} was never launched on the mmformer "
                        f"training path under SA_FUSED_QKV = False")
    for entry in entries:
        missing = [k for k in ("ms", "plain_ms", "bound_ms", "bound_by")
                   if entry[k] is None]
        if missing:
            failures.append(f"{entry['name']}: no {missing}")
    if failures:
        for f in failures:
            log(f"FAILED: {f}")
        return 1
    emit(record["kernels"])
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
