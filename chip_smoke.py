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
              4 timed steps per arm, in turns (median ms/step, clips/s,
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
  p. joint    the joint / OGM-GE lineage of main.py at full width,
              kernel arm against plain arm from one seed, float32 and
              bf16 autocast. ResNet: bench.py's _measure_ogm
              configuration (CREMA-D, fps 1, batch 64, dual ResNet-18
              width 64, concat, lr 2e-3, alpha 0.3, live OGM-GE over
              epochs 0-50, its noise drawn from the arms' identically
              seeded generators) through serve.build_model(dgl=False),
              build_harness(dgl=False), a Loader over a SyntheticDataset
              and train_one_epoch: 3 checked steps (cuDNN deterministic)
              with exactly 2 launches of #16 per kernel-arm step and none
              on the plain arm; losses, gradient norms, diversities,
              float32 parameters and BN statistics at phase i's bars, the
              generators' states equal; timed calls per arm in turns over
              batches collected beforehand; one pass of evaluate with no
              launch. Swin: bench.py's _measure_swin configuration
              (CREMA-D, fps 1, batch 32, dual Swin-B, concat, Normal,
              alpha 1, droppath 0.1): an eval batch before any step with
              exactly 48 launches of #1 (none on the plain arm), logits at
              phase d's bars; 1 + 2 checked steps with exactly 48 of #2
              and 48 of #4 per kernel-arm step, losses and float32
              parameters at phase f's bars; timed steps per arm in turns;
  q. export   the serving artifacts (torch.export) at full width, seeded
              weights: phase d's Swin-B config with --fuse_mlp 1 from a
              reference-schema .pth through serve.export_from_checkpoint,
              in float32 and bf16, each export in a process of its own,
              all four at once: the fixed devices=("cuda",) artifact,
              loaded afresh, replays 4 requests with exactly 48 launches
              of #1 and 48 of #15 a request (counts reset just before and
              read just after), logits against the eager ServedModel with
              the same flags (f32 max |d| <= 1e-5, bf16 <= 5e-2, argmax
              on >= 15 of 16), while the poly-batch exports run; the
              poly-batch
              artifact of the default devices ("cpu", "cuda"), at depth
              2-2-2-2 from a .pth of its own (a symbolic batch makes the
              full-depth trace take 90-124 s), replays batches 16 and 5
              with no launch, against the plain eager model of the same
              depth at phase d's bars, and (f32) on the CPU. mmformer_n
              (phase k's config) from a .pth written as main_intermediate
              writes it, serve.export_intermediate_from_checkpoint for
              CUDA: 7 launches of #13 a forward, logits against the eager
              load_intermediate_from_checkpoint at the same bars. The
              ResNet-18 flagship config through
              gdl_tpu_torch.valid.run_valid with an export path on a
              SyntheticDataset test split of 3 batches: the artifact's
              accuracies and predictions on the same clips equal
              run_valid's and the eager model's. Median ms per request
              of artifact and eager, export and load seconds;
  r. distributed
              phase i's flagship (batch 64 global) data-parallel through
              gdl_tpu_torch.parallel: (1) world size 1 under NCCL from
              torchrun's variables, maybe_initialize(): 3 checked steps
              bit-equal to phase i's kernel arm (losses, parameters, BN
              statistics), exactly 2 launches of #16 a step, no
              all-reduce, broadcast or barrier in the steps; then timed
              steps in turns with a harness built before the group
              existed, and with a third whose BatchNorms take the
              multi-rank path (GlobalBatchNorm2d.global_forward, its
              all-reduces no-ops at world size 1), and a profiler count
              of the kernels and device ms of a step of it and of the
              world-1 arm; (2) two ranks on the one card over gloo (two
              processes, device cuda:0, 32 rows each): 3 checked steps of
              the same global batches, each from phase i's kernel arm's
              state before it (model, momentum, step count, generator),
              against that arm's step at its bars (losses and gradient
              norm 1e-4 / 2e-2 relative, then the parameters and BN
              statistics 1e-4 / 2e-2 against its state after the step);
              then 3 free steps from phase i's first state: the two
              ranks' states (model, BN statistics, momentum, step count,
              generator) equal by digest before and after every step,
              the generator and step count at the end equal to phase
              i's, and each free step replayed by one process from the
              ranks' state before it and held to their state after it at
              the same bars (the trajectory itself is held to no bar: a
              last-bit change moves three free steps of the flagship
              ~1e-3); exactly 2 launches of #16 a rank-step, one
              evaluate with equal accuracies on both ranks, rank 1
              writing no file; ms/step (gloo stages through the host:
              no yardstick); (3) #14 at its four mask shapes and #10 /
              #11's in-kernel masks at [64, 392, 512], 8 heads, at
              offsets 0 and sample 32's: bit-equal to the plain version
              at that offset and to the global batch's second half; and
              in the three-segment layout of --batched_inter 1 for rank
              1 of 2 (#14 at [3 x 32 x 392, 512] and [3 x 32 x 392,
              4096], #10 / #11 at [3 x 32, 392, 512]): bit-equal to the
              plain version in that layout and to rank 1's rows of the
              global [3 x 64] launch; (4) phase k's mmformer_n with
              --batched_inter 1, float32, batch 64 global, over the same
              two gloo ranks in the same processes: one step from one
              process's state before it, against that process's step at
              phase k's bars, exactly 5 / 5 / 20 / 2 launches of #10 /
              #11 / #14 / #16 a step in the process and a rank-step in
              each rank (the three inter calls are one);
  s. profile  --profile_dir (run after phase i): phase i's flagship,
              float32, batch 64, through build_harness and
              train_one_epoch: an untraced warm-up epoch, epoch 0 of 14
              steps traced at steps 10-12, then epoch 1 again: one
              Chrome trace file, three train_step spans, exactly 6
              events of #16's kernel among its CUDA kernel events; the
              traced and untraced epochs' ms/step side by side;
  t. model parallel
              --mp (parallel/mesh.py, parallel/row_parallel.py) over gloo
              ranks on cuda:0, each a process (`chip_smoke.py
              --mp_worker`): (1) phase i's flagship, float32 and bf16,
              batch 64 global, on four ranks as --dp 2 --mp 2: 3 checked
              steps, each from phase i's kernel arm's state before it
              (fc_out and its momentum cut to each rank's columns),
              against that arm's step at phase r's bars; the four ranks'
              gradient norms, whole states and replicated tensors (by
              digest) equal; the two model ranks' fc_out shards their
              column halves of phase i's weight, bit for bit; exactly 2
              launches of #16 a rank-step; rank 0's .pth whole (its
              fc_out the shards side by side) and loaded strictly by one
              process; (2) dual Swin-B DGL with --fuse_mlp 1, float32,
              full width and depth, batch 16, on two ranks as --dp 1
              --mp 2: one checked step against one process's from phase
              m's seed at phase m's bars, exactly 48 launches of #15 (on
              fc2's gathered weight), #2 and #4 a rank-step; (3) phase
              k's mmformer_n on the same two ranks: one checked step
              from one process's state before it at phase k's float32
              bars, exactly 7 / 7 / 28 / 2 of #10 / #11 / #14 / #16 a
              rank-step. One launch of four processes, ranks 0 and 1
              regrouped as two for (2) and (3); the one-process
              references are made while the four start. The median ms of bare
              steps timed one by one after the checked ones (gloo: no
              yardstick), peak memory and the seconds of each part a
              rank, and the phase's seconds;
  g. kernels  one line per kernel: route, source, the TPU kernel it
              replaces, launches on its path (d for #1, the kernel arm
              of f for #2 and #4, of i for #16, of k for #10, #11, #13
              and #14, arm A of m for #5, #4-delta and #15, arm B of m
              for #3 (with its stages and dqkv's round trip in bytes
              beside the bound), n's path for #6, #7, #8 and #9 (#6 and #7 a
              forward and a backward entry each), the switch's kernel
              arm of o for #12; and, for #1, #2, #4 and #16, their
              launches on p's kernel arms as joint_launches; for #1,
              #13 and #15, their launches in q's counted replays of the
              fixed artifacts as export_launches, the replays as
              export_replays and their quotient as
              export_launches_per_forward; for #16 its launches a step
              of r's world-1 run and a rank-step of r's gloo run, and
              its events in s's trace; for #14, #10 and #11 whether r's
              offset and segment checks were bit-equal and their
              launches; for these four, their launches a rank-step of
              r's --batched_inter 1 run; for #16, #15, #10, #11 and
              #14, their launches a rank-step of t's --mp runs), error,
              times, the roofline bound of the same
              work (bytes moved once over 3.35 TB/s against operations
              over the float32 peak of 67 TFLOP/s; the times are the
              float32 ones) and, where one PyTorch call computes the
              function, that call's time; beside #1 and #2, F.linear +
              SDPA and the qkv traffic between their two launches.
A "wall" line gives each phase's seconds. Then the nvidia-smi line, and
last {"ok": true, "device": {...}}.

Exits non-zero without the ok line when CUDA is unavailable or any phase
fails. Uses one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import statistics
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
MM_TIME_ROUNDS = 2    # timed calls per arm, in turns (the plain arm
# takes about a second a step, and phase q needs the script's time)
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
FLAG_TIME_ROUNDS = 4  # timed steps per arm, in turns

# phase p, the joint (OGM-GE) lineage: bench.py's _measure_ogm (dual
# ResNet-18, live OGM-GE) and _measure_swin (dual Swin-B, Normal)
JOINT_RESNET_STEPS = 3    # checked steps; the first includes cuDNN's tuning
JOINT_SWIN_STEPS = 3      # 1 warm-up + 2 checked
JOINT_TIMED_STEPS = 4     # per timed call (ResNet) or per arm (Swin)
JOINT_TIME_ROUNDS = 4     # ResNet timed calls per arm, in turns
JOINT_STEPS_PER_EPOCH = 6698 // RESNET_BATCH  # bench.py's; epoch 0 modulates

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
    #16 over the checked steps, and per dtype the kernel arm's step
    metrics, its state dict after the checked steps and its training
    state before each of them (`train_snapshot`), on the CPU."""
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

    total_launches, refs = 0, {}
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
            # the kernel arm's training state before each checked step:
            # phase r's two ranks start each of their steps from it
            snaps = [] if impl == "auto" else None

            def recording(batch):
                if snaps is not None:
                    snaps.append(train_snapshot(h))
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
            # the timed calls run the bare step: the recording wrapper
            # copies the whole training state to the host before each step
            h.train_step = inner
            launched = dict(kernels.launch_counts)
            if impl == "auto":  # what phase r's world-1 arm is held to
                refs[dtype] = dict(
                    metrics=[{k: float(v) for k, v in m.items()}
                             for m, _ in steps],
                    state={k: v.detach().cpu().clone()
                           for k, v in h.model.state_dict().items()},
                    generator=h.generator.get_state(),
                    steps=h.optimizer.steps, snapshots=snaps)
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
    return total_launches, refs


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


def phase_joint(failures, smi: str) -> dict:
    """The joint / OGM-GE lineage (main.py) at full width, kernel arm
    against plain arm from one seed, float32 and bf16 autocast: bench.py's
    _measure_ogm configuration through build_harness(dgl=False) and the
    loop (#16), and its _measure_swin configuration (#2 and #4 in
    training, #1 at eval). Returns the kernel arms' launch counts."""
    import torch

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.config import Config
    from gdl_tpu_torch.data.loader import Loader
    from gdl_tpu_torch.data.synthetic import SyntheticDataset, synthetic_batch
    from gdl_tpu_torch.models.swin import WindowAttention
    from gdl_tpu_torch.serve import build_model
    from gdl_tpu_torch.train.loop import (
        build_harness,
        evaluate,
        train_one_epoch,
    )

    totals = {"resnet": 0, SAVEP: 0, BWD: 0, KERNEL: 0}

    def step_counts(h):
        """Wrap h.train_step to record each step's metrics and launches
        → (the records, the unwrapped step)."""
        steps, inner = [], h.train_step

        def recording(batch):
            before = dict(kernels.launch_counts)
            m = inner(batch)
            steps.append(({k: float(v) for k, v in m.items()},
                          {k: v - before[k] for k, v in
                           kernels.launch_counts.items()}))
            return m

        h.train_step = recording
        return steps, inner

    def ran(counts):
        return {k: v for k, v in counts.items() if v}

    def compare(ka, pa, dtype, rtol, keys, problems):
        worst = 0.0
        for i, ((mk, _), (mp, _)) in enumerate(zip(ka, pa)):
            for key in keys:
                a, b = mk[key], mp[key]
                if not (math.isfinite(a) and math.isfinite(b)):
                    problems.append(f"step {i}: {key} not finite")
                    continue
                worst = max(worst, abs(a - b) / max(abs(b), 1e-12))
        if worst > rtol:
            problems.append(f"metrics differ by {worst} relative")
        return worst

    def max_diff(a, b, buffers=False):
        with torch.no_grad():
            pairs = (zip((t for n, t in a.named_buffers() if "running" in n),
                         (t for n, t in b.named_buffers() if "running" in n))
                     if buffers else zip(a.parameters(), b.parameters()))
            return max(float((x - y).abs().max()) for x, y in pairs)

    # ---- dual ResNet-18, live OGM-GE --------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        def config(dtype):
            return Config(dataset="CREMAD", fusion_method="concat",
                          modality="full", fps=1, batch_size=RESNET_BATCH,
                          learning_rate=2e-3, alpha=0.3, modulation="OGM_GE",
                          modulation_starts=0, modulation_ends=50,
                          log_grad_csv=False, compute_dtype=dtype,
                          num_workers=8, ckpt_path=tmp,
                          encoder_width=RESNET_WIDTH)

        cfg0 = config("float32")
        train_set = SyntheticDataset(
            cfg0, size=RESNET_BATCH * JOINT_RESNET_STEPS, seed=600)
        test_set = SyntheticDataset(cfg0, size=2 * RESNET_BATCH, seed=9100)
        timed_set = SyntheticDataset(
            cfg0, size=RESNET_BATCH * JOINT_TIMED_STEPS, seed=2100)

        def loader(ds, shuffle):
            return Loader(ds, RESNET_BATCH, shuffle=shuffle, drop_last=True,
                          num_workers=8, seed=cfg0.random_seed)

        timed_batches = list(loader(timed_set, False))

        def resnet_arm(impl, dtype):
            cfg = config(dtype)
            h = build_harness(cfg, build_model(cfg, attn_impl=impl, seed=777,
                                               dgl=False),
                              steps_per_epoch=JOINT_STEPS_PER_EPOCH,
                              dgl=False)
            steps, inner = step_counts(h)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            torch.backends.cudnn.deterministic = True  # as in phase i
            try:
                with quiet():
                    train_one_epoch(h, loader(train_set, True), 0)
                torch.cuda.synchronize()
            finally:
                torch.backends.cudnn.deterministic = False
            h.train_step = inner
            return dict(h=h, steps=steps,
                        peak=torch.cuda.max_memory_allocated() / 2 ** 30)

        def timed_call(arm):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with quiet():
                train_one_epoch(arm["h"], timed_batches, 0)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3 / len(timed_batches)

        for dtype in ("float32", "bfloat16"):
            order = ("plain", "auto") if dtype == "float32" else ("auto",
                                                                  "plain")
            arms = {impl: resnet_arm(impl, dtype) for impl in order}
            ka, pa = arms["auto"], arms["plain"]
            problems = []
            for i, ((_, lk), (_, lp)) in enumerate(zip(ka["steps"],
                                                       pa["steps"])):
                if ran(lk) != {POOL: 2}:
                    problems.append(f"step {i}: kernel arm launches {ran(lk)}")
                if ran(lp):
                    problems.append(f"step {i}: plain arm launches {ran(lp)}")
                totals["resnet"] += lk[POOL]
            if len(ka["steps"]) != JOINT_RESNET_STEPS:
                problems.append(f"{len(ka['steps'])} steps ran")
            worst = compare(ka["steps"], pa["steps"], dtype,
                            RESNET_LOSS_RTOL[dtype],
                            ("loss", "loss_f", "grad_norm", "a_diversity",
                             "v_diversity"), problems)
            km, pm = ka["h"].model, pa["h"].model
            param_err = max_diff(km, pm)
            stat_err = max_diff(km, pm, buffers=True)
            if dtype == "float32" and param_err > RESNET_PARAM_ATOL:
                problems.append(f"parameters differ by {param_err}")
            if stat_err > RESNET_STAT_ATOL[dtype]:
                problems.append(f"BN running stats differ by {stat_err}")
            # the OGM-GE noise came from the arms' generators alike
            if not torch.equal(ka["h"].generator.get_state(),
                               pa["h"].generator.get_state()):
                problems.append("the arms' generators drew differently")
            timed = {impl: [] for impl in arms}
            for impl in order:  # untimed: cuDNN's default algorithms
                timed_call(arms[impl])
            for r in range(JOINT_TIME_ROUNDS):
                for impl in (order if r % 2 == 0 else order[::-1]):
                    timed[impl].append(timed_call(arms[impl]))
            kernels.reset_launch_counts()
            with quiet():
                accs = evaluate(ka["h"], loader(test_set, False))
            if ran(kernels.launch_counts):
                problems.append(f"eval launched {ran(kernels.launch_counts)}")
            if not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
                problems.append(f"accuracies {accs}")
            for impl in order:
                ms = sorted(timed[impl])
                med = ms[len(ms) // 2]
                emit({"phase": "joint_resnet", "dtype": dtype,
                      "arm": "kernel" if impl == "auto" else "plain",
                      "batch": RESNET_BATCH, "ms_per_step": med,
                      "clips_per_s": RESNET_BATCH / med * 1e3,
                      "timed_call_ms_per_step": timed[impl],
                      "peak_mem_gib": arms[impl]["peak"],
                      "loss": [m["loss"] for m, _ in arms[impl]["steps"]],
                      "grad_norm": [m["grad_norm"]
                                    for m, _ in arms[impl]["steps"]],
                      "params": sum(p.numel() for p in km.parameters()),
                      "nvidia_smi": smi})
            emit({"phase": "joint_resnet_check", "dtype": dtype,
                  "modulation": "OGM_GE", "max_rel_metric_diff": worst,
                  "metric_rtol": RESNET_LOSS_RTOL[dtype],
                  "max_abs_param_diff": param_err,
                  "param_atol": (RESNET_PARAM_ATOL if dtype == "float32"
                                 else None),
                  "max_abs_bn_stat_diff": stat_err,
                  "bn_stat_atol": RESNET_STAT_ATOL[dtype],
                  "launches_per_step": {POOL: 2}, "eval_acc": list(accs),
                  "problems": problems, "ok": not problems,
                  "nvidia_smi": smi})
            failures.extend(f"joint resnet {dtype}: {p}" for p in problems)
            del arms, ka, pa, km, pm
            torch.cuda.empty_cache()

    # ---- dual Swin-B, --modulation Normal ---------------------------------
    def swin_config(dtype):
        return Config(dataset="CREMAD", backbone="swin",
                      fusion_method="concat", modality="full", fps=1,
                      batch_size=TRAIN_BATCH, alpha=1.0, modulation="Normal",
                      log_grad_csv=False, compute_dtype=dtype)

    base = build_model(swin_config("float32"), seed=4321, dgl=False)
    batches = [synthetic_batch(swin_config("float32"), TRAIN_BATCH,
                               seed=700 + k) for k in range(JOINT_SWIN_STEPS)]
    per_step = {SAVEP: 2 * sum(DEPTHS), BWD: 2 * sum(DEPTHS)}

    def swin_arm(impl, dtype):
        model = copy.deepcopy(base)
        if impl == "plain":
            for m in model.modules():
                if isinstance(m, WindowAttention):
                    m.attn_impl = m.attn_eval_impl = "plain"
        h = build_harness(swin_config(dtype), model, steps_per_epoch=100,
                          dgl=False)
        kernels.reset_launch_counts()
        ev = h.eval_step(batches[0])  # equal weights in both arms
        torch.cuda.synchronize()
        arm = dict(h=h, eval_logits=ev["logits"][0].float(),
                   eval_launches=dict(kernels.launch_counts))
        arm["steps"], inner = step_counts(h)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        others = other_arms_bytes(model)
        for batch in batches:
            h.train_step(batch)
        torch.cuda.synchronize()
        h.train_step = inner
        arm["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
        arm["peak_over_start"] = arm["peak"] - others / 2 ** 30
        return arm

    def timed_step(arm, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        arm["h"].train_step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    for dtype in ("float32", "bfloat16"):
        order = ("plain", "auto") if dtype == "float32" else ("auto", "plain")
        arms = {impl: swin_arm(impl, dtype) for impl in order}
        ka, pa = arms["auto"], arms["plain"]
        problems = []
        if ran(ka["eval_launches"]) != {KERNEL: 2 * sum(DEPTHS)}:
            problems.append(f"kernel arm eval launches "
                            f"{ran(ka['eval_launches'])}")
        if ran(pa["eval_launches"]):
            problems.append(f"plain arm eval launches "
                            f"{ran(pa['eval_launches'])}")
        totals[KERNEL] += ka["eval_launches"][KERNEL]
        eval_err = float((ka["eval_logits"] - pa["eval_logits"]).abs().max())
        if not eval_err <= SERVE_ATOL[dtype]:
            problems.append(f"eval logits differ by {eval_err}")
        for i, ((_, lk), (_, lp)) in enumerate(zip(ka["steps"],
                                                   pa["steps"])):
            if ran(lk) != per_step:
                problems.append(f"step {i}: kernel arm launches {ran(lk)}")
            if ran(lp):
                problems.append(f"step {i}: plain arm launches {ran(lp)}")
            for k in per_step:
                totals[k] += lk[k]
        worst = compare(ka["steps"], pa["steps"], dtype, LOSS_RTOL[dtype],
                        ("loss", "loss_f", "a_diversity", "v_diversity"),
                        problems)
        param_err = max_diff(ka["h"].model, pa["h"].model)
        if dtype == "float32" and param_err > PARAM_ATOL:
            problems.append(f"parameters differ by {param_err}")
        timed = {impl: [] for impl in arms}
        for r in range(JOINT_TIMED_STEPS):
            for impl in (order if r % 2 == 0 else order[::-1]):
                timed[impl].append(timed_step(arms[impl],
                                              batches[r % len(batches)]))
        for impl in order:
            ms = sorted(timed[impl])
            med = ms[len(ms) // 2]
            emit({"phase": "joint_swin", "dtype": dtype,
                  "arm": "kernel" if impl == "auto" else "plain",
                  "batch": TRAIN_BATCH, "ms_per_step": med,
                  "clips_per_s": TRAIN_BATCH / med * 1e3,
                  "timed_step_ms": timed[impl],
                  "peak_mem_gib": arms[impl]["peak"],
                  "peak_mem_over_arm_start_gib":
                      arms[impl]["peak_over_start"],
                  "loss": [m["loss"] for m, _ in arms[impl]["steps"]],
                  "params": sum(p.numel() for p in base.parameters()),
                  "nvidia_smi": smi})
        emit({"phase": "joint_swin_check", "dtype": dtype,
              "modulation": "Normal", "max_rel_metric_diff": worst,
              "metric_rtol": LOSS_RTOL[dtype],
              "max_abs_param_diff": param_err,
              "param_atol": PARAM_ATOL if dtype == "float32" else None,
              "eval_max_abs_logit_diff": eval_err,
              "eval_atol": SERVE_ATOL[dtype],
              "launches_per_step": per_step,
              "eval_launches": {KERNEL: 2 * sum(DEPTHS)},
              "problems": problems, "ok": not problems, "nvidia_smi": smi})
        failures.extend(f"joint swin {dtype}: {p}" for p in problems)
        del arms, ka, pa
        torch.cuda.empty_cache()
    return totals


# phase q, the serving artifacts (torch.export): artifact against eager
EXPORT_ATOL = {"float32": 1e-5, "bfloat16": 5e-2}  # same kernels, same bars
# launches of one replayed request of the fixed Swin-B artifact (--fuse_mlp
# 1) and of one replayed mmformer_n forward
SWIN_EXPORT_LAUNCHES = {KERNEL: 48, MLP: 48}
MM_EXPORT_LAUNCHES = {SA_EVAL: 7}
POLY_BATCHES = (BATCH, 5)
POLY_DEPTHS = (2, 2, 2, 2)  # the poly-batch Swin-B artifacts' depth
MM_EXPORT_BATCHES = 2
VALID_BATCHES = 3
SWIN_EXPORT = dict(dataset="CREMAD", backbone="swin", fusion_method="concat",
                   fps=1, batch_size=BATCH, fuse_mlp=True)


def export_job(spec: str) -> int:
    """One Swin-B export of phase q in a process of its own (the traces
    are host work, and phase q runs four of them at once):
    spec = JSON {"pth", "out", "dtype", "poly"}."""
    import torch

    from gdl_tpu_torch.config import Config
    from gdl_tpu_torch.serve import export_from_checkpoint

    job = json.loads(spec)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(**SWIN_EXPORT, compute_dtype=job["dtype"],
                 swin_depths=job["depths"])
    t = time.perf_counter()
    if job["poly"]:  # the default devices, ("cpu", "cuda")
        export_from_checkpoint(cfg, job["pth"], job["out"], poly_batch=True)
    else:
        export_from_checkpoint(cfg, job["pth"], job["out"],
                               devices=("cuda",))
    emit({"export_s": time.perf_counter() - t})
    return 0


def _compare_logits(got, want, rows, n_classes, problems, what):
    """(max |d|, least argmax agreement) of two logit tuples of `rows`."""
    worst, agree = 0.0, rows
    for g, w in zip(got, want):
        if tuple(g.shape) != (rows, n_classes) or not _finite(g):
            problems.append(f"{what}: bad logits {tuple(g.shape)}")
            continue
        worst = max(worst, _max_err(g, w))
        agree = min(agree, int((g.argmax(-1) == w.argmax(-1)).sum()))
    return worst, agree


def phase_export(failures, smi: str):
    """The serving artifacts through gdl_tpu_torch.serve's export functions
    and gdl_tpu_torch.valid, at full width. Returns (launches over the
    counted replays of the fixed artifacts, the number of those replays
    for #1, #15 and #13)."""
    import torch

    from gdl_tpu_torch import kernels, main_intermediate
    from gdl_tpu_torch.config import Config
    from gdl_tpu_torch.data.loader import Loader
    from gdl_tpu_torch.data.preprocess import make_eval_preprocess
    from gdl_tpu_torch.data.synthetic import SyntheticDataset, synthetic_batch
    from gdl_tpu_torch.serve import (
        ServedModel,
        build_model,
        export_intermediate_from_checkpoint,
        load_exported,
        load_from_checkpoint,
        load_intermediate_from_checkpoint,
    )
    from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint
    from gdl_tpu_torch.utils.metrics import PerClassAccuracy
    from gdl_tpu_torch.valid import run_valid

    dev = torch.device("cuda")
    zero = {k: 0 for k in kernels.launch_counts}
    launched = dict(zero)
    replays = {KERNEL: 0, MLP: 0, SA_EVAL: 0}

    def drive(fn, inputs):
        outs, ms = [], []
        for audio, visual in inputs:
            t = time.perf_counter()
            outs.append(fn(audio, visual))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return outs, sorted(ms)[len(ms) // 2]

    def counted(fn, inputs):
        """Replays after a warm-up call, launch counts reset just before
        and read just after → (outputs, median ms, counts)."""
        fn(*inputs[0])  # the allocator, cuDNN and the kernels' load
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        outs, ms = drive(fn, inputs)
        counts = dict(kernels.launch_counts)
        for k, v in counts.items():
            launched[k] += v
        return outs, ms, counts

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    with tempfile.TemporaryDirectory() as tmp:
        # Swin-B serving (phase d's weights and config, --fuse_mlp 1): the
        # four exports run in processes of their own while this one works
        # (the poly-batch artifacts at depth 2-2-2-2, POLY_DEPTHS, from a
        # .pth of their own: a symbolic batch makes the trace slow)
        cfg = Config(**SWIN_EXPORT)
        cfg_poly = Config(**SWIN_EXPORT, swin_depths=list(POLY_DEPTHS))
        pths = {}
        for poly, c in ((False, cfg), (True, cfg_poly)):
            pths[poly] = os.path.join(tmp, f"best_model_{int(poly)}.pth")
            model = build_model(c, seed=1234)
            torch.save({"model": {"module." + k: v for k, v in
                                  model.state_dict().items()},
                        "fusion": c.fusion_method}, pths[poly])
            del model
        pth = pths[False]
        jobs = {}
        for poly in (True, False):  # the longest traces first
            for dtype in ("float32", "bfloat16"):
                out = os.path.join(tmp, f"swin_{dtype}_{int(poly)}.pt2")
                spec = json.dumps({
                    "pth": pths[poly], "out": out, "dtype": dtype,
                    "poly": poly, "depths": (cfg_poly if poly
                                             else cfg).swin_depths})
                jobs[(dtype, poly)] = (out, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--export_job", spec], stdout=subprocess.PIPE,
                    text=True))

        # mmformer_n eval (phase k's config), its .pth as main_intermediate
        # writes it
        mbase = dict(dataset="CREMAD", fps=1, batch_size=MM_BATCH,
                     modulation="Normal", encoder_width=RESNET_WIDTH,
                     ckpt_path=tmp)
        mcfg = Config(**mbase)
        model, _ = main_intermediate.build_model(
            "mmformer_n", mcfg.n_classes, RESNET_WIDTH, share_streams=True,
            seed=4321)
        mpth = save_best_checkpoint(mcfg, model, 1, 0.5)
        del model
        mpre = make_eval_preprocess(mcfg, dev)
        batches = []
        for k in range(MM_EXPORT_BATCHES):
            b = mpre(synthetic_batch(mcfg, MM_BATCH, seed=700 + k))
            batches.append((b["audio"], b["visual"]))
        want_mm = dict(zero, **{k: v * MM_EXPORT_BATCHES
                                for k, v in MM_EXPORT_LAUNCHES.items()})
        for dtype in ("float32", "bfloat16"):
            problems = []
            cfg_dt = Config(**dict(mbase, compute_dtype=dtype))
            art = os.path.join(tmp, f"mmformer_{dtype}.pt2")
            t = time.perf_counter()
            export_intermediate_from_checkpoint(
                cfg_dt, "mmformer_n", mpth, art, devices=("cuda",),
                share_streams=True)
            export_s = time.perf_counter() - t
            exported = load_exported(art, "cuda")
            outs, art_ms, counts = counted(exported.call, batches)
            replays[SA_EVAL] += len(batches)
            if counts != want_mm:
                problems.append(f"artifact launched {nonzero(counts)}")
            served = load_intermediate_from_checkpoint(
                cfg_dt, "mmformer_n", mpth, "cuda", share_streams=True)
            want, eager_ms = drive(served, batches)
            worst, agree = 0.0, MM_BATCH
            for g, w in zip(outs, want):
                if len(g) != 7 or not all(_finite(o) for o in g):
                    problems.append("the artifact's 7-tuple is not finite")
                e, a = _compare_logits((g[0], g[5], g[6]), w, MM_BATCH,
                                       mcfg.n_classes, problems, "mmformer")
                worst, agree = max(worst, e), min(agree, a)
            need = MM_BATCH * MIN_ARGMAX_AGREE // BATCH
            if worst > EXPORT_ATOL[dtype] or agree < need:
                problems.append(f"artifact vs eager: max |dlogit| {worst}, "
                                f"argmax {agree}/{MM_BATCH}")
            emit({"phase": "export", "model": "mmformer_n", "dtype": dtype,
                  "batch": MM_BATCH, "forwards": MM_EXPORT_BATCHES,
                  "artifact_ms_per_forward": art_ms,
                  "eager_ms_per_forward": eager_ms,
                  "max_abs_logit_err": worst, "atol": EXPORT_ATOL[dtype],
                  "min_argmax_agree": agree,
                  "launches_per_forward": {
                      k: v // MM_EXPORT_BATCHES
                      for k, v in nonzero(counts).items()},
                  "export_s": export_s, "nvidia_smi": smi,
                  "problems": problems, "ok": not problems})
            failures.extend(f"export mmformer {dtype}: {p}" for p in problems)
            del exported, served
        torch.cuda.empty_cache()

        # valid: the flagship ResNet-18 config, a .pth, run_valid with an
        # export path, then the artifact on the same preprocessed clips
        problems = []
        rpth = os.path.join(tmp, "resnet.pth")
        rcfg = Config(dataset="CREMAD", fusion_method="concat",
                      modality="full", fps=1, batch_size=RESNET_BATCH,
                      modulation="Normal", encoder_width=RESNET_WIDTH,
                      num_workers=8, ckpt_path=rpth, log_grad_csv=False)
        model = build_model(rcfg, seed=99)
        torch.save({"model": model.state_dict(),
                    "fusion": rcfg.fusion_method}, rpth)
        del model
        test_set = SyntheticDataset(rcfg, size=RESNET_BATCH * VALID_BATCHES,
                                    seed=9500)
        art = os.path.join(tmp, "resnet.pt2")
        t = time.perf_counter()
        with quiet():
            accs = run_valid(rcfg, test_set, export_path=art)
        valid_s = time.perf_counter() - t
        exported = load_exported(art, "cuda")
        served = load_from_checkpoint(rcfg, rpth, "cuda")
        rpre = make_eval_preprocess(rcfg, dev)
        counters = PerClassAccuracy(rcfg.n_classes)
        kernels.reset_launch_counts()
        differ = 0
        for batch in Loader(test_set, RESNET_BATCH, shuffle=False,
                            drop_last=False, num_workers=8,
                            seed=rcfg.random_seed):
            b = rpre(batch)
            preds = [o.argmax(-1) for o in exported.call(b["audio"],
                                                         b["visual"])]
            counters.update(*(p.cpu().numpy() for p in preds),
                            b["label"].cpu().numpy())
            theirs = served.eval_batch(batch)
            differ += sum(int((p != theirs[k]).sum()) for p, k in
                          zip(preds, ("pred", "pred_a", "pred_v")))
        replayed = counters.results()
        if any(kernels.launch_counts.values()):
            problems.append(f"the ResNet artifact launched "
                            f"{nonzero(kernels.launch_counts)}")
        if tuple(replayed) != tuple(accs):
            problems.append(f"artifact accuracies {replayed} != "
                            f"run_valid's {accs}")
        if differ:
            problems.append(f"{differ} artifact predictions differ from "
                            f"the eager model's")
        emit({"phase": "export", "model": "resnet18_valid",
              "dtype": "float32", "batch": RESNET_BATCH,
              "clips": len(test_set), "valid_accs": list(accs),
              "artifact_accs": list(replayed), "valid_s": valid_s,
              "problems": problems, "ok": not problems})
        failures.extend(f"export valid: {p}" for p in problems)
        del exported, served

        # the Swin-B artifacts, each loaded afresh, against the eager
        # models with the same flags: the kernels, and the plain versions
        pre = make_eval_preprocess(cfg, dev)
        requests = []
        for k in range(N_REQUESTS):
            b = pre(synthetic_batch(cfg, BATCH, seed=300 + k))
            requests.append((b["audio"], b["visual"]))
        want_fixed = dict(zero, **{k: v * N_REQUESTS
                                   for k, v in SWIN_EXPORT_LAUNCHES.items()})
        eager32 = load_from_checkpoint(cfg, pth, "cuda")
        plain32 = load_from_checkpoint(cfg_poly, pths[True], "cuda",
                                       attn_impl="plain")

        def finished(dtype, poly, problems):
            """Wait for an export job → its seconds (None if it failed)."""
            proc = jobs[(dtype, poly)][1]
            stdout, _ = proc.communicate()
            if proc.returncode != 0:
                problems.append(f"export job exited {proc.returncode}")
                return None
            return json.loads(stdout.strip().splitlines()[-1])["export_s"]

        # the fixed artifacts first: their jobs end long before the
        # poly-batch ones
        for dtype in ("float32", "bfloat16"):
            problems = []
            eager = ServedModel(eager32.model, cfg, "cuda",
                                getattr(torch, dtype))
            export_s = finished(dtype, False, problems)
            if export_s is not None:
                t = time.perf_counter()
                exported = load_exported(jobs[(dtype, False)][0], "cuda")
                load_s = time.perf_counter() - t
                outs, art_ms, counts = counted(exported.call, requests)
                replays[KERNEL] += len(requests)
                replays[MLP] += len(requests)
                if counts != want_fixed:
                    problems.append(f"artifact launched {nonzero(counts)}")
                kernels.reset_launch_counts()
                want, eager_ms = drive(eager, requests)
                if kernels.launch_counts != want_fixed:
                    problems.append(f"the eager model launched "
                                    f"{nonzero(kernels.launch_counts)}")
                worst, agree = 0.0, BATCH
                for g, w in zip(outs, want):
                    e, a = _compare_logits(g, w, BATCH, cfg.n_classes,
                                           problems, "fixed")
                    worst, agree = max(worst, e), min(agree, a)
                if worst > EXPORT_ATOL[dtype] or agree < MIN_ARGMAX_AGREE:
                    problems.append(f"artifact vs eager: max |dlogit| "
                                    f"{worst}, argmax {agree}/{BATCH}")
                del exported
                emit({"phase": "export", "model": "swin_b",
                      "artifact": "fixed, cuda", "dtype": dtype,
                      "batch": BATCH, "requests": N_REQUESTS,
                      "artifact_ms_per_request": art_ms,
                      "eager_ms_per_request": eager_ms,
                      "max_abs_logit_err": worst,
                      "atol": EXPORT_ATOL[dtype], "min_argmax_agree": agree,
                      "launches_per_request": {
                          k: v // N_REQUESTS
                          for k, v in nonzero(counts).items()},
                      "export_s": export_s, "load_s": load_s,
                      "nvidia_smi": smi, "problems": problems,
                      "ok": not problems})
            failures.extend(f"export swin {dtype}: {p}" for p in problems)

        # the poly-batch artifacts, devices ("cpu", "cuda"), against the
        # plain eager model at phase d's bars, at two batch sizes
        for dtype in ("float32", "bfloat16"):
            problems = []
            plain = ServedModel(plain32.model, cfg_poly, "cuda",
                                getattr(torch, dtype))
            export_s = finished(dtype, True, problems)
            if export_s is not None:
                path = jobs[(dtype, True)][0]
                pexp = load_exported(path, "cuda")
                rows_out = {}
                for rows in POLY_BATCHES:
                    inputs = [(a[:rows], v[:rows]) for a, v in requests]
                    outs, ms, counts = counted(pexp.call, inputs)
                    if any(counts.values()):
                        problems.append(f"batch {rows}: launched "
                                        f"{nonzero(counts)}")
                    want, plain_ms = drive(plain, inputs)
                    worst, agree = 0.0, rows
                    for g, w in zip(outs, want):
                        e, a = _compare_logits(g, w, rows, cfg.n_classes,
                                               problems, f"batch {rows}")
                        worst, agree = max(worst, e), min(agree, a)
                    if (worst > SERVE_ATOL[dtype]
                            or agree < rows - (BATCH - MIN_ARGMAX_AGREE)):
                        problems.append(f"batch {rows} vs plain eager: max "
                                        f"|dlogit| {worst}, argmax "
                                        f"{agree}/{rows}")
                    rows_out[rows] = {"artifact_ms_per_request": ms,
                                      "plain_ms_per_request": plain_ms,
                                      "max_abs_logit_err": worst,
                                      "min_argmax_agree": agree}
                del pexp
                cpu_err = None
                if dtype == "float32":  # the same file, on the CPU
                    a, v = requests[0]
                    got = load_exported(path, "cpu").call(a[:2].cpu(),
                                                          v[:2].cpu())
                    cpu_err = max(_max_err(g.to(dev), w[:2])
                                  for g, w in zip(got, plain(a, v)))
                    if cpu_err > SERVE_ATOL[dtype]:
                        problems.append(f"on the CPU: max |dlogit| "
                                        f"{cpu_err}")
                emit({"phase": "export", "model": "swin_b",
                      "artifact": "poly-batch, cpu and cuda",
                      "dtype": dtype, "requests": N_REQUESTS,
                      "batches": rows_out, "atol": SERVE_ATOL[dtype],
                      "cpu_batch2_max_abs_logit_err": cpu_err,
                      "export_s": export_s, "nvidia_smi": smi,
                      "problems": problems, "ok": not problems})
            failures.extend(f"export swin poly {dtype}: {p}"
                            for p in problems)
        for _, proc in jobs.values():  # none outlives the phase
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        del eager32, plain32
        torch.cuda.empty_cache()
    return launched, replays


# ---- phase r: multi-process data parallelism ------------------------------

DP_CHECKED_STEPS = RESNET_CHECKED_STEPS  # phase i's checked batches
DP_TIMED_STEPS = 4     # per timed call
DP_TIME_ROUNDS = 4     # world-1 timed calls per arm, in turns
DP_GLOO_ROUNDS = 1     # gloo timed calls per dtype
DP_RANKS = 2
COLLECTIVES = ("all_reduce", "broadcast", "barrier")
# the four mask shapes of #14 and the attention shape of #10 / #11 at
# batch 64, each split at sample 32 (the second of two ranks' rows)
OFFSET_SA = (MM_BATCH, 392, 512)
# part 3 under --batched_inter 1: rank 1 of 2 holds [3 x 32] of the
# [3 x 64] stack of three passes; #14's two inter mask widths at 392
# tokens and #10 / #11's inter attention, in element_layout(passes=3)
SEG_WORLD, SEG_RANK = 2, 1
SEG_TOKENS = 392
SEG_MASK_WIDTHS = (512, 4096)
SEG_SA = (3 * MM_BATCH // SEG_WORLD, SEG_TOKENS, 512)
# part 4: phase k's mmformer_n under --batched_inter 1, one step; its
# three inter calls are one: 4 + 1 attention calls, 4 x 4 + 4 masks
MM_BATCHED_LAUNCHES = {SA_FWD: 5, SA_BWD: 5, MASK: 20, POOL: 2}

# ---- phase s: --profile_dir -------------------------------------------------

PROFILE_STEPS = 14   # an epoch; steps 10-12 are traced
PROFILE_SPANS = 3
PROFILE_POOL_EVENTS = 2 * PROFILE_SPANS  # #16's two launches a step


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def resnet_dp_config(dtype: str, ckpt: str, **kw):
    """Phase i's flagship configuration (batch 64 global)."""
    from gdl_tpu_torch.config import Config

    return Config(dataset="CREMAD", fusion_method="concat",
                  modality="full", fps=1, batch_size=RESNET_BATCH,
                  learning_rate=2e-3, alpha=5.0, modulation="Normal",
                  log_grad_csv=False, compute_dtype=dtype, ckpt_path=ckpt,
                  encoder_width=RESNET_WIDTH, **kw)


def resnet_dp_sets(cfg):
    """Phase i's train, test and timed sets."""
    from gdl_tpu_torch.data.synthetic import SyntheticDataset

    return (SyntheticDataset(cfg, size=RESNET_BATCH * DP_CHECKED_STEPS,
                             seed=500),
            SyntheticDataset(cfg, size=2 * RESNET_BATCH, seed=9000),
            SyntheticDataset(cfg, size=RESNET_BATCH * DP_TIMED_STEPS,
                             seed=2000))


def recorded_steps(h):
    """Wrap h.train_step: each step's metrics (floats) and its launches."""
    from gdl_tpu_torch import kernels

    steps, inner = [], h.train_step

    def recording(batch):
        before = dict(kernels.launch_counts)
        m = inner(batch)
        steps.append(({k: float(v) for k, v in m.items()},
                      {k: v - before[k] for k, v in
                       kernels.launch_counts.items()}))
        return m

    h.train_step = recording
    return steps


def checked_epoch(h, loader):
    """One epoch of the checked batches with cuDNN's deterministic
    algorithms (phase i's rule)."""
    import torch

    from gdl_tpu_torch.train.loop import train_one_epoch

    torch.backends.cudnn.deterministic = True
    try:
        with quiet():
            train_one_epoch(h, loader, 0)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False


def timed_epoch_ms(h, batches) -> float:
    """ms per step of one epoch over `batches` (host clock, synchronised)."""
    import torch

    from gdl_tpu_torch.train.loop import train_one_epoch

    torch.cuda.synchronize()
    t = time.perf_counter()
    with quiet():
        train_one_epoch(h, batches, 1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / len(batches)


def step_ms(h, batches) -> list:
    """ms of each step over `batches`, each an epoch of its own
    (`timed_epoch_ms`)."""
    return [timed_epoch_ms(h, [b]) for b in batches]


def profiled_epoch(h, batches) -> dict:
    """Device operations (kernels, copies, sets) and device ms a step of
    one epoch over `batches`, by a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdl_tpu_torch.train.loop import train_one_epoch

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with quiet():
            train_one_epoch(h, batches, 1)
        torch.cuda.synchronize()
    ops = ms = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t <= 0 or ev.key.startswith("cudaLaunch"):
            continue
        ops += ev.count
        ms += t / 1e3
    return {"device_ops_per_step": ops / len(batches),
            "device_ms_per_step": ms / len(batches)}


def train_snapshot(h) -> dict:
    """A harness's training state, copied to the CPU: model, optimizer,
    its step count and the generator's state."""
    import torch

    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().clone()
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cpu(v) for v in x)
        return x

    return {"model": cpu(h.model.state_dict()),
            "optimizer": cpu(h.optimizer.state_dict()),
            "steps": h.optimizer.steps,
            "generator": h.generator.get_state()}


def restore_snapshot(h, snap: dict) -> None:
    """Load a `train_snapshot` into `h`; a row-parallel layer (--mp) takes
    its columns of each whole tensor, its momentum too."""
    from gdl_tpu_torch.parallel.row_parallel import shard_optimizer_state

    h.model.load_state_dict(snap["model"])
    h.optimizer.load_state_dict(shard_optimizer_state(
        snap["optimizer"], h.optimizer, h.model))
    h.optimizer.steps = snap["steps"]
    h.generator.set_state(snap["generator"])


def state_digest(snap: dict) -> str:
    """sha256 of a `train_snapshot`: every tensor's bytes in a canonical
    layout, and every other value's repr, in key order."""
    import hashlib

    import torch

    digest = hashlib.sha256()

    def feed(x):
        if isinstance(x, torch.Tensor):
            digest.update(str(x.dtype).encode())
            digest.update(x.contiguous().reshape(-1).view(torch.uint8)
                          .numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                digest.update(repr(k).encode())
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                feed(v)
        else:
            digest.update(repr(x).encode())

    feed(snap)
    return digest.hexdigest()


def state_errors(model, ref: dict):
    """(max |Δ| of the parameters, of the BN running statistics) against
    a state dict on the CPU; `model` may be a state dict itself."""
    param_err = stat_err = 0.0
    state = model if isinstance(model, dict) else model.state_dict()
    for k, v in state.items():
        if "num_batches" in k:
            continue
        d = float((v.detach().cpu().double() - ref[k].double()).abs().max())
        if "running" in k:
            stat_err = max(stat_err, d)
        else:
            param_err = max(param_err, d)
    return param_err, stat_err


def dp_worker(spec: str) -> int:
    """One rank of phase r's two-rank run on the one card over gloo
    (torchrun's variables set by the parent): phase i's flagship at batch
    64 global, 32 a rank, per dtype: 3 checked steps, each from phase i's
    kernel arm's state before that step (snap_<dtype>_<k>.pt under spec's
    "dir") on its global batch, the state after it held to phase i's next
    one; 3 free steps from phase i's first state, the state before each
    and after the last digested (and saved by rank 0 under free_<dtype>/
    for the parent's replay); one evaluate, the rank-0 files, timed
    steps. With spec's "mm_batched", then one step of phase k's
    mmformer_n under --batched_inter 1 (`mm_batched_rank`). Writes its
    results as JSON under spec's "dir"."""
    import torch

    from gdl_tpu_torch.data.loader import Loader
    from gdl_tpu_torch.parallel import distributed as dist
    from gdl_tpu_torch.serve import build_model
    from gdl_tpu_torch.train.loop import build_harness, evaluate, make_loaders
    from gdl_tpu_torch.utils.checkpoint import (
        save_best_checkpoint,
        save_train_state,
    )
    from gdl_tpu_torch.utils.logging import CSVLogger

    job = json.loads(spec)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.maybe_initialize(backend="gloo")
    rank = dist.process_index()
    out = {"rank": rank, "world": dist.process_count(), "arms": {}}
    try:
        for dtype in ("float32", "bfloat16"):
            ckpt = os.path.join(job["dir"], f"rank{rank}_{dtype}")
            cfg = resnet_dp_config(dtype, ckpt, num_workers=4,
                                   device="cuda:0")
            train_set, test_set, timed_set = resnet_dp_sets(cfg)
            train_loader, test_loader = make_loaders(cfg, train_set,
                                                     test_set)
            h = build_harness(cfg, build_model(cfg, seed=777),
                              steps_per_epoch=100)
            snaps = [torch.load(os.path.join(job["dir"],
                                             f"snap_{dtype}_{k}.pt"),
                                weights_only=False)
                     for k in range(DP_CHECKED_STEPS + 1)]
            log = recorded_steps(h)
            errors = []
            batches = list(train_loader)  # a second pass would reshuffle
            for k, batch in enumerate(batches):
                restore_snapshot(h, snaps[k])
                checked_epoch(h, [batch])
                errors.append(state_errors(h.model, snaps[k + 1]["model"]))
            steps = list(log)  # the checked ones
            # the free steps, from phase i's first state
            restore_snapshot(h, snaps[0])
            free_dir = os.path.join(job["dir"], f"free_{dtype}")
            os.makedirs(free_dir, exist_ok=True)
            digests, inner = [], h.train_step

            def keep():
                snap = train_snapshot(h)
                if rank == 0:
                    torch.save(snap, os.path.join(free_dir,
                                                  f"{len(digests)}.pt"))
                digests.append(state_digest(snap))

            def keeping(batch):
                keep()
                return inner(batch)

            h.train_step = keeping
            checked_epoch(h, batches)
            h.train_step = inner
            keep()
            free = log[len(steps):]
            end = snaps[-1]
            free_end_as_phase_i = (
                torch.equal(h.generator.get_state(), end["generator"])
                and h.optimizer.steps == end["steps"])
            free_drift = state_errors(h.model, end["model"])
            del snaps, end
            with quiet():
                accs = evaluate(h, test_loader)
            # the rank-0 artifacts: best .pth, resume state, a CSV row
            save_best_checkpoint(cfg, h.model, 1, accs[0])
            save_train_state(os.path.join(ckpt, "resume_state.pth"),
                             h.model, h.optimizer, 1, h.generator)
            csv = CSVLogger(os.path.join(ckpt, "acc.csv"),
                            sentinel=[1000, 1000, 1000])
            csv.write_row(list(accs))
            csv.close()
            files = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
            timed = list(Loader(timed_set, RESNET_BATCH, shuffle=False,
                                drop_last=True, num_workers=4,
                                seed=cfg.random_seed, process_index=rank,
                                process_count=dist.process_count()))
            timed_epoch_ms(h, timed)  # untimed: cuDNN's default algorithms
            ms = [timed_epoch_ms(h, timed) for _ in range(DP_GLOO_ROUNDS)]
            out["arms"][dtype] = dict(
                metrics=[m for m, _ in steps], launches=[c for _, c in steps],
                state_errors=errors, free_metrics=[m for m, _ in free],
                free_launches=[c for _, c in free], digests=digests,
                free_end_as_phase_i=free_end_as_phase_i,
                free_drift=free_drift, accs=list(accs), files=files,
                ms_per_step=ms,
                local_batch=train_loader.local_batch)
            del h
            torch.cuda.empty_cache()
        if job.get("mm_batched"):
            out["mm_batched"] = mm_batched_rank(job["dir"], rank)
    finally:
        with open(os.path.join(job["dir"], f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy()
    return 0


def phase_offsets(failures):
    """#14 at its four mask shapes and #10 / #11's in-kernel masks at
    [64, 392, 512] with 8 heads, at offsets 0 and that of sample 32: the
    bits of the second half computed alone at its offset equal the plain
    version's at that offset and the global batch's second half. Returns
    {kernel: launches made} and the rows."""
    import torch

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import self_attention as sa
    from gdl_tpu_torch.ops.dropout import (
        philox_keep_mask,
        prng_dropout_mask,
        prng_dropout_mask_ref,
    )

    dev = torch.device("cuda")
    kernels.reset_launch_counts()
    rows, problems = [], []
    words = torch.tensor([20261018, -77], dtype=torch.int32, device=dev)
    for (r, c) in MASK_CALLS:
        for dt in (torch.float32, torch.bfloat16):
            half = r // 2  # sample 32 of 64 starts at row r / 2
            offset = half * c
            whole = prng_dropout_mask(words, (r, c), MM_RATE, dt)
            ok = True
            for off, part_rows in ((0, slice(0, half)),
                                   (offset, slice(half, r))):
                part = prng_dropout_mask(words, (half, c), MM_RATE, dt,
                                         offset=off)
                plain = prng_dropout_mask_ref(words, (half, c), MM_RATE, dt,
                                              off)
                ok &= _bit_equal(part, whole[part_rows])
                ok &= _bit_equal(part, plain)
            rows.append({"kernel": MASK, "shape": [r, c], "dtype": str(dt),
                         "offset": offset, "bit_equal": bool(ok)})
            if not ok:
                problems.append(f"{MASK} {(r, c)} {dt}: offset bits differ")
    b, n, ch = OFFSET_SA
    gen = torch.Generator(device=dev).manual_seed(31)
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn((b, n, ch), generator=gen, device=dev) * 0.5).to(dt)
        w = (torch.randn((3 * ch, ch), generator=gen, device=dev)
             * ch ** -0.5).to(dt)
        g = torch.randn((b, n, ch), generator=gen, device=dev).to(dt)
        drop = sa.make_dropout(x, MM_HEADS, MM_RATE, True, "kernel", words)
        out, qkv, p, keep = sa.self_attention_fused_fwd(
            x, w, MM_HEADS, drop=drop, return_keep=True)
        dqkv = sa.self_attention_fused_bwd(qkv, p, g, MM_HEADS, drop=drop)
        half = b // 2
        ok_fwd = ok_bwd = True
        for lo in (0, half):
            sl = slice(lo, lo + half)
            off = lo * MM_HEADS * n * n
            d = sa.make_dropout(x[sl], MM_HEADS, MM_RATE, True, "kernel",
                                words, offset=off)
            o2, q2, p2, k2 = sa.self_attention_fused_fwd(
                x[sl].contiguous(), w, MM_HEADS, drop=d, return_keep=True)
            plain_keep = philox_keep_mask(words, k2.shape, MM_RATE,
                                          off).to(torch.uint8)
            ok_fwd &= (torch.equal(k2, keep[sl]) and torch.equal(k2,
                                                                plain_keep)
                       and _bit_equal(o2, out[sl]) and _bit_equal(p2, p[sl]))
            d2 = sa.self_attention_fused_bwd(q2, p2, g[sl].contiguous(),
                                             MM_HEADS, drop=d)
            ok_bwd &= _bit_equal(d2, dqkv[sl])
        torch.cuda.synchronize()
        for name, ok in ((SA_FWD, ok_fwd), (SA_BWD, ok_bwd)):
            rows.append({"kernel": name, "shape": list(OFFSET_SA),
                         "heads": MM_HEADS, "dtype": str(dt),
                         "offset": half * MM_HEADS * n * n,
                         "bit_equal": bool(ok)})
            if not ok:
                problems.append(f"{name} {dt}: offset bits differ")
    launched = {k: v for k, v in kernels.launch_counts.items() if v}
    emit({"phase": "dp_offsets", "rows": rows, "launches": launched,
          "problems": problems, "ok": not problems})
    failures.extend(f"dp offsets: {p}" for p in problems)
    return launched, rows


def phase_segments(failures):
    """Rank 1 of 2 under --batched_inter 1, whose [3 x 32] stack holds its
    rows of the three passes' global batches: #14 at [3 x 32 x 392, 512]
    and [3 x 32 x 392, 4096], and #10 / #11's in-kernel masks at
    [3 x 32, 392, 512] with 8 heads, in the three-segment layout of
    `element_layout(passes=3)`. Each is bit-equal to its plain version in
    that layout and to rank 1's rows of the global [3 x 64] launch.
    Returns {kernel: launches made} and the rows."""
    import torch

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import self_attention as sa
    from gdl_tpu_torch.ops.dropout import (
        philox_keep_mask,
        prng_dropout_mask,
        prng_dropout_mask_ref,
    )

    dev = torch.device("cuda")
    kernels.reset_launch_counts()
    rows, problems = [], []
    words = torch.tensor([20261018, -77], dtype=torch.int32, device=dev)
    b = MM_BATCH // SEG_WORLD
    mine = torch.cat([torch.arange(p * MM_BATCH + SEG_RANK * b,
                                   p * MM_BATCH + SEG_RANK * b + b,
                                   device=dev) for p in range(3)])

    def layout(per_sample):
        return (SEG_RANK * b * per_sample, b * per_sample,
                MM_BATCH * per_sample)

    note = f"rank {SEG_RANK} of {SEG_WORLD}, three segments"
    for c in SEG_MASK_WIDTHS:
        lay = layout(SEG_TOKENS * c)
        for dt in (torch.float32, torch.bfloat16):
            shape = (3 * b * SEG_TOKENS, c)
            part = prng_dropout_mask(words, shape, MM_RATE, dt, offset=lay)
            ok = _bit_equal(part, prng_dropout_mask_ref(words, shape,
                                                        MM_RATE, dt, lay))
            whole = prng_dropout_mask(words, (3 * MM_BATCH * SEG_TOKENS, c),
                                      MM_RATE, dt)
            ok &= _bit_equal(part.view(3 * b, SEG_TOKENS, c),
                             whole.view(3 * MM_BATCH, SEG_TOKENS, c)[mine])
            del part, whole
            rows.append({"kernel": MASK, "shape": list(shape),
                         "dtype": str(dt), "layout": list(lay),
                         "note": note, "bit_equal": bool(ok)})
            if not ok:
                problems.append(f"{MASK} {shape} {dt}: segment bits differ")
    bl, n, ch = SEG_SA
    lay = layout(MM_HEADS * n * n)
    gen = torch.Generator(device=dev).manual_seed(37)
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn((3 * MM_BATCH, n, ch), generator=gen, device=dev)
             * 0.5).to(dt)
        w = (torch.randn((3 * ch, ch), generator=gen, device=dev)
             * ch ** -0.5).to(dt)
        g = torch.randn((3 * MM_BATCH, n, ch), generator=gen,
                        device=dev).to(dt)
        drop = sa.make_dropout(x, MM_HEADS, MM_RATE, True, "kernel", words)
        out, qkv, p, keep = sa.self_attention_fused_fwd(
            x, w, MM_HEADS, drop=drop, return_keep=True)
        dqkv = sa.self_attention_fused_bwd(qkv, p, g, MM_HEADS, drop=drop)
        d = sa.make_dropout(x[mine], MM_HEADS, MM_RATE, True, "kernel",
                            words, offset=lay)
        o2, q2, p2, k2 = sa.self_attention_fused_fwd(
            x[mine].contiguous(), w, MM_HEADS, drop=d, return_keep=True)
        plain_keep = philox_keep_mask(words, k2.shape, MM_RATE,
                                      lay).to(torch.uint8)
        ok_fwd = (torch.equal(k2, keep[mine]) and torch.equal(k2, plain_keep)
                  and _bit_equal(o2, out[mine]) and _bit_equal(p2, p[mine]))
        d2 = sa.self_attention_fused_bwd(q2, p2, g[mine].contiguous(),
                                         MM_HEADS, drop=d)
        ok_bwd = _bit_equal(d2, dqkv[mine])
        torch.cuda.synchronize()
        del x, g, out, qkv, p, keep, dqkv, o2, q2, p2, k2, d2, plain_keep
        for name, ok in ((SA_FWD, ok_fwd), (SA_BWD, ok_bwd)):
            rows.append({"kernel": name, "shape": [bl, n, ch],
                         "heads": MM_HEADS, "dtype": str(dt),
                         "layout": list(lay), "note": note,
                         "bit_equal": bool(ok)})
            if not ok:
                problems.append(f"{name} {dt}: segment bits differ")
    torch.cuda.empty_cache()
    launched = {k: v for k, v in kernels.launch_counts.items() if v}
    emit({"phase": "dp_segments", "rows": rows, "launches": launched,
          "problems": problems, "ok": not problems})
    failures.extend(f"dp segments: {p}" for p in problems)
    return launched, rows


def mm_batched_config(ckpt: str, **kw):
    """Phase k's mmformer_n configuration (batch 64 global), float32."""
    from gdl_tpu_torch.config import Config

    return Config(dataset="CREMAD", fps=1, batch_size=MM_BATCH,
                  modulation="Normal", log_grad_csv=False,
                  compute_dtype="float32", ckpt_path=ckpt,
                  encoder_width=RESNET_WIDTH, **kw)


def mm_batched_harness(cfg, batched_inter: bool = True):
    """Phase k's mmformer_n (shared streams) with --batched_inter 1 (or
    without), built through main_intermediate from phase k's seed."""
    from gdl_tpu_torch import main_intermediate

    model, kind = main_intermediate.build_model(
        "mmformer_n", cfg.n_classes, cfg.encoder_width, share_streams=True,
        batched_inter=batched_inter, seed=777)
    return main_intermediate.build_harness(cfg, model, kind,
                                           steps_per_epoch=100)


def mm_batched_set(cfg):
    """One global batch of phase k's training data."""
    from gdl_tpu_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(cfg, size=MM_BATCH, seed=1500)


def mm_batched_reference(tmp: str, batched_inter: bool = True,
                         tag: str = "mm", timed_steps: int = 0) -> dict:
    """One process's step of mmformer_n under --batched_inter 1 (or
    without) on the global batch (cuDNN deterministic): saves its state
    before the step for the ranks (<tag>_snap.pt) and the state after
    (<tag>_ref.pt); returns the step's metrics and launches, and with
    `timed_steps` the ms of that many more steps on the batch, one by one,
    and their median."""
    import torch

    from gdl_tpu_torch.data.loader import Loader

    cfg = mm_batched_config(tmp, num_workers=8)
    h = mm_batched_harness(cfg, batched_inter)
    torch.save(train_snapshot(h), os.path.join(tmp, f"{tag}_snap.pt"))
    bare = h.train_step
    steps = recorded_steps(h)
    batches = list(Loader(mm_batched_set(cfg), MM_BATCH, shuffle=True,
                          drop_last=True, num_workers=8, seed=cfg.random_seed))
    checked_epoch(h, batches)
    n = len(steps)
    torch.save({k: v.detach().cpu().clone()
                for k, v in h.model.state_dict().items()},
               os.path.join(tmp, f"{tag}_ref.pt"))
    h.train_step = bare  # timed without the recording's host syncs
    times = step_ms(h, batches * timed_steps)
    del h
    torch.cuda.empty_cache()
    return {"metrics": [m for m, _ in steps[:n]],
            "launches": [c for _, c in steps[:n]], "step_ms": times,
            "ms_per_step": statistics.median(times) if times else None}


def mm_batched_rank(job_dir: str, rank: int, batched_inter: bool = True,
                    tag: str = "mm", **kw) -> dict:
    """A rank's step of mm_batched_reference's, from its state before the
    step, on the rank's rows of the global batch (`kw`: --dp / --mp):
    metrics, launches, the (parameters, BN statistics) max |d| of its
    whole state against the state after; under `kw` also the ms of
    MP_MM_TIMED_STEPS more steps on the same batch, one by one, their
    median and its peak memory."""
    import torch

    from gdl_tpu_torch.parallel.row_parallel import full_state_dict
    from gdl_tpu_torch.train.loop import make_loaders

    cfg = mm_batched_config(os.path.join(job_dir, f"{tag}_rank{rank}"),
                            num_workers=4, device="cuda:0", **kw)
    torch.cuda.reset_peak_memory_stats()
    h = mm_batched_harness(cfg, batched_inter)
    restore_snapshot(h, torch.load(
        os.path.join(job_dir, f"{tag}_snap.pt"), weights_only=False))
    bare = h.train_step
    steps = recorded_steps(h)
    loader, _ = make_loaders(cfg, mm_batched_set(cfg), mm_batched_set(cfg))
    batches = list(loader)
    checked_epoch(h, batches)
    n = len(steps)
    errors = state_errors(full_state_dict(h.model), torch.load(
        os.path.join(job_dir, f"{tag}_ref.pt"), weights_only=False))
    h.train_step = bare  # timed without the recording's host syncs
    times = step_ms(h, batches * MP_MM_TIMED_STEPS) if kw else []
    del h
    torch.cuda.empty_cache()
    return {"metrics": [m for m, _ in steps[:n]],
            "launches": [c for _, c in steps[:n]], "state_errors": errors,
            "local_batch": loader.local_batch, "step_ms": times,
            "ms_per_step": statistics.median(times) if times else None,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def mm_batched_check(ref: dict, ranks: list, problems: list) -> dict:
    """The ranks' step against one process's at phase k's float32 bars:
    losses (the mean of the ranks' row means) and gradient norm relative,
    parameters and BN statistics absolute; the ranks alike; exactly
    MM_BATCHED_LAUNCHES a step in the process and a rank-step in each."""
    if None in ranks:
        problems.append("mm batched: no result from a rank")
        return {}
    r0, r1 = ranks
    launches = [{k: v for k, v in c.items() if v} for c in
                ref["launches"] + r0["launches"] + r1["launches"]]
    if len(launches) != 3 or any(c != MM_BATCHED_LAUNCHES for c in launches):
        problems.append(f"mm batched: launches {launches}")
    worst = 0.0
    for key in ("loss", "loss_a", "loss_v", "loss_f", "grad_norm"):
        m0, m1, m = r0["metrics"][0], r1["metrics"][0], ref["metrics"][0]
        got = m0[key] if key == "grad_norm" else (m0[key] + m1[key]) / 2
        worst = max(worst, abs(got - m[key]) / max(abs(m[key]), 1e-12))
    if r0["metrics"][0]["grad_norm"] != r1["metrics"][0]["grad_norm"]:
        problems.append("mm batched: the ranks' gradient norms differ")
    if worst > MM_LOSS_RTOL["float32"]:
        problems.append(f"mm batched: losses differ by {worst} relative")
    param_err = max(r0["state_errors"][0], r1["state_errors"][0])
    stat_err = max(r0["state_errors"][1], r1["state_errors"][1])
    if r0["state_errors"] != r1["state_errors"]:
        problems.append("mm batched: the ranks' states differ")
    if param_err > MM_PARAM_ATOL:
        problems.append(f"mm batched: parameters differ by {param_err}")
    if stat_err > MM_STAT_ATOL["float32"]:
        problems.append(f"mm batched: BN running stats differ by {stat_err}")
    return {"max_rel_loss_diff": worst, "loss_rtol": MM_LOSS_RTOL["float32"],
            "max_abs_param_diff": param_err, "param_atol": MM_PARAM_ATOL,
            "max_abs_bn_stat_diff": stat_err,
            "bn_stat_atol": MM_STAT_ATOL["float32"],
            "rank_batch": r0["local_batch"],
            "launches_per_step": launches[:1],
            "launches_per_rank_step": launches[1:]}


def phase_distributed(failures, smi: str, refs: dict):
    """The flagship ResNet-18 DGL trainer data-parallel (phase i's config):
    1. world size 1 under NCCL from torchrun's variables: 3 checked steps
       bit-equal to phase i's kernel arm (`refs`), 2 launches of #16 a
       step, no collective in the steps; then timed steps in turns with a
       harness built before the process group existed, and with one whose
       BatchNorms take the multi-rank path (`global_forward`); a profile
       of a step of it and of the world-1 arm;
    2. two ranks on the one card over gloo (two processes, batch 32
       each): the 3 checked steps, each from phase i's kernel arm's state
       before it, against that arm's step at phase i's bars (losses and
       gradient norm, then the parameters and BN statistics after it);
       3 free steps, the ranks' states equal by digest, the generator and
       step count at the end phase i's, each step replayed by one process
       from the ranks' state before it at the same bars
       (`replay_free_steps`); 2 launches of #16 a rank-step, one evaluate
       with equal accuracies, no file written by rank 1, ms/step;
    3. the element offsets of #14, #10 and #11 (`phase_offsets`), and
       their three-segment layout under --batched_inter 1
       (`phase_segments`);
    4. phase k's mmformer_n under --batched_inter 1 over the same two
       ranks: one step from one process's state before it, against that
       process's step at phase k's float32 bars, MM_BATCHED_LAUNCHES a
       rank-step (`mm_batched_check`).
    Returns {"world1": launches a step, "gloo": launches a rank-step,
    "offsets" and "segments": (launches, rows), "mm_batched": launches a
    rank-step}."""
    import torch
    import torch.distributed as tdist

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.data.loader import Loader
    from gdl_tpu_torch.models.layers import GlobalBatchNorm2d
    from gdl_tpu_torch.parallel import distributed as dist
    from gdl_tpu_torch.serve import build_model
    from gdl_tpu_torch.train.loop import build_harness

    want_step = dict({k: 0 for k in kernels.launch_counts}, **{POOL: 2})
    result = {"world1": [], "gloo": []}
    calls = {k: 0 for k in COLLECTIVES}
    originals = {k: getattr(tdist, k) for k in COLLECTIVES}

    def counting(name):
        def call(*args, **kw):
            calls[name] += 1
            return originals[name](*args, **kw)
        return call

    # 1. world size 1 under NCCL
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": ""}
    saved_env = {k: os.environ.get(k) for k in env}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for dtype in ("float32", "bfloat16"):
                problems = []
                cfg = resnet_dp_config(dtype, tmp, num_workers=8)
                train_set, _, timed_set = resnet_dp_sets(cfg)

                def loader(ds, shuffle):
                    return Loader(ds, RESNET_BATCH, shuffle=shuffle,
                                  drop_last=True, num_workers=8,
                                  seed=cfg.random_seed)

                # the one-process arm, built before the group exists
                one = build_harness(cfg, build_model(cfg, seed=777),
                                    steps_per_epoch=100)
                os.environ.update(env, MASTER_PORT=str(_free_port()))
                if not dist.maybe_initialize():
                    raise RuntimeError("no process group from torchrun's "
                                       "variables")
                backend = tdist.get_backend()
                h = build_harness(cfg, build_model(cfg, seed=777),
                                  steps_per_epoch=100)
                steps = recorded_steps(h)
                for k in COLLECTIVES:
                    calls[k] = 0
                    setattr(tdist, k, counting(k))
                try:
                    checked_epoch(h, loader(train_set, True))
                finally:
                    for k in COLLECTIVES:
                        setattr(tdist, k, originals[k])
                step_calls = dict(calls)
                ref = refs.get(dtype)
                if ref is None:
                    problems.append("no phase i reference")
                else:
                    for i, ((m, _), r) in enumerate(zip(steps,
                                                        ref["metrics"])):
                        for key in ("loss", "loss_f", "loss_a", "loss_v",
                                    "grad_norm"):
                            if m[key] != r[key]:
                                problems.append(f"step {i} {key}: {m[key]}"
                                                f" != phase i's {r[key]}")
                    for k, v in h.model.state_dict().items():
                        if not torch.equal(v.detach().cpu(), ref["state"][k]):
                            problems.append(f"{k} differs from phase i's")
                            break
                launches = [c for _, c in steps]
                n_checked = len(steps)
                result["world1"] += launches
                if len(steps) != DP_CHECKED_STEPS:
                    problems.append(f"{len(steps)} steps ran")
                if any(c != want_step for c in launches):
                    problems.append(f"launches a step {launches}")
                if any(step_calls.values()):
                    problems.append(f"collectives in the steps {step_calls}")
                # timing, the arms in turns; the third normalises through
                # the multi-rank BatchNorm, whose all-reduces are no-ops
                g = build_harness(cfg, build_model(cfg, seed=777),
                                  steps_per_epoch=100)
                for m in g.model.modules():
                    if isinstance(m, GlobalBatchNorm2d):
                        m.forward = m.global_forward
                timed = list(loader(timed_set, False))
                arms = {"one_process": one, "world1": h,
                        "world1_global_bn": g}
                for arm in arms.values():  # untimed: cuDNN's defaults
                    timed_epoch_ms(arm, timed)
                ms = {k: [] for k in arms}
                order = list(arms)
                for r in range(DP_TIME_ROUNDS):
                    for k in (order if r % 2 == 0 else order[::-1]):
                        ms[k].append(timed_epoch_ms(arms[k], timed))
                med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
                prof = {k: profiled_epoch(arms[k], timed[:2])
                        for k in ("world1", "world1_global_bn")}
                emit({"phase": "dp_world1", "dtype": dtype,
                      "backend": backend, "batch": RESNET_BATCH,
                      "checked_steps": n_checked,
                      "bit_equal_to_phase_i": not problems,
                      "launches_per_step": [c[POOL] for c in launches],
                      "collectives_in_steps": step_calls,
                      "ms_per_step": med, "timed_ms_per_step": ms,
                      "profile": prof, "nvidia_smi": smi,
                      "problems": problems,
                      "ok": not problems})
                failures.extend(f"dp world1 {dtype}: {p}" for p in problems)
                dist.destroy()
                del one, h, g, arms
                torch.cuda.empty_cache()
        finally:
            for k in COLLECTIVES:
                setattr(tdist, k, originals[k])
            dist.destroy()
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    # 2. two ranks on the one card over gloo. The flagship's trajectory is
    # too sensitive to hold two different summation orders together for
    # three free steps (weights one ulp up move the one-process run's
    # parameters ~8e-4 in three), so every step is checked from the state
    # it started from: phase i's for the checked steps, the ranks' own
    # for the free steps, whose rank agreement is exact (digests)
    with tempfile.TemporaryDirectory() as tmp:
        for dtype, ref in refs.items():
            snaps = ref["snapshots"] + [{
                "model": ref["state"], "generator": ref["generator"],
                "steps": ref["steps"]}]
            for k, snap in enumerate(snaps):
                torch.save(snap, os.path.join(tmp, f"snap_{dtype}_{k}.pt"))
        # part 4's one-process step, whose state before it the ranks take
        mm_ref = mm_batched_reference(tmp)
        wenv = dict(os.environ, WORLD_SIZE=str(DP_RANKS),
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        spec = json.dumps({"dir": tmp, "mm_batched": True})
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp_worker", spec],
            env=dict(wenv, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DP_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=400)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        worker_s = time.perf_counter() - t
        problems = []
        if any(p.returncode for p in procs):
            problems.append(f"workers exited {[p.returncode for p in procs]}"
                            f": {outs[0][-1500:]} {outs[1][-1500:]}")
        ranks = []
        for r in range(DP_RANKS):
            path = os.path.join(tmp, f"rank{r}.json")
            ranks.append(json.load(open(path)) if os.path.exists(path)
                         else {"arms": {}})
        for dtype in ("float32", "bfloat16"):
            arms = [rk["arms"].get(dtype) for rk in ranks]
            ref = refs.get(dtype)
            if None in arms or ref is None:
                problems.append(f"{dtype}: no result")
                continue
            a0, a1 = arms
            launches = a0["launches"] + a1["launches"]
            result["gloo"] += launches
            if (len(a0["launches"]) != DP_CHECKED_STEPS
                    or any(c != want_step for c in launches)):
                problems.append(f"{dtype}: launches a rank-step {launches}")
            worst = 0.0
            # each rank's loss is its rows' mean: the global one is their
            # mean; grad_norm is the global gradient's already
            losses = [(m0["loss"] + m1["loss"]) / 2
                      for m0, m1 in zip(a0["metrics"], a1["metrics"])]
            for i, (m0, m1, r) in enumerate(zip(a0["metrics"],
                                                a1["metrics"],
                                                ref["metrics"])):
                for key, got in (("loss", losses[i]),
                                 ("grad_norm", m0["grad_norm"])):
                    worst = max(worst, abs(got - r[key]) / abs(r[key]))
                if m0["grad_norm"] != m1["grad_norm"]:
                    problems.append(f"{dtype} step {i}: the ranks' gradient "
                                    f"norms differ")
            if worst > RESNET_LOSS_RTOL[dtype]:
                problems.append(f"{dtype}: losses differ by {worst} relative")
            errs = a0["state_errors"] + a1["state_errors"]
            param_err = max((e[0] for e in errs), default=float("inf"))
            stat_err = max((e[1] for e in errs), default=float("inf"))
            if a0["state_errors"] != a1["state_errors"]:
                problems.append(f"{dtype}: the ranks' states differ")
            if dtype == "float32" and param_err > RESNET_PARAM_ATOL:
                problems.append(f"{dtype}: parameters differ by {param_err}")
            if stat_err > RESNET_STAT_ATOL[dtype]:
                problems.append(f"{dtype}: BN running stats differ by "
                                f"{stat_err}")
            # the free steps: exact agreement of the ranks, and each step
            # against one process's step from the same state
            free_launches = a0["free_launches"] + a1["free_launches"]
            if (len(a0["free_launches"]) != DP_CHECKED_STEPS
                    or any(c != want_step for c in free_launches)):
                problems.append(f"{dtype}: free launches a rank-step "
                                f"{free_launches}")
            if (a0["digests"] != a1["digests"]
                    or len(a0["digests"]) != DP_CHECKED_STEPS + 1):
                problems.append(f"{dtype}: the ranks' states differ in the "
                                f"free steps")
            if not (a0["free_end_as_phase_i"] and a1["free_end_as_phase_i"]):
                problems.append(f"{dtype}: generator or step count after the "
                                f"free steps differ from phase i's")
            free_losses = [(m0["loss"] + m1["loss"]) / 2 for m0, m1 in
                           zip(a0["free_metrics"], a1["free_metrics"])]
            replay = replay_free_steps(dtype, os.path.join(tmp,
                                                           f"free_{dtype}"))
            replay_worst = 0.0
            for got, m0, r in zip(free_losses, a0["free_metrics"],
                                  replay["metrics"]):
                for key, v in (("loss", got), ("grad_norm", m0["grad_norm"])):
                    replay_worst = max(replay_worst,
                                       abs(v - r[key]) / abs(r[key]))
            replay_param = max((e[0] for e in replay["errors"]),
                               default=float("inf"))
            replay_stat = max((e[1] for e in replay["errors"]),
                              default=float("inf"))
            if len(replay["errors"]) != DP_CHECKED_STEPS:
                problems.append(f"{dtype}: {len(replay['errors'])} free "
                                f"steps replayed")
            if replay_worst > RESNET_LOSS_RTOL[dtype]:
                problems.append(f"{dtype}: free steps' losses differ from "
                                f"the replay by {replay_worst} relative")
            if dtype == "float32" and replay_param > RESNET_PARAM_ATOL:
                problems.append(f"{dtype}: free steps' parameters differ "
                                f"from the replay by {replay_param}")
            if replay_stat > RESNET_STAT_ATOL[dtype]:
                problems.append(f"{dtype}: free steps' BN running stats "
                                f"differ from the replay by {replay_stat}")
            if a0["accs"] != a1["accs"]:
                problems.append(f"{dtype}: accuracies {a0['accs']} != "
                                f"{a1['accs']}")
            if a1["files"] or not a0["files"]:
                problems.append(f"{dtype}: rank 0 wrote {a0['files']}, rank "
                                f"1 {a1['files']}")
            emit({"phase": "dp_gloo", "dtype": dtype, "ranks": DP_RANKS,
                  "device": "cuda:0", "backend": "gloo",
                  "batch": RESNET_BATCH, "rank_batch": a0["local_batch"],
                  "max_rel_loss_diff": worst,
                  "loss_rtol": RESNET_LOSS_RTOL[dtype],
                  "loss": losses,
                  "phase_i_loss": [m["loss"] for m in ref["metrics"]],
                  "grad_norm": [m["grad_norm"] for m in a0["metrics"]],
                  "phase_i_grad_norm": [m["grad_norm"]
                                        for m in ref["metrics"]],
                  "max_abs_param_diff": param_err,
                  "max_abs_bn_stat_diff": stat_err,
                  "launches_per_rank_step": [c[POOL] for c in launches],
                  "free_loss": free_losses,
                  "free_grad_norm": [m["grad_norm"]
                                     for m in a0["free_metrics"]],
                  "free_launches_per_rank_step": [c[POOL]
                                                  for c in free_launches],
                  "free_digests_equal": a0["digests"] == a1["digests"],
                  "free_end_as_phase_i": [a0["free_end_as_phase_i"],
                                          a1["free_end_as_phase_i"]],
                  "free_replay_max_rel_loss_diff": replay_worst,
                  "free_replay_max_abs_param_diff": replay_param,
                  "free_replay_max_abs_bn_stat_diff": replay_stat,
                  "free_drift_from_phase_i": a0["free_drift"],
                  "accs": [a0["accs"], a1["accs"]],
                  "files": [a0["files"], a1["files"]],
                  "ms_per_step": [a0["ms_per_step"], a1["ms_per_step"]],
                  "ms_note": "gloo stages every collective through the "
                             "host: no yardstick for NCCL",
                  "workers_s": worker_s, "nvidia_smi": smi})
        emit({"phase": "dp_gloo_check", "problems": problems,
              "ok": not problems})
        failures.extend(f"dp gloo: {p}" for p in problems)

        # 4. mmformer_n under --batched_inter 1 over the two ranks
        mm_problems = []
        mm = mm_batched_check(mm_ref, [rk.get("mm_batched") for rk in ranks],
                              mm_problems)
        result["mm_batched"] = mm.get("launches_per_rank_step", [])
        result["mm_batched_check"] = dict(
            {"phase": "dp_mm_batched", "ranks": DP_RANKS,
             "device": "cuda:0", "backend": "gloo", "batch": MM_BATCH,
             "dtype": "float32",
             "loss": [m["loss"] for m in mm_ref["metrics"]],
             "nvidia_smi": smi}, **mm, problems=mm_problems,
            ok=not mm_problems)
        emit(result["mm_batched_check"])
        failures.extend(f"dp mm batched: {p}" for p in mm_problems)

    # 3. the offsets, and the three-segment layout of --batched_inter 1
    result["offsets"] = phase_offsets(failures)
    result["segments"] = phase_segments(failures)
    return result


def phase_profile(failures, smi: str) -> dict:
    """--profile_dir on phase i's flagship (float32, batch 64) through
    build_harness and train_one_epoch: a warm-up epoch (epoch 1, not
    traced), epoch 0 of PROFILE_STEPS steps with cfg.profile_dir set, then
    epoch 1 again. One trace file, written in epoch 0; exactly three
    `train_step` spans in it, and #16's kernel exactly twice a traced step
    among its CUDA kernel events (the profiler sees the kernels launched
    through ctypes); the traced and the untraced epoch's ms/step beside
    each other (no bar). Returns the line it prints."""
    import glob

    import torch

    from gdl_tpu_torch.data.loader import Loader
    from gdl_tpu_torch.data.synthetic import SyntheticDataset
    from gdl_tpu_torch.serve import build_model
    from gdl_tpu_torch.train.loop import build_harness, train_one_epoch

    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        prof_dir = os.path.join(tmp, "profile")
        cfg = resnet_dp_config("float32", tmp, num_workers=8,
                               profile_dir=prof_dir)
        batches = list(Loader(
            SyntheticDataset(cfg, size=RESNET_BATCH * PROFILE_STEPS,
                             seed=3000), RESNET_BATCH, shuffle=False,
            drop_last=True, num_workers=8, seed=cfg.random_seed))
        h = build_harness(cfg, build_model(cfg, seed=777),
                          steps_per_epoch=PROFILE_STEPS)

        def epoch_ms(epoch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with quiet():
                train_one_epoch(h, batches, epoch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3 / len(batches)

        epoch_ms(1)  # warm-up: cuDNN's algorithms, the allocator
        if os.path.exists(prof_dir):
            problems.append("an epoch other than 0 wrote a trace")
        traced = epoch_ms(0)
        written = sorted(glob.glob(os.path.join(prof_dir, "*")))
        untraced = epoch_ms(1)
        files = sorted(glob.glob(os.path.join(prof_dir, "*")))
        if len(files) != 1 or files != written:
            problems.append(f"trace files {files} (after epoch 0: "
                            f"{written})")
        spans = pool = kernel_events = gpu_spans = 0
        size = 0
        if files:
            size = os.path.getsize(files[0])
            with open(files[0]) as f:
                events = json.load(f)["traceEvents"]
            for e in events:
                name, cat = e.get("name", ""), e.get("cat", "")
                spans += name == "train_step" and cat == "user_annotation"
                gpu_spans += (name == "train_step"
                              and cat == "gpu_user_annotation")
                if cat == "kernel":
                    kernel_events += 1
                    pool += "maxpool_bwd_kernel" in name
        if spans != PROFILE_SPANS:
            problems.append(f"{spans} train_step spans")
        if pool != PROFILE_POOL_EVENTS:
            problems.append(f"{pool} events of #16's kernel")
        del h
        torch.cuda.empty_cache()
    result = {"phase": "profile", "batch": RESNET_BATCH, "dtype": "float32",
              "steps_per_epoch": len(batches), "traced_steps": [10, 11, 12],
              "trace_files": [os.path.basename(f) for f in files],
              "trace_bytes": size, "train_step_spans": spans,
              "gpu_train_step_spans": gpu_spans,
              "kernel_events": kernel_events, "pool_kernel_events": pool,
              "traced_epoch_ms_per_step": traced,
              "untraced_epoch_ms_per_step": untraced, "nvidia_smi": smi,
              "problems": problems, "ok": not problems}
    emit(result)
    failures.extend(f"profile: {p}" for p in problems)
    return result


def replay_free_steps(dtype: str, free_dir: str) -> dict:
    """One process replays each of the two ranks' free steps on its global
    batch, from their state before it (free_dir/<k>.pt, saved by rank 0):
    {"metrics": each step's, "errors": (parameters, BN statistics) max
    |Δ| against the ranks' state after it}."""
    import torch

    from gdl_tpu_torch.data.loader import Loader
    from gdl_tpu_torch.serve import build_model
    from gdl_tpu_torch.train.loop import build_harness

    def load(k):
        return torch.load(os.path.join(free_dir, f"{k}.pt"),
                          weights_only=False)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = resnet_dp_config(dtype, tmp, num_workers=8)
        h = build_harness(cfg, build_model(cfg, seed=777),
                          steps_per_epoch=100)
        steps = recorded_steps(h)
        errors, state = [], load(0)
        for k, batch in enumerate(Loader(
                resnet_dp_sets(cfg)[0], RESNET_BATCH, shuffle=True,
                drop_last=True, num_workers=8, seed=cfg.random_seed)):
            restore_snapshot(h, state)
            checked_epoch(h, [batch])
            state = load(k + 1)
            errors.append(state_errors(h.model, state["model"]))
        del h
        torch.cuda.empty_cache()
    return {"metrics": [m for m, _ in steps], "errors": errors}


MP_SIZE = 2           # phase t: the model group of every arm
MP_FLAGSHIP_RANKS = 4  # the flagship's grid, --dp 2 --mp 2
MP_SWIN_BATCH = 16
MP_TIMED_STEPS = 3     # phase t's steps timed one by one after the checked
MP_MM_TIMED_STEPS = 1  # ones (their median); mmformer_n's take seconds
MP_GO = "mp_go"        # phase t's references are written: "ok" or "failed"
# a rank-step of phase t's arms: the flagship's (its stems), dual Swin-B
# with --fuse_mlp 1 (2 encoders x 24 blocks; #2 and #4 of the default
# attention beside it) and mmformer_n's
MP_FLAGSHIP_LAUNCHES = {POOL: 2}
MP_SWIN_LAUNCHES = {MLP: 48, SAVEP: 48, BWD: 48}
MP_MM_LAUNCHES = MM_STEP_LAUNCHES


def replicated_digest(model) -> str:
    """sha256 of every state tensor of `model` that is not a row-parallel
    shard: equal on every rank where the replicas agree bit for bit."""
    import hashlib

    import torch

    from gdl_tpu_torch.parallel.row_parallel import is_sharded

    shards = {id(p) for p in model.parameters() if is_sharded(p)}
    digest = hashlib.sha256()
    for name, v in model.state_dict(keep_vars=True).items():
        if id(v) in shards:
            continue
        digest.update(name.encode())
        digest.update(v.detach().cpu().contiguous().reshape(-1)
                      .view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def mp_swin_config(**kw):
    """Phase m's dual Swin-B (VGGSound, fps 1) with --fuse_mlp 1, float32,
    batch MP_SWIN_BATCH."""
    from gdl_tpu_torch.config import Config

    return Config(dataset="VGGSound", backbone="swin",
                  fusion_method="concat", modality="full", fps=1,
                  batch_size=MP_SWIN_BATCH, log_grad_csv=False,
                  compute_dtype="float32", fuse_mlp=True, **kw)


def mp_swin_step(cfg, tmp: str, reference: bool = False) -> dict:
    """One checked step of phase t's Swin-B arm from phase m's seed on one
    synthetic batch (each rank takes all of it: --dp 1): metrics and
    launches; the one-process `reference` saves its whole state after
    the step (mp_swin_ref.pt under `tmp`), a rank holds its whole state
    to that one (`state_errors`). Then the ms of MP_TIMED_STEPS more
    bare steps, one by one, their median, peak memory and the seconds of
    each part."""
    import torch

    from gdl_tpu_torch.data.synthetic import synthetic_batch
    from gdl_tpu_torch.parallel.row_parallel import full_state_dict
    from gdl_tpu_torch.serve import build_model
    from gdl_tpu_torch.train.loop import build_harness

    clock = Stopwatch()
    torch.cuda.reset_peak_memory_stats()
    h = build_harness(cfg, build_model(cfg, seed=4321), steps_per_epoch=100)
    batch = synthetic_batch(cfg, MP_SWIN_BATCH, seed=310)
    clock.lap("build")
    bare = h.train_step
    steps = recorded_steps(h)
    checked_epoch(h, [batch])
    clock.lap("checked")
    state = {k: v.detach().cpu() for k, v in full_state_dict(h.model).items()}
    path = os.path.join(tmp, "mp_swin_ref.pt")
    errors = None
    if reference:
        torch.save(state, path)
    else:
        errors = state_errors(state, torch.load(path))
    del state
    clock.lap("state")
    h.train_step = bare  # timed without the recording's host syncs
    times = step_ms(h, [batch] * MP_TIMED_STEPS)
    clock.lap("timed")
    out = {"metrics": [m for m, _ in steps[:1]],
           "launches": [c for _, c in steps[:1]], "state_errors": errors,
           "step_ms": times, "ms_per_step": statistics.median(times),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "seconds": clock.laps}
    del h
    torch.cuda.empty_cache()
    return out


class Stopwatch:
    """Seconds of each named part of a run, in order."""

    def __init__(self):
        self.laps, self._t = {}, time.perf_counter()

    def lap(self, name: str) -> None:
        t = time.perf_counter()
        self.laps[name] = self.laps.get(name, 0.0) + t - self._t
        self._t = t


def mp_flagship_rank(job_dir: str, rank: int) -> dict:
    """A rank of phase t's flagship arms (--dp 2 --mp 2, batch 64 global):
    per dtype 3 checked steps, each from phase i's kernel arm's state
    before it (sliced to this rank's shards), the whole state after it
    against phase i's next one; the replicated tensors' digest after
    each; whether this rank's fc_out shard is its columns of phase i's
    weight, bit for bit; rank 0's best .pth (written whole) and each
    rank's shard beside it; the ms of bare steps on the checked batches,
    one by one, their median, peak memory and the seconds of each
    part."""
    import torch

    from gdl_tpu_torch.parallel import mesh
    from gdl_tpu_torch.parallel.row_parallel import full_state_dict
    from gdl_tpu_torch.serve import build_model
    from gdl_tpu_torch.train.loop import build_harness, make_loaders
    from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint

    arms = {}
    for dtype in ("float32", "bfloat16"):
        clock = Stopwatch()
        cfg = resnet_dp_config(dtype, os.path.join(job_dir, f"mp{rank}"),
                               num_workers=2, device="cuda:0",
                               dp=MP_FLAGSHIP_RANKS // MP_SIZE, mp=MP_SIZE)
        train_set, test_set, _ = resnet_dp_sets(cfg)
        train_loader, _ = make_loaders(cfg, train_set, test_set)
        batches = list(train_loader)
        torch.cuda.reset_peak_memory_stats()
        h = build_harness(cfg, build_model(cfg, seed=777),
                          steps_per_epoch=100)
        fc = h.model.fusion_module.fc_out
        snaps = [torch.load(os.path.join(job_dir, f"snap_{dtype}_{k}.pt"),
                            weights_only=False)
                 for k in range(DP_CHECKED_STEPS + 1)]
        restore_snapshot(h, snaps[0])
        whole = snaps[0]["model"]["fusion_module.fc_out.weight"]
        shard_exact = torch.equal(fc.weight.detach().cpu(),
                                  fc.shard_of(whole))
        clock.lap("build")
        bare = h.train_step
        log = recorded_steps(h)
        errors, digests = [], []
        for k, batch in enumerate(batches):
            restore_snapshot(h, snaps[k])
            checked_epoch(h, [batch])
            errors.append(state_errors(full_state_dict(h.model),
                                       snaps[k + 1]["model"]))
            digests.append(replicated_digest(h.model))
        del snaps
        h.train_step = bare  # timed without the recording's host syncs
        steps = list(log)
        clock.lap("checked")
        torch.save(fc.weight.detach().cpu(),
                   os.path.join(job_dir, f"mp_shard_{dtype}_{rank}.pt"))
        save_best_checkpoint(cfg, h.model, 1, 0.5, path=os.path.join(
            job_dir, f"mp_best_{dtype}.pth"))
        clock.lap("pth")
        times = step_ms(h, batches[:MP_TIMED_STEPS])
        clock.lap("timed")
        arms[dtype] = dict(
            metrics=[m for m, _ in steps], launches=[c for _, c in steps],
            state_errors=errors, digests=digests, shard_exact=shard_exact,
            shard_columns=[fc.index * fc.weight.shape[1],
                           (fc.index + 1) * fc.weight.shape[1]],
            coords=[mesh.data_index(), mesh.model_index()],
            step_ms=times, ms_per_step=statistics.median(times),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            local_batch=train_loader.local_batch, seconds=clock.laps)
        del h
        torch.cuda.empty_cache()
    return arms


def mp_worker(spec: str) -> int:
    """One rank of phase t's gloo run on the one card (torchrun's
    variables set by the parent): the flagship on four ranks
    (`mp_flagship_rank`); then ranks 0 and 1 leave that process group for
    one of two (spec's "port2"), --mp 2, and run the Swin-B step of
    `mp_swin_step` and the mmformer_n step of `mm_batched_rank`; ranks 2
    and 3 end. Writes its results as JSON under spec's "dir"."""
    import torch

    from gdl_tpu_torch.parallel import distributed as dist
    from gdl_tpu_torch.parallel import mesh

    job = json.loads(spec)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.maybe_initialize(backend="gloo")
    mesh.init_grid(MP_SIZE)  # every arm's --mp, before its loaders
    rank = dist.process_index()
    out = {"rank": rank, "world": dist.process_count(),
           "start_s": time.time() - job["t0"]}  # its launch to its grid
    try:
        go, deadline = os.path.join(job["dir"], MP_GO), time.time() + 300
        while not os.path.exists(go) and time.time() < deadline:
            time.sleep(0.05)  # the parent's references, made meanwhile
        if not os.path.exists(go) or open(go).read() != "ok":
            raise RuntimeError("phase t's one-process references failed")
        out["wait_s"] = time.time() - job["t0"] - out["start_s"]
        t = time.perf_counter()
        out["arms"] = mp_flagship_rank(job["dir"], rank)
        dist.destroy()
        out["flagship_s"] = time.perf_counter() - t
        if rank < MP_SIZE:
            t = time.perf_counter()
            os.environ.update(WORLD_SIZE=str(MP_SIZE),
                              MASTER_PORT=str(job["port2"]))
            dist.maybe_initialize(backend="gloo")
            mesh.init_grid(MP_SIZE)
            out["regroup_s"] = time.perf_counter() - t
            grid = dict(dp=1, mp=MP_SIZE)
            out["swin"] = mp_swin_step(
                mp_swin_config(device="cuda:0", **grid), job["dir"])
            t = time.perf_counter()
            out["mm"] = mm_batched_rank(job["dir"], rank, batched_inter=False,
                                        tag="mmp", **grid)
            out["mm"]["seconds"] = time.perf_counter() - t
    finally:
        with open(os.path.join(job["dir"], f"mp_rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy()
    return 0


def mp_launch(tmp: str, world: int, before=None, timeout: int = 500):
    """Run `world` ranks of mp_worker, calling `before()` while they start
    (their work waits for it) → (their JSON results, None for a rank that
    wrote none; problems; seconds)."""
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    spec = json.dumps({"dir": tmp, "port2": _free_port(), "t0": time.time()})
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mp_worker", spec],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs, ready = [], False
    try:
        try:
            if before is not None:
                before()
            ready = True
        finally:
            with open(os.path.join(tmp, MP_GO + ".part"), "w") as f:
                f.write("ok" if ready else "failed")
            os.replace(os.path.join(tmp, MP_GO + ".part"),
                       os.path.join(tmp, MP_GO))
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    problems = []
    if any(p.returncode for p in procs):
        problems.append(f"workers exited {[p.returncode for p in procs]}: "
                        + " ".join(o[-1200:] for o in outs))
    ranks = []
    for r in range(world):
        path = os.path.join(tmp, f"mp_rank{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else None)
        if os.path.exists(path):
            os.remove(path)
    return ranks, problems, time.perf_counter() - t


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def mp_check_step(got: dict, ref_metrics: list, rtol: float,
                  param_atol: float, stat_atol: float, launches: dict,
                  problems: list, what: str) -> dict:
    """One rank's checked step(s) against one process's: metrics relative
    (its loss is the global one: the rank holds every row), the whole
    state after it, exactly `launches` a step."""
    worst = 0.0
    for m, r in zip(got["metrics"], ref_metrics):
        for key in ("loss", "loss_a", "loss_v", "loss_f", "grad_norm"):
            worst = max(worst, abs(m[key] - r[key]) / max(abs(r[key]),
                                                           1e-12))
    if len(got["metrics"]) != len(ref_metrics):
        problems.append(f"{what}: {len(got['metrics'])} steps ran")
    if worst > rtol:
        problems.append(f"{what}: metrics differ by {worst} relative")
    param_err, stat_err = got["state_errors"]
    if param_err > param_atol:
        problems.append(f"{what}: parameters differ by {param_err}")
    if stat_err > stat_atol:
        problems.append(f"{what}: BN running stats differ by {stat_err}")
    counts = [_nonzero(c) for c in got["launches"]]
    if not counts or any(c != launches for c in counts):
        problems.append(f"{what}: launches {counts}, expected {launches}")
    return {"max_rel_metric_diff": worst, "max_abs_param_diff": param_err,
            "max_abs_bn_stat_diff": stat_err, "launches_per_rank_step":
            counts}


def phase_model_parallel(failures, smi: str, refs: dict) -> dict:
    """--mp over gloo ranks on the one card (NCCL refuses two ranks on one
    device), each rank a process on cuda:0:
    1. the flagship (phase i's config, float32 and bf16, batch 64 global)
       on four ranks as --dp 2 --mp 2 (`mp_flagship_rank`): 3 checked
       steps each from phase i's kernel arm's state before it, against
       that arm's step at phase r's bars (the loss is the mean of the two
       data indices' row means); the four ranks' gradient norms,
       replicated tensors (digests) and whole states equal; fc_out's two
       shards its column halves of phase i's weight, bit for bit;
       exactly 2 launches of #16 a rank-step; rank 0's .pth whole, its
       fc_out the two shards side by side, loaded strictly by a
       one-process model;
    2. dual Swin-B DGL with --fuse_mlp 1, float32, full width and depth,
       batch 16, on two ranks as --dp 1 --mp 2: one checked step from
       phase m's seed against one process's at phase m's bars, exactly
       48 launches of #15 (fc2 gathered) and of #2 and #4 a rank-step;
    3. phase k's mmformer_n on the same two ranks: one checked step from
       one process's state before it against that process's step at
       phase k's float32 bars, exactly 7 / 7 / 28 / 2 launches of #10 /
       #11 / #14 / #16 a rank-step.
    One launch of four processes: ranks 0 and 1 run 2 and 3 in a process
    group of their own after 1; the one-process references of 2 and 3 are
    made (and timed) here while the four start, before any of their
    work. The median ms of bare steps timed one by
    one after the checked ones (gloo stages every collective through the
    host: no yardstick), peak memory and the seconds of each part per
    rank. Returns {"flagship", "swin", "mm": each rank-step's
    launches}."""
    import torch

    from gdl_tpu_torch.serve import build_model
    from gdl_tpu_torch.utils.checkpoint import load_best_checkpoint

    result = {"flagship": [], "swin": [], "mm": []}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for dtype, ref in refs.items():
            snaps = ref["snapshots"] + [{
                "model": ref["state"], "generator": ref["generator"],
                "steps": ref["steps"]}]
            for k, snap in enumerate(snaps):
                torch.save(snap, os.path.join(tmp, f"snap_{dtype}_{k}.pt"))
        made = {}

        def references():  # while the four workers start
            t = time.perf_counter()
            made["swin"] = mp_swin_step(mp_swin_config(), tmp, reference=True)
            made["mm"] = mm_batched_reference(
                tmp, batched_inter=False, tag="mmp",
                timed_steps=MP_MM_TIMED_STEPS)
            made["seconds"] = time.perf_counter() - t

        ranks, problems, workers_s = mp_launch(tmp, MP_FLAGSHIP_RANKS,
                                               before=references)
        swin_ref, mm_ref = made["swin"], made["mm"]
        for dtype in ("float32", "bfloat16"):
            arms = [r["arms"].get(dtype) if r else None for r in ranks]
            ref = refs.get(dtype)
            if None in arms or ref is None:
                problems.append(f"flagship {dtype}: no result")
                continue
            launches = [_nonzero(c) for a in arms for c in a["launches"]]
            result["flagship"] += launches
            if (len(arms[0]["launches"]) != DP_CHECKED_STEPS
                    or any(c != MP_FLAGSHIP_LAUNCHES for c in launches)):
                problems.append(f"flagship {dtype}: launches {launches}")
            # data indices 0 and 1 are ranks 0-1 and 2-3
            losses = [(a["loss"] + b["loss"]) / 2 for a, b in
                      zip(arms[0]["metrics"], arms[2]["metrics"])]
            worst = 0.0
            for i, (got, r) in enumerate(zip(losses, ref["metrics"])):
                norms = {a["metrics"][i]["grad_norm"] for a in arms}
                if len(norms) != 1:
                    problems.append(f"flagship {dtype} step {i}: the ranks' "
                                    f"gradient norms differ {norms}")
                for key, v in (("loss", got), ("grad_norm", norms.pop())):
                    worst = max(worst, abs(v - r[key]) / abs(r[key]))
            if worst > RESNET_LOSS_RTOL[dtype]:
                problems.append(f"flagship {dtype}: losses differ by {worst}"
                                f" relative")
            errs = [e for a in arms for e in a["state_errors"]]
            param_err = max(e[0] for e in errs)
            stat_err = max(e[1] for e in errs)
            if any(a["state_errors"] != arms[0]["state_errors"]
                   for a in arms):
                problems.append(f"flagship {dtype}: the ranks' whole states "
                                f"differ")
            if dtype == "float32" and param_err > RESNET_PARAM_ATOL:
                problems.append(f"flagship {dtype}: parameters differ by "
                                f"{param_err}")
            if stat_err > RESNET_STAT_ATOL[dtype]:
                problems.append(f"flagship {dtype}: BN running stats differ "
                                f"by {stat_err}")
            digests_equal = all(a["digests"] == arms[0]["digests"]
                                for a in arms)
            if not digests_equal or len(arms[0]["digests"]) != \
                    DP_CHECKED_STEPS:
                problems.append(f"flagship {dtype}: the replicated tensors "
                                f"differ across the ranks")
            columns = [a["shard_columns"] for a in arms]
            k = 16 * RESNET_WIDTH // MP_SIZE  # fc_out's [6, 2 · 512] / 2
            shards_ok = (all(a["shard_exact"] for a in arms) and columns
                         == [[0, k], [k, 2 * k]] * 2)
            if not shards_ok:
                problems.append(f"flagship {dtype}: fc_out shards {columns}, "
                                f"exact {[a['shard_exact'] for a in arms]}")
            # rank 0's .pth: whole, strict in one process
            pth_ok = False
            try:
                sd = load_best_checkpoint(os.path.join(
                    tmp, f"mp_best_{dtype}.pth"))
                one = build_model(resnet_dp_config(dtype, tmp), seed=777)
                one.load_state_dict(sd, strict=True)
                halves = [torch.load(os.path.join(
                    tmp, f"mp_shard_{dtype}_{r}.pt")) for r in range(2)]
                pth_ok = (torch.equal(torch.cat(halves, 1),
                                      sd["fusion_module.fc_out.weight"])
                          and {k: tuple(v.shape) for k, v in sd.items()}
                          == {k: tuple(v.shape)
                              for k, v in one.state_dict().items()})
            except Exception as e:  # reported, and the phase fails
                problems.append(f"flagship {dtype}: .pth {e!r}")
            if not pth_ok:
                problems.append(f"flagship {dtype}: rank 0's .pth is not "
                                f"the whole model")
            emit({"phase": "mp_flagship", "dtype": dtype,
                  "ranks": MP_FLAGSHIP_RANKS, "dp": 2, "mp": MP_SIZE,
                  "device": "cuda:0", "backend": "gloo",
                  "batch": RESNET_BATCH, "rank_batch": arms[0]["local_batch"],
                  "coords": [a["coords"] for a in arms],
                  "loss": losses,
                  "phase_i_loss": [m["loss"] for m in ref["metrics"]],
                  "max_rel_loss_diff": worst,
                  "loss_rtol": RESNET_LOSS_RTOL[dtype],
                  "max_abs_param_diff": param_err,
                  "max_abs_bn_stat_diff": stat_err,
                  "launches_per_rank_step": [c.get(POOL, 0)
                                             for c in launches],
                  "replicated_digests_equal": digests_equal,
                  "fc_out_shard_columns": columns,
                  "fc_out_shards_exact": shards_ok, "pth_whole": pth_ok,
                  "ms_per_step": [a["ms_per_step"] for a in arms],
                  "step_ms": [a["step_ms"] for a in arms],
                  "rank_seconds": [a["seconds"] for a in arms],
                  "peak_gib": [a["peak_gib"] for a in arms],
                  "ms_note": "gloo stages every collective through the "
                             "host: no yardstick", "nvidia_smi": smi})
        ranks2 = ranks[:MP_SIZE]
        for part, ref_out, launches, bars in (
                ("swin", swin_ref, MP_SWIN_LAUNCHES,
                 (LOSS_RTOL["float32"], PARAM_ATOL, PARAM_ATOL)),
                ("mm", mm_ref, MP_MM_LAUNCHES,
                 (MM_LOSS_RTOL["float32"], MM_PARAM_ATOL,
                  MM_STAT_ATOL["float32"]))):
            got = [r.get(part) if r else None for r in ranks2]
            if None in got:
                problems.append(f"{part}: no result")
                continue
            checks = [mp_check_step(g, ref_out["metrics"], *bars, launches,
                                    problems, f"{part} rank {r}")
                      for r, g in enumerate(got)]
            if got[0]["state_errors"] != got[1]["state_errors"]:
                problems.append(f"{part}: the ranks' whole states differ")
            result[part] = [c for chk in checks
                            for c in chk["launches_per_rank_step"]]
            emit(dict({"phase": f"mp_{part}", "dtype": "float32",
                       "ranks": MP_SIZE, "dp": 1, "mp": MP_SIZE,
                       "device": "cuda:0", "backend": "gloo",
                       "batch": MP_SWIN_BATCH if part == "swin" else MM_BATCH,
                       "loss": [g["metrics"][0]["loss"] for g in got],
                       "one_process_loss": ref_out["metrics"][0]["loss"],
                       "loss_rtol": bars[0], "param_atol": bars[1],
                       "ms_per_step": [g["ms_per_step"] for g in got],
                       "step_ms": [g["step_ms"] for g in got],
                       "rank_seconds": [g["seconds"] for g in got],
                       "one_process_ms_per_step": ref_out.get("ms_per_step"),
                       "one_process_step_ms": ref_out.get("step_ms"),
                       "peak_gib": [g["peak_gib"] for g in got],
                       "nvidia_smi": smi},
                      **{k: [c[k] for c in checks] for k in checks[0]}))
    seconds = time.perf_counter() - t0
    emit({"phase": "mp_check", "workers_s": workers_s,
          "refs_s": made.get("seconds"),
          "worker_seconds": [r and {k: v for k, v in r.items()
                                    if k.endswith("_s")} for r in ranks],
          "seconds": seconds, "problems": problems, "ok": not problems})
    failures.extend(f"model parallel: {p}" for p in problems)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every result line to this JSON file")
    ap.add_argument("--export_job", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp_worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mp_worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.export_job:  # one of phase q's exports, in its own process
        return export_job(args.export_job)
    if args.dp_worker:  # one rank of phase r's gloo run
        return dp_worker(args.dp_worker)
    if args.mp_worker:  # one rank of phase t's gloo runs
        return mp_worker(args.mp_worker)

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

    seconds = {}

    def run_phase(name, fn, default):
        """fn() → its result; a phase that raises is reported, counts as a
        failure and gives `default`, and the next phase runs. Each
        phase's wall time goes to the record."""
        t = time.perf_counter()
        try:
            return fn()
        except Exception:
            traceback.print_exc()
            failures.append(f"{name} raised")
            return default
        finally:
            seconds[name] = time.perf_counter() - t

    zero = {k: 0 for k in kernels.launch_counts}
    parity = run_phase("parity", lambda: phase_parity(failures), [])
    launches, expected = run_phase(
        "serve", lambda: phase_serve(failures), ({KERNEL: 0}, 0))
    train_parity = run_phase(
        "train parity", lambda: phase_train_parity(failures), [])
    train_launches = run_phase("train", lambda: phase_train(failures, smi),
                               {SAVEP: 0, BWD: 0})
    pool_parity = run_phase(
        "maxpool parity", lambda: phase_maxpool_parity(failures), [])
    pool_launches, resnet_refs = run_phase(
        "resnet", lambda: phase_resnet(failures, smi), (0, {}))
    profile = run_phase("profile", lambda: phase_profile(failures, smi),
                        {"pool_kernel_events": 0})
    sa_parity, mask_parity = run_phase(
        "sa parity", lambda: phase_sa_parity(failures), ([], []))
    mm_launches = run_phase("mmformer", lambda: phase_mmformer(failures, smi),
                            {"train": dict(zero), "eval": dict(zero)})
    flag_attn, flag_mlp = run_phase(
        "flag parity", lambda: phase_flag_parity(failures), ([], []))
    flag_launch = run_phase("flag train",
                            lambda: phase_flag_train(failures, smi),
                            {"A": dict(zero), "B": dict(zero)})
    variant_rows, variant_launch = run_phase(
        "variant parity", lambda: phase_variant_parity(failures),
        ([], dict(zero)))
    switch_launch = run_phase("mmformer switch",
                              lambda: phase_mmformer_switch(failures, smi),
                              dict(zero))
    joint_launch = run_phase("joint", lambda: phase_joint(failures, smi),
                             {"resnet": 0, SAVEP: 0, BWD: 0, KERNEL: 0})
    export_launch, export_replays = run_phase(
        "export", lambda: phase_export(failures, smi),
        (dict(zero), {KERNEL: 0, MLP: 0, SA_EVAL: 0}))
    dp = run_phase("distributed",
                   lambda: phase_distributed(failures, smi, resnet_refs),
                   {"world1": [], "gloo": [], "offsets": ({}, []),
                    "segments": ({}, []), "mm_batched": []})
    mp = run_phase("model parallel",
                   lambda: phase_model_parallel(failures, smi, resnet_refs),
                   {"flagship": [], "swin": [], "mm": []})
    record.update(parity=parity, train_parity=train_parity,
                  maxpool_parity=pool_parity, sa_parity=sa_parity,
                  mask_parity=mask_parity, flag_parity=flag_attn + flag_mlp,
                  variant_parity=variant_rows, profile=profile,
                  dp_segments=dp["segments"][1],
                  dp_mm_batched=dp.get("mm_batched_check"),
                  phase_seconds=seconds)
    emit({"phase": "wall", "seconds": seconds})

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
    # the joint (OGM-GE) lineage's kernel arms (phase p): #1 at eval, #2
    # and #4 in the Swin steps, #16 in the ResNet steps
    for entry, key in ((entries[0], KERNEL), (entries[1], SAVEP),
                       (entries[2], BWD), (entries[3], "resnet")):
        entry["joint_launches"] = joint_launch[key]
    # the serving artifacts' replays (phase q): #1 and #15 in the fixed
    # Swin-B artifacts, #13 in the mmformer_n ones; launches a replay are
    # the counted launches over the counted replays
    for entry in (entries[0], entries[11], entries[6]):
        name = entry["name"]
        entry["export_launches"] = export_launch[name]
        entry["export_replays"] = export_replays[name]
        entry["export_launches_per_forward"] = (
            export_launch[name] / export_replays[name]
            if export_replays[name] else None)
    # phase r: #16 on the data-parallel paths (a step of the world-1 run,
    # a rank-step of the two gloo ranks); #14, #10 and #11 at an element
    # offset, bit for bit (the launches of those checks)
    entries[3]["dp_world1_launches_per_step"] = [c[POOL]
                                                 for c in dp["world1"]]
    entries[3]["dp_gloo_launches_per_rank_step"] = [c[POOL]
                                                    for c in dp["gloo"]]
    # and in the three-segment layout of --batched_inter 1, and their
    # launches a rank-step of mmformer_n under it over the gloo ranks;
    # #16's events in phase s's trace
    for key in ("offset", "segment"):
        launched, rows = dp["offsets" if key == "offset" else "segments"]
        for entry in (entries[7], entries[4], entries[5]):
            mine = [r["bit_equal"] for r in rows
                    if r["kernel"] == entry["name"]]
            entry[key + "_bit_equal"] = all(mine) if mine else None
            entry[key + "_checks"] = len(mine)
            entry[key + "_launches"] = launched.get(entry["name"], 0)
    for entry in (entries[7], entries[4], entries[5], entries[3]):
        entry["dp_batched_inter_launches_per_rank_step"] = [
            c.get(entry["name"], 0) for c in dp["mm_batched"]]
    entries[3]["profile_trace_events"] = profile["pool_kernel_events"]
    # phase t: launches a rank-step under --mp (#16 in the flagship's four
    # ranks and in mmformer_n's two, #15 in dual Swin-B's two, #10, #11
    # and #14 in mmformer_n's two)
    for entry, part in ((entries[3], "flagship"), (entries[11], "swin"),
                        (entries[4], "mm"), (entries[5], "mm"),
                        (entries[7], "mm"), (entries[3], "mm")):
        key = "mp_launches_per_rank_step" + ("_mmformer" if part == "mm"
                                             and entry is entries[3] else "")
        entry[key] = [c.get(entry["name"], 0) for c in mp[part]]
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
    for entry in entries[:4]:
        if not entry["joint_launches"]:
            failures.append(f"{entry['name']} was never launched on the "
                            f"joint (OGM-GE) path")
    for key in ("dp_world1_launches_per_step",
                "dp_gloo_launches_per_rank_step"):
        if not entries[3][key] or set(entries[3][key]) != {2}:
            failures.append(f"{POOL} on the data-parallel path: {key} "
                            f"{entries[3][key]}")
    for entry, key, want in (
            (entries[3], "mp_launches_per_rank_step", 2),
            (entries[3], "mp_launches_per_rank_step_mmformer", 2),
            (entries[11], "mp_launches_per_rank_step", 48),
            (entries[4], "mp_launches_per_rank_step", 7),
            (entries[5], "mp_launches_per_rank_step", 7),
            (entries[7], "mp_launches_per_rank_step", 28)):
        if not entry[key] or set(entry[key]) != {want}:
            failures.append(f"{entry['name']} on the --mp path: {key} "
                            f"{entry[key]}, not {want}")
    for entry in (entries[7], entries[4], entries[5]):
        for key in ("offset", "segment"):
            if not entry[key + "_bit_equal"] or not entry[key + "_launches"]:
                failures.append(f"{entry['name']}: {key}s not checked or "
                                f"not bit-equal")
        if not any(entry["dp_batched_inter_launches_per_rank_step"]):
            failures.append(f"{entry['name']} was never launched on the "
                            f"--batched_inter 1 data-parallel path")
    # every fixed artifact, in both dtypes, replayed and counted in full
    want_export = dict(zero, **{
        k: v * N_REQUESTS * 2 for k, v in SWIN_EXPORT_LAUNCHES.items()}, **{
        k: v * MM_EXPORT_BATCHES * 2 for k, v in MM_EXPORT_LAUNCHES.items()})
    if export_launch != want_export:
        failures.append(f"the replayed serving artifacts launched "
                        f"{ {k: v for k, v in export_launch.items() if v} }, "
                        f"not { {k: v for k, v in want_export.items() if v} }")
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
