"""Where the time of a training step goes on the card.

    python -m gdl_tpu_torch.profile_step [--backbone resnet|swin|mmformer]
        [--dtype float32|bfloat16] [--impl auto|plain] [--steps 6]
        [--fuse_qkv_gemm 0] [--fuse_mlp 1] [--bwd_delta 1]
        [--fused_projection_backward 1] [--sa_fused_qkv 0] [--joint 1]
        [--out profile.json]

Builds the flagship configuration of the backbone at full width with
seeded weights (ResNet: CREMA-D, batch 64, concat DGL, alpha 5, lr 2e-3;
Swin: VGGSound, batch 32; mmformer: mmformer_n on CREMA-D, batch 64,
shared unimodal streams, AUXI loss), takes warm-up steps through the
port's `build_harness` (`main_intermediate`'s for mmformer) and
`train_one_epoch` over synthetic raw batches
collected beforehand, times `--steps` untraced steps (host clock, one
synchronize at the end), then traces the same number of steps with
`torch.profiler` and prints one JSON object: untraced ms/step, device
ms/step (the sum of the CUDA kernels' and copies' self time), busy share
(device ms over untraced ms), device time by kind of kernel and the
largest kernels by name, and every kernel of the kind "other" by name.
Needs a CUDA device; TF32 is off for matrix products and convolutions,
as in `chip_smoke.py`. `--fuse_qkv_gemm` to `--fused_projection_backward`
are for the Swin backbone: the CLI's two kernel flags, and the two module
switches of `ops/window_attention.py`; `--sa_fused_qkv 0` sets
`models/transformer.py`'s SA_FUSED_QKV for the mmformer backbone.
`--joint 1` takes the joint / OGM-GE lineage's step instead of the DGL
one, in bench.py's configurations: ResNet `_measure_ogm` (CREMA-D, batch
64, concat, alpha 0.3, live OGM-GE), Swin `_measure_swin` (CREMA-D,
batch 32, concat, alpha 1, Normal).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

# kind → substrings of the CUDA kernel's name, first match wins
KINDS = (
    # #3's three launches: its attention stage (wa_bwd_fused_attn_kernel)
    # and its dx and dW products, gemm_tile_kernel (kernels/gemm_tile.cuh)
    # with the epilogues of namespace wa3 in their symbols. This row comes
    # first: the rows of #13 and #4 below would otherwise take them
    ("window_attention_bwd_fused (#3)", ("wa3::", "wa_bwd_fused")),
    # #15's fc1 and fc2 are gemm_tile_kernel with the epilogues of
    # namespace mlp in their symbols; every other gemm_tile_kernel (the
    # identity epilogue) is the qkv projection of #10 or #13, so this row
    # comes before theirs
    ("mlp_fused (#15)", ("mlp::",)),
    # #1's and #2's qkv projection is gemm_tile_kernel with the epilogue
    # wa2::ProjBias (kernels/window_attention_proj.cuh) in its symbol;
    # their attention is wa_fwd_kernel, in the window_attention row below
    ("window_attention_proj (#1, #2)", ("wa2::",)),
    # #11's two launches: part A on the row tile (sa_bwd_rows_kernel) and
    # part B (sa_bwd_keys_kernel); this row comes before the forwards'
    ("self_attention_bwd (#11)", ("sa_bwd_rows_kernel",
                                  "sa_bwd_keys_kernel")),
    ("self_attention (#10, #12, #13)", ("sa_train_kernel", "sa_eval_kernel",
                                        "gemm_tile_kernel")),
    ("dropout_mask (#14)", ("dropout_mask_kernel",)),
    ("maxpool_bwd (#16)", ("maxpool_bwd_kernel",)),
    # #6's backward; its forward is #5's launch (wa_fwd_kernel), filed
    # under the forwards' row below
    ("window_attention_rows (#6)", ("wa_bwd_rows_kernel",)),
    ("window_attention_bwd_recompute (#7)", ("wa_bwd_recompute_kernel",)),
    # #8 and #9: one launch, the forward body on the [B, H, N, D] strides
    ("window_attention_bhnd (#8, #9)", ("wa_bhnd_kernel",)),
    # #4 and #4-delta (the backward from the saved p) apart from the
    # forwards' attention
    ("window_attention_bwd (#4)", ("wa_bwd_kernel",)),
    # the forward body on a qkv: #1's and #2's attention, #5, #6's and #7's
    # forward
    ("window_attention (#1, #2, #5, #7 forward)", ("wa_fwd_kernel",)),
    ("batch_norm", ("bn_fw", "bn_bw", "batch_norm", "batchnorm")),
    # cuDNN's FFT convolution algorithms also call cuBLAS complex GEMMs,
    # which land under "gemm"
    ("gemm", ("cublas", "gemv")),
    ("convolution", ("cudnn", "conv", "wgrad", "dgrad", "xmma", "implicit",
                     "nchwToNhwc", "nhwcToNchw", "fft2d",
                     "pointwise_mult_and_sum_complex", "flip_filter")),
    ("gemm", ("gemm", "cutlass", "nvjet")),
    ("layer_norm", ("layer_norm", "layernorm", "GammaBeta")),
    ("roll", ("roll_cuda",)),
    ("pooling", ("max_pool", "avg_pool")),
    ("pad", ("reflection_pad",)),
    # cub's radix sort: the backward of an index with repeats (Swin's
    # relative-position-bias gather) sorts the indices first
    ("sort", ("RadixSort",)),
    ("fft", ("fft",)),
    ("optimizer_foreach", ("multi_tensor", "foreach")),
    ("copy", ("memcpy", "memset", "copy", "cat")),
    ("reduction", ("reduce", "softmax", "norm")),
    ("elementwise", ("elementwise", "vectorized", "index", "gather",
                     "scatter", "fill")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, words in KINDS:
        if any(w.lower() in low for w in words):
            return kind
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backbone", default="resnet",
                    choices=["resnet", "swin", "mmformer"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--impl", default="auto", choices=["auto", "plain"])
    ap.add_argument("--steps", type=int, default=6)
    # the Swin kernel flags of the CLI, and the op module's two switches
    ap.add_argument("--fuse_qkv_gemm", type=int, default=1)
    ap.add_argument("--fuse_mlp", type=int, default=0)
    ap.add_argument("--bwd_delta", type=int, default=0)
    ap.add_argument("--fused_projection_backward", type=int, default=0)
    ap.add_argument("--sa_fused_qkv", type=int, default=1)
    ap.add_argument("--joint", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.joint and args.backbone == "mmformer":
        ap.error("--joint 1 takes --backbone resnet or swin")

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdl_tpu_torch import kernels, main_intermediate
    from gdl_tpu_torch.config import Config
    from gdl_tpu_torch.data.loader import Loader
    from gdl_tpu_torch.data.synthetic import SyntheticDataset
    from gdl_tpu_torch.serve import build_model, resolve_device
    from gdl_tpu_torch.train.loop import build_harness, train_one_epoch

    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    joint = bool(args.joint)
    if joint and args.backbone == "resnet":
        cfg = Config(dataset="CREMAD", fusion_method="concat", fps=1,
                     batch_size=64, learning_rate=2e-3, alpha=0.3,
                     modulation="OGM_GE", log_grad_csv=False,
                     compute_dtype=args.dtype)
    elif joint:
        cfg = Config(dataset="CREMAD", backbone="swin",
                     fusion_method="concat", fps=1, batch_size=32, alpha=1.0,
                     modulation="Normal", log_grad_csv=False,
                     compute_dtype=args.dtype)
    elif args.backbone == "resnet":
        cfg = Config(dataset="CREMAD", fusion_method="concat", fps=1,
                     batch_size=64, learning_rate=2e-3, alpha=5.0,
                     modulation="Normal", log_grad_csv=False,
                     compute_dtype=args.dtype)
    elif args.backbone == "swin":
        cfg = Config(dataset="VGGSound", backbone="swin",
                     fusion_method="concat", fps=1, batch_size=32,
                     log_grad_csv=False, compute_dtype=args.dtype,
                     fuse_qkv_gemm=bool(args.fuse_qkv_gemm),
                     fuse_mlp=bool(args.fuse_mlp))
        from gdl_tpu_torch.ops import window_attention

        window_attention.BWD_DELTA = bool(args.bwd_delta)
        window_attention.FUSED_PROJECTION_BACKWARD = bool(
            args.fused_projection_backward)
    else:
        cfg = Config(dataset="CREMAD", fps=1, batch_size=64,
                     log_grad_csv=False, compute_dtype=args.dtype)
        from gdl_tpu_torch.models import transformer

        transformer.SA_FUSED_QKV = bool(args.sa_fused_qkv)
    data = SyntheticDataset(cfg, size=cfg.batch_size * args.steps, seed=700)
    batches = list(Loader(data, cfg.batch_size, shuffle=False, drop_last=True,
                          num_workers=8))
    if args.backbone == "mmformer":
        model, kind = main_intermediate.build_model(
            "mmformer_n", cfg.n_classes, cfg.encoder_width,
            share_streams=True, impl=args.impl, seed=777)
        h = main_intermediate.build_harness(cfg, model, kind,
                                            steps_per_epoch=100)
    else:
        h = build_harness(cfg, build_model(cfg, attn_impl=args.impl,
                                           seed=777, dgl=not joint),
                          steps_per_epoch=6698 // 64 if joint else 100,
                          dgl=not joint)

    def epoch():
        with contextlib.redirect_stdout(sys.stderr):
            train_one_epoch(h, batches, 1)
        torch.cuda.synchronize()

    epoch()  # warm-up: allocator, cuDNN's choice of algorithms, the build
    kernels.reset_launch_counts()
    t = time.perf_counter()
    epoch()
    untraced = (time.perf_counter() - t) * 1e3 / args.steps
    launches = dict(kernels.launch_counts)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        epoch()
        traced = (time.perf_counter() - t) * 1e3 / args.steps

    by_kind, by_name, n_kernels = {}, {}, 0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us <= 0 or getattr(evt, "is_user_annotation", False) or (
                evt.key.startswith("Optimizer.")):
            continue  # an annotation's span on the card is no kernel
        ms = us / 1e3 / args.steps
        n_kernels += evt.count
        by_kind[kind_of(evt.key)] = by_kind.get(kind_of(evt.key), 0.0) + ms
        by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
    device = sum(by_kind.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    result = {
        "backbone": args.backbone, "joint": joint, "dtype": args.dtype,
        "impl": args.impl,
        "sa_fused_qkv": (bool(args.sa_fused_qkv)
                         if args.backbone == "mmformer" else None),
        "batch": cfg.batch_size, "steps": args.steps,
        "untraced_ms_per_step": untraced, "traced_ms_per_step": traced,
        "clips_per_s": cfg.batch_size / untraced * 1e3,
        "device_ms_per_step": device,
        "busy_share": device / untraced,
        "device_launches_per_step": n_kernels / args.steps,
        "kernel_launch_counts_per_step": {k: v / args.steps
                                          for k, v in launches.items()},
        "device_ms_by_kind": dict(sorted(by_kind.items(),
                                         key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:20]),
        "other_kernels_ms": dict(sorted(
            ((k, v) for k, v in by_name.items() if kind_of(k) == "other"),
            key=lambda kv: -kv[1])),
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
    }
    if device == 0.0:
        print("the profiler recorded no device time", file=sys.stderr)
        return 1
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
