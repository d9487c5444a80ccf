"""Where the time of a training step goes on the card.

    python -m gdl_tpu_torch.profile_step [--backbone resnet|swin|mmformer]
        [--dtype float32|bfloat16] [--impl auto|plain] [--steps 6]
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
largest kernels by name. Needs a CUDA device; TF32 is off for matrix
products and convolutions, as in `chip_smoke.py`.
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
    ("self_attention (#10, #11, #13)", ("sa_proj_kernel", "sa_tile_kernel",
                                        "sa_bwd_kv_kernel")),
    ("dropout_mask (#14)", ("dropout_mask_kernel",)),
    ("maxpool_bwd (#16)", ("maxpool_bwd_kernel",)),
    ("window_attention (#2, #4)", ("wa_fwd", "wa_bwd", "window_attention")),
    ("batch_norm", ("bn_fw", "bn_bw", "batch_norm", "batchnorm")),
    # cuDNN's FFT convolution algorithms also call cuBLAS complex GEMMs,
    # which land under "gemm"
    ("gemm", ("cublas", "gemv")),
    ("convolution", ("cudnn", "conv", "wgrad", "dgrad", "xmma", "implicit",
                     "nchwToNhwc", "nhwcToNchw", "fft2d",
                     "pointwise_mult_and_sum_complex")),
    ("gemm", ("gemm", "cutlass", "nvjet")),
    ("layer_norm", ("layer_norm", "layernorm", "GammaBeta")),
    ("roll", ("roll_cuda",)),
    ("pool_forward", ("max_pool",)),
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
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

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
    if args.backbone == "resnet":
        cfg = Config(dataset="CREMAD", fusion_method="concat", fps=1,
                     batch_size=64, learning_rate=2e-3, alpha=5.0,
                     modulation="Normal", log_grad_csv=False,
                     compute_dtype=args.dtype)
    elif args.backbone == "swin":
        cfg = Config(dataset="VGGSound", backbone="swin",
                     fusion_method="concat", fps=1, batch_size=32,
                     log_grad_csv=False, compute_dtype=args.dtype)
    else:
        cfg = Config(dataset="CREMAD", fps=1, batch_size=64,
                     log_grad_csv=False, compute_dtype=args.dtype)
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
                                           seed=777), steps_per_epoch=100)

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
        "backbone": args.backbone, "dtype": args.dtype, "impl": args.impl,
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
