"""Joint-training entry point of the port (the OGM-GE lineage): CLI parity
with `main.py`.

    python -m gdl_tpu_torch.main --train --ckpt_path ckpt --dataset CREMAD \
        --modulation OGM_GE --fusion_method concat --alpha 0.3

Same flags as main.py (main_dgl.py's plus --pe, --beta, --max,
--pretrain, --warmup, --gamma; --alpha required), same stdout, CSV and
checkpoint artifacts. Per step: the joint loss (CE of the fused logits,
plus β·KL of the PE heads under --pe), the clip at 40, OGM / OGM-GE
modulation of the encoders' conv kernels (live unless --strict_compat;
off for --modulation Normal), then SGD, AdaGrad or AdamW
(--optimizer sgd | AdaGrad | Adam). --backbone swin selects dual Swin
encoders, otherwise dual ResNet-18. Without --train, --ckpt_path names a
reference-schema `.pth` to evaluate. Runs on one CUDA device, or under
`torchrun` data-parallel on one a process (`train/loop.py`);
`--device cpu` is the one way to ask for the CPU (gloo between
processes), and without it a machine without CUDA raises before
anything runs. In eval mode,
`--export_path` also writes the serving artifact of the joint model's
eval forward (`serve.export_from_checkpoint(..., dgl=False)`: the
11-tuple; `--export_poly_batch 1` for any batch size), as main.py does;
with --train it is ignored, with a warning. Rank 0 writes it. A `.pth` is also served
eagerly through `serve.load_from_checkpoint(..., dgl=False)`.
"""

import argparse
import warnings

from gdl_tpu_torch.config import add_arguments, from_args
from gdl_tpu_torch.data.datasets import make_dataset
from gdl_tpu_torch.parallel.distributed import (
    barrier,
    destroy,
    init_parallel,
    is_primary,
    maybe_initialize,
)
from gdl_tpu_torch.serve import (
    build_model,
    export_from_checkpoint,
    resolve_device,
)
from gdl_tpu_torch.train.loop import check_supported, run_eval, run_training


def get_arguments(argv=None):
    parser = argparse.ArgumentParser(prog="python -m gdl_tpu_torch.main")
    add_arguments(parser, dgl=False)
    parser.add_argument("--export_path", default=None, type=str,
                        help="eval mode only: also write a serving "
                        "artifact (torch.export) of the joint model's eval "
                        "forward")
    parser.add_argument("--export_poly_batch", default=0, type=int,
                        help="1 = a symbolic batch dimension (one artifact "
                        "serves any batch size)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_arguments(argv)
    cfg = from_args(args)
    maybe_initialize(device=cfg.device)  # torchrun's process group
    try:
        init_parallel(cfg)  # --mp's grid and --dp, before a model
        _main(args, cfg)
    finally:
        destroy()


def _main(args, cfg):
    print(cfg)
    if args.export_path and cfg.train:
        warnings.warn("--export_path is read in eval mode only (without "
                      "--train); no artifact is written")
    check_supported(cfg)
    resolve_device(cfg.device)  # raises before any work when CUDA is absent
    model = build_model(cfg, seed=cfg.random_seed, dgl=False)

    if cfg.train:
        train_set = make_dataset(cfg, "train")
        test_set = make_dataset(cfg, "test")
        run_training(cfg, model, train_set, test_set, dgl=False)
    else:
        test_set = make_dataset(cfg, "test")
        run_eval(cfg, model, test_set, cfg.ckpt_path, dgl=False)
        if args.export_path and is_primary():
            export_from_checkpoint(cfg, cfg.ckpt_path, args.export_path,
                                   dgl=False,
                                   poly_batch=bool(args.export_poly_batch),
                                   device=cfg.device)
            print("Serving artifact written to", args.export_path)
        barrier()


if __name__ == "__main__":
    main()
