"""DGL training entry point of the port — CLI parity with `main_dgl.py`.

    python -m gdl_tpu_torch.main_dgl --train --ckpt_path ckpt \
        --dataset CREMAD --modulation Normal --fusion_method concat \
        --alpha 5 --learning_rate 2e-3 --epochs 100   # cramed_dgl.sh:8

Same flags (main_dgl.py:24-65), same stdout/CSV/checkpoint artifacts
(SURVEY §5.5, §3.6), on one CUDA device: on-device preprocessing, the
single-backward DGL loss, clip 40 + SGD. `--device cpu` is the one way
to ask for the CPU; without it a machine without CUDA raises before
anything runs. Data-parallel over N processes, one a device (NCCL; gloo
with `--device cpu`), with `--batch_size` the global batch:

    torchrun --nproc_per_node N -m gdl_tpu_torch.main_dgl --train \
        --eval_drop_last 1 ...  # --dp -1 (the default) or N Without `--train`, `--ckpt_path` names a reference-schema
`.pth` to evaluate.
"""

import argparse

from gdl_tpu_torch.config import add_arguments, from_args
from gdl_tpu_torch.data.datasets import make_dataset
from gdl_tpu_torch.parallel.distributed import (
    destroy,
    init_parallel,
    maybe_initialize,
)
from gdl_tpu_torch.serve import build_model, resolve_device
from gdl_tpu_torch.train.loop import check_supported, run_eval, run_training


def get_arguments(argv=None):
    parser = argparse.ArgumentParser(prog="python -m gdl_tpu_torch.main_dgl")
    add_arguments(parser, dgl=True)
    return parser.parse_args(argv)


def main(argv=None):
    cfg = from_args(get_arguments(argv))
    maybe_initialize(device=cfg.device)  # torchrun's process group
    try:
        init_parallel(cfg)  # --mp's grid and --dp, before a model
        _main(cfg)
    finally:
        destroy()


def _main(cfg):
    print(cfg)
    check_supported(cfg)
    resolve_device(cfg.device)  # raises before any work when CUDA is absent

    if cfg.backbone == "swin":
        if cfg.strict_compat:
            raise EOFError  # the reference's stub (main_dgl.py:239-240)
    elif cfg.backbone != "resnet":
        raise EOFError  # main_dgl.py:239-240
    model = build_model(cfg, seed=cfg.random_seed)

    if cfg.train:
        train_set = make_dataset(cfg, "train")
        test_set = make_dataset(cfg, "test")
        run_training(cfg, model, train_set, test_set, dgl=True)
    else:
        test_set = make_dataset(cfg, "test")
        run_eval(cfg, model, test_set, cfg.ckpt_path, dgl=True)


if __name__ == "__main__":
    main()
