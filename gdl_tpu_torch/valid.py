"""Standalone checkpoint evaluator of the port: CLI parity with `valid.py`.

    python -m gdl_tpu_torch.valid --ckpt_path best_model.pth \
        --dataset CREMAD --fusion_method concat [--export_path m.pt2]

Rebuilds the DGL classifier (`AVClassifierDGL`, or `AVClassifierSwinDGL`
under --backbone swin), loads a reference-schema `.pth` (strict=False,
valid.py:148) and runs the per-class accuracy accounting over the test
split. `--export_path` also writes the serving artifact of the same
checkpoint (`serve.export_from_checkpoint`, for the CPU and CUDA; with
`--export_poly_batch 1` one artifact serves any batch size; rank 0
writes it). Runs on one CUDA device, or under `torchrun` on one a
process, each rank evaluating its rows of every batch and all reporting
the same accuracy (`--eval_drop_last 1`); `--device cpu` is the one way
to ask for the CPU. Under `--mp` it evaluates through the same grid as
the trainers (gdl_tpu's valid.py reaches `make_mesh` through its
`run_eval` too), each rank slicing its shards from the whole `.pth`.
"""

import argparse

from gdl_tpu_torch.config import Config, add_arguments, from_args
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
from gdl_tpu_torch.train.loop import check_supported, run_eval


def get_arguments(argv=None):
    parser = argparse.ArgumentParser(prog="python -m gdl_tpu_torch.valid")
    add_arguments(parser, dgl=True)
    parser.add_argument("--export_path", default=None, type=str,
                        help="also write a serving artifact (torch.export, "
                        "weights included) of the checkpoint")
    parser.add_argument("--export_poly_batch", default=0, type=int,
                        help="1 = a symbolic batch dimension (one artifact "
                        "serves any batch size; the plain versions of the "
                        "kernels). 0 = pin the config batch size")
    return parser.parse_args(argv)


def run_valid(cfg: Config, test_set, export_path=None,
              poly_batch: bool = False) -> tuple:
    """Evaluate cfg.ckpt_path on `test_set` → (acc, acc_a, acc_v); then,
    given `export_path`, write the checkpoint's serving artifact there."""
    check_supported(cfg)
    resolve_device(cfg.device)  # raises before any work when CUDA is absent
    model = build_model(cfg, seed=cfg.random_seed)
    result = run_eval(cfg, model, test_set, cfg.ckpt_path, dgl=True)
    if export_path and is_primary():
        export_from_checkpoint(cfg, cfg.ckpt_path, export_path,
                               poly_batch=poly_batch, device=cfg.device)
        print("Serving artifact written to", export_path)
    barrier()
    return result


def main(argv=None):
    args = get_arguments(argv)
    cfg = from_args(args)
    maybe_initialize(device=cfg.device)  # torchrun's process group
    try:
        init_parallel(cfg)  # --mp's grid and --dp, before a model
        print(cfg)
        return run_valid(cfg, make_dataset(cfg, "test"), args.export_path,
                         bool(args.export_poly_batch))
    finally:
        destroy()


if __name__ == "__main__":
    main()
