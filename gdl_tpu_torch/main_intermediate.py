"""Trainer of the intermediate-fusion family (MMTM, SE-fusion, mmformer-N
under the AUXI multi-task loss): CLI parity with `main_intermediate.py`.

    python -m gdl_tpu_torch.main_intermediate --train --ckpt_path ckpt \
        --dataset CREMAD --model mmformer_n --alpha 2 --learning_rate 2e-3

Same flags as `main_dgl` plus `--model`, `--share_unimodal_streams`
(tri-state: -1 resolves to on unless --strict_compat) and
`--batched_inter`; `cfg.fps` is 1 (the AV adapter squeezes a single
frame). Per epoch: train, evaluate, one CSV row in
`{dataset}_{model}.csv` (after the [1000, 1000, 1000] sentinel row), and
on a new best accuracy after epoch 0 a reference-schema `.pth`. Runs on
one CUDA device, or under `torchrun` on one a process, data-parallel
over the global batch (`train/loop.py`; under `--batched_inter 1` each
rank's dropout masks of the [3b] inter call take three segments of the
stream, its rows of each pass's global batch); `--device cpu` is the one
way to ask for the CPU (gloo between processes), and without it a
machine without CUDA raises before anything runs. `--profile_dir` is
refused: gdl_tpu's main_intermediate.py traces nothing.
`--export_path` writes the serving artifact of the model's eval forward
from the `.pth` at `--ckpt_path` and exits, as main_intermediate.py does
(`serve.export_intermediate_from_checkpoint`; `--export_poly_batch 1`
for any batch size); the `.pth` is also served eagerly through
`serve.load_intermediate_from_checkpoint`.
"""

import argparse
import os

import torch

from gdl_tpu_torch.config import add_arguments, from_args
from gdl_tpu_torch.data.datasets import make_dataset
from gdl_tpu_torch.models.intermediate import TripleLogits, build_intermediate
from gdl_tpu_torch.parallel.distributed import (
    barrier,
    destroy,
    init_parallel,
    is_primary,
    maybe_initialize,
)
from gdl_tpu_torch.serve import (
    export_intermediate_from_checkpoint,
    resolve_device,
)
from gdl_tpu_torch.train.auxi import make_auxi_train_step, make_sefusion_step
from gdl_tpu_torch.train.loop import (
    Harness,
    assemble_harness,
    check_supported,
    evaluate,
    make_loaders,
    sync_replica_stats,
    train_one_epoch,
)
from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint
from gdl_tpu_torch.utils.logging import CSVLogger


def get_arguments(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m gdl_tpu_torch.main_intermediate")
    add_arguments(parser, dgl=True)
    parser.add_argument("--model", default="mmtm",
                        choices=["mmtm", "sefusion", "mmformer_n"])
    parser.add_argument("--share_unimodal_streams", default=-1, type=int,
                        help="mmformer_n only: reuse each modality's intra "
                        "token stream across the fused/unimodal passes "
                        "(eval outputs identical). Default -1 = on unless "
                        "--strict_compat (the reference's three fusion "
                        "passes draw independent dropout masks and "
                        "triple-count BN running stats, "
                        "surf_mmfomer.py:337-351); 0/1 force")
    parser.add_argument("--batched_inter", default=0, type=int,
                        help="mmformer_n only: run the three fusion "
                        "passes' BN-free inter half as one batched [3B] "
                        "call (eval outputs identical; train keeps the "
                        "dropout distribution)")
    parser.add_argument("--export_path", default=None, type=str,
                        help="write a serving artifact (torch.export, "
                        "weights included) of this model's eval forward "
                        "from the checkpoint FILE at --ckpt_path, then "
                        "exit")
    parser.add_argument("--export_poly_batch", default=0, type=int,
                        help="1 = a symbolic batch dimension (one artifact "
                        "serves any batch size; the plain self-attention). "
                        "0 = pin the config batch")
    return parser.parse_args(argv)


def resolve_share_streams(flag: int, strict_compat: bool) -> bool:
    """--share_unimodal_streams tri-state: -1 (default) resolves to ON
    except under --strict_compat, which keeps the reference's independent
    dropout masks and triple-counted BN running stats
    (surf_mmfomer.py:337-351). 0/1 force either mode."""
    if flag >= 0:
        return bool(flag)
    return not strict_compat


def build_model(name: str, n_classes: int, width: int = 64,
                share_streams: bool = False, batched_inter: bool = False,
                impl: str = "auto", seed=None):
    """(model, kind) initialised on the CPU from `seed`."""
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    return build_intermediate(name, n_classes, width,
                              share_streams=share_streams,
                              batched_inter=batched_inter, impl=impl,
                              generator=gen)


def check_no_trace(cfg) -> None:
    """--profile_dir traces the DGL and joint trainers' steps (their loop,
    as gdl_tpu/train/loop.py does); gdl_tpu's main_intermediate.py runs a
    loop of its own that never traces, so this trainer refuses it."""
    if cfg.profile_dir:
        raise NotImplementedError(
            "--profile_dir is not supported by main_intermediate: gdl_tpu's "
            "main_intermediate.py runs its own epoch loop, which traces no "
            "step (the trace is main_dgl's and main's)")


def build_harness(cfg, model, kind: str, steps_per_epoch: int,
                  raw_batches: bool = True, device=None) -> Harness:
    """The loop's `Harness` for an intermediate-family model: the AUXI
    step (plain CE for kind 'single'), clip 40 + SGD, the eval step over
    (out, out_a, out_v); both under bf16 autocast when
    cfg.compute_dtype is "bfloat16" (f32 parameters)."""
    check_supported(cfg)
    check_no_trace(cfg)
    if cfg.resume:  # gdl_tpu's main_intermediate.py has no resume either
        raise NotImplementedError(
            "--resume is not supported by gdl_tpu_torch.main_intermediate")

    def make_step(model, optimizer, preprocess, generator):
        if kind == "single":
            return make_sefusion_step(model, cfg, optimizer,
                                      preprocess=preprocess,
                                      generator=generator, av_inputs=True)
        return make_auxi_train_step(model, cfg, optimizer,
                                    seven_tuple=kind == "seven",
                                    preprocess=preprocess,
                                    generator=generator, av_inputs=True)

    return assemble_harness(cfg, model, steps_per_epoch, make_step,
                            eval_model=TripleLogits(model, kind),
                            raw_batches=raw_batches, device=device)


def run_training(cfg, model, kind: str, model_name: str, train_set, test_set,
                 raw_batches: bool = True, device=None) -> float:
    """The epoch loop of main_intermediate.py:217-248 → best accuracy.
    Under a process group each rank trains and evaluates its rows of
    every global batch, and rank 0 writes the files."""
    train_loader, test_loader = make_loaders(cfg, train_set, test_set)
    h = build_harness(cfg, model, kind, max(len(train_loader), 1),
                      raw_batches=raw_batches, device=device)
    if is_primary():
        os.makedirs(cfg.ckpt_path, exist_ok=True)
    acc_csv = CSVLogger(os.path.join(
        cfg.ckpt_path, f"{cfg.dataset}_{model_name}.csv"),
        sentinel=[1000, 1000, 1000])
    best_acc = 0.0
    try:
        for epoch in range(cfg.epochs):
            print("Epoch: {}: ".format(epoch))
            train_loader.set_epoch(epoch)
            means = train_one_epoch(h, train_loader, epoch)
            sync_replica_stats(h)
            acc, acc_a, acc_v = evaluate(h, test_loader)
            acc_csv.write_row([acc, acc_a, acc_v])
            acc_csv.flush()
            print("Acc: {:.3f} (a {:.3f}, v {:.3f}), loss {:.3f}".format(
                acc, acc_a, acc_v, means.get("loss", 0.0)))
            if acc > best_acc and epoch:
                best_acc = float(acc)
                path = save_best_checkpoint(cfg, h.model, epoch, acc)
                print("The best model has been saved at {}.".format(path))
    finally:
        acc_csv.close()
    return best_acc


def main(argv=None):
    args = get_arguments(argv)
    cfg = from_args(args)
    maybe_initialize(device=cfg.device)
    try:
        init_parallel(cfg)  # --mp's grid and --dp, before a model
        _main(args, cfg)
    finally:
        destroy()


def _main(args, cfg):
    cfg.fps = 1  # the AV adapter squeezes a single frame
    share_streams = resolve_share_streams(args.share_unimodal_streams,
                                          cfg.strict_compat)
    print(cfg, "model:", args.model)
    check_supported(cfg)
    check_no_trace(cfg)
    resolve_device(cfg.device)  # raises before any work when CUDA is absent
    if args.export_path:
        if is_primary():
            export_intermediate_from_checkpoint(
                cfg, args.model, cfg.ckpt_path, args.export_path,
                share_streams=share_streams,
                poly_batch=bool(args.export_poly_batch), device=cfg.device,
                batched_inter=bool(args.batched_inter))
            print("Serving artifact written to", args.export_path)
        barrier()
        return
    model, kind = build_model(args.model, cfg.n_classes, cfg.encoder_width,
                              share_streams=share_streams,
                              batched_inter=bool(args.batched_inter),
                              seed=cfg.random_seed)
    train_set = make_dataset(cfg, "train")
    test_set = make_dataset(cfg, "test")
    run_training(cfg, model, kind, args.model, train_set, test_set)


if __name__ == "__main__":
    main()
