"""Checkpointing, port of `gdl_tpu/utils/checkpoint.py` and of the
`.pth` writer in `gdl_tpu/utils/torch_interop.py`.

Best checkpoints: on a new best accuracy the reference saves a dict
{saved_epoch, modulation, alpha, fusion, acc, model, optimizer,
scheduler} under the filename pattern
  best_model_of_dataset_{ds}_{mod}_alpha_{a}optimizer_{opt}_modulate_
  starts_{s}_ends_{e}_epoch_{n}_acc_{acc}.pth
(main_dgl.py:349-386) and on load asserts modulation/fusion consistency
(main_dgl.py:409-410). The port writes that schema as a real torch `.pth`
(the reference's own artifact, loadable by its valid.py and by gdl_tpu's
`load_torch_checkpoint`).

Resume: `save_train_state` / `load_train_state` persist the model, the
optimizer's momentum buffers and step count, the epoch, the device
generator's state and a free-form `extra` (step_in_epoch for a mid-epoch
resume) as one `.pth`.

Under a process group only rank 0 writes either file, and every rank
waits at a barrier after the save, so a file is whole before any rank
goes on (the ranks hold the same weights: `train/loop.py`). Under `--mp`
the ranks of rank 0's model group first all-gather the row-parallel
shards, the weights and their optimizer state, so both files hold whole
tensors in the one-process schema; loading either slices them again
(`parallel/row_parallel.py`).

The port neither reads nor writes gdl_tpu's msgpack files; given one,
the loaders raise and say so.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.parallel.distributed import barrier, is_primary
from gdl_tpu_torch.parallel.mesh import data_index
from gdl_tpu_torch.parallel.row_parallel import (
    full_optimizer_state,
    full_state_dict,
    shard_optimizer_state,
)
from gdl_tpu_torch.train.optim import MOMENTUM, WEIGHT_DECAY
from gdl_tpu_torch.utils.interop import load_reference_pth


def legacy_checkpoint_name(cfg: Config, epoch: int, acc: float) -> str:
    return (
        "best_model_of_dataset_{}_{}_alpha_{}"
        "optimizer_{}_modulate_starts_{}_ends_{}_"
        "epoch_{}_acc_{}.pth".format(
            cfg.dataset, cfg.modulation, cfg.alpha, cfg.optimizer,
            cfg.modulation_starts, cfg.modulation_ends, epoch, acc)
    )


def is_torch_checkpoint(path: str) -> bool:
    """torch>=1.6 saves a zipfile (PK..); legacy torch is a pickle stream
    (0x80 <proto>). gdl_tpu's msgpack files start with a fixmap (0x8N),
    so the magics are disjoint in practice."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head[:2] == b"PK":
        return True
    return len(head) == 2 and head[0] == 0x80 and 2 <= head[1] <= 5


def require_torch_file(path: str) -> None:
    if not is_torch_checkpoint(path):
        raise ValueError(
            f"{path} is not a torch checkpoint. gdl_tpu_torch reads and "
            f"writes .pth files only; gdl_tpu's msgpack checkpoints are "
            f"not supported (write a .pth there with --save_torch)")


def save_best_checkpoint(cfg: Config, model: torch.nn.Module, epoch: int,
                         acc: float, path: Optional[str] = None) -> str:
    """Write the best-accuracy checkpoint in the reference's schema;
    returns its full path (rank 0 writes it). As in gdl_tpu's writer the
    optimizer entry carries the hyperparameters only."""
    if path is None:
        path = os.path.join(cfg.ckpt_path,
                            legacy_checkpoint_name(cfg, epoch, acc))
    state = full_state_dict(model) if data_index() == 0 else None
    if is_primary():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(_best_payload(cfg, state, epoch, acc), path)
    barrier()
    return path


def _best_payload(cfg: Config, state: dict, epoch: int, acc: float) -> dict:
    return {
        "saved_epoch": epoch,
        "modulation": cfg.modulation,
        "alpha": cfg.alpha,
        "fusion": cfg.fusion_method,
        "acc": acc,
        "model": {k: v.detach().cpu().clone() for k, v in state.items()},
        "optimizer": {
            "state": {},
            "param_groups": [{
                "lr": cfg.learning_rate, "momentum": MOMENTUM,
                "weight_decay": WEIGHT_DECAY, "params": [],
            }],
        },
        "scheduler": {
            "milestones": list(cfg.lr_decay_step),
            "gamma": cfg.lr_decay_ratio,
        },
    }


def load_best_checkpoint(path: str, cfg: Optional[Config] = None) -> dict:
    """The state dict of a reference-schema `.pth` (`module.` stripped),
    after the reference's compatibility asserts against `cfg`."""
    require_torch_file(path)
    return load_reference_pth(path, cfg)


def save_train_state(path: str, model: torch.nn.Module, optimizer,
                     epoch: int, generator: Optional[torch.Generator] = None,
                     extra: Optional[dict] = None) -> None:
    """Atomic: written to a sibling tmp file then os.replace'd, so a crash
    (or the tail of a preemption grace window, utils/preempt.py) mid-write
    never corrupts an existing resume state. Rank 0 writes it."""
    if data_index() == 0:
        state = (full_state_dict(model),
                 full_optimizer_state(optimizer, model))
    if is_primary():
        _write_train_state(path, *state, optimizer, epoch, generator, extra)
    barrier()


def _write_train_state(path, model_state, optimizer_state, optimizer, epoch,
                       generator, extra):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "model": model_state,
        "optimizer": optimizer_state,
        "optimizer_steps": int(getattr(optimizer, "steps", 0)),
        "generator": (generator.get_state() if generator is not None
                      else None),
        "epoch": int(epoch),
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())  # durability before the rename
    os.replace(tmp, path)


def load_train_state(path: str, model: torch.nn.Module, optimizer,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[int, dict]:
    """Restore `model`, `optimizer` and `generator` in place from a file
    written by `save_train_state` → (epoch, extra); a row-parallel layer
    (`--mp`) takes its columns of each whole tensor."""
    require_torch_file(path)
    device = next(model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=False)
    if "optimizer_steps" not in payload:
        raise ValueError(f"{path} is not a resume state written by "
                         f"save_train_state")
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(shard_optimizer_state(payload["optimizer"],
                                                    optimizer, model))
    optimizer.steps = int(payload["optimizer_steps"])
    if generator is not None and payload.get("generator") is not None:
        generator.set_state(payload["generator"].cpu())
    return int(payload["epoch"]), payload.get("extra", {})
