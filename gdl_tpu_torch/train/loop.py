"""Epoch-loop orchestration of the DGL and joint trainers, port of
`gdl_tpu/train/loop.py`.

Mirrors the flow of the reference main_dgl.py (:225-418) and main.py:
seed → model → optimizer/schedule → loaders → epoch loop {train_epoch,
valid, CSV row, best-acc checkpoint}. Where gdl_tpu runs a jitted step
over a device mesh, the port runs the eager step on one device a
process; under `torchrun` the processes form one data-parallel group
(`parallel/distributed.py`) and compute what gdl_tpu's program computes
with `--dp N`:

- each rank decodes its contiguous rows of every global batch (the
  Loader's process striding) and the steps average the gradients over
  the ranks after the backward;
- the step metrics (epoch means, grad-CSV probes, printed losses) are
  averaged over the ranks, one all-reduce a fetched chunk, and
  `evaluate` sums the per-class counts of every rank's shard, so every
  rank reports the same numbers; more than one rank needs
  `--eval_drop_last 1`, as in gdl_tpu;
- rank 0 alone writes the CSVs, TensorBoard and checkpoints, with a
  barrier after each checkpoint;
- with `--sync_bn 0` the running statistics of the per-replica
  BatchNorms are rank 0's, broadcast before every eval and checkpoint;
- the preemption guard stops every rank at the same step
  (`utils/preempt.py`).

The device prefetch is a pinned, non-blocking host→device copy kept a
batch ahead. Step metrics stay on the device and are fetched in chunks,
never per step (the reference's per-step .item() probes stall every
step, SURVEY §3.1).

With `--mp M` the world of D·M ranks is gdl_tpu's `make_mesh(D, M)`
(`parallel/mesh.py`): "the ranks" above are the data group's (the M
ranks of a data index decode, draw and count the same rows, once), the
heads' and MLPs' linears that gdl_tpu splits are row-parallel over the
model group (`parallel/row_parallel.py`, swapped in when the harness is
built, after every rank took rank 0's whole weights), the clip's norm
sums the shards' squares over the model group, and the checkpoints are
written whole (the model group of rank 0 all-gathers the shards) and
sliced again on `--resume`.

`dgl=False` selects the joint / OGM-GE lineage (main.py): the joint step
(`train/joint.py`, its own clip before the modulation, so the optimizer
does not clip) and the joint eval step. `--pretrained_path` partial-loads
a torchvision-format backbone into the encoders when the harness is
built. `--profile_dir` traces steps 10-12 of epoch 0 with torch.profiler
(`utils/profiling.py`) and closes the trace at the epoch's end. While a
profiler records, the loop logs its spans (`data.next`, `data.pin`,
`data.h2d` of each batch, `train_step` of each step, `metrics.fetch` of
each device→host fetch) and the DGL step those of its stages.
"""

from __future__ import annotations

import collections
import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.data.loader import Loader
from gdl_tpu_torch.data.preprocess import (
    make_eval_preprocess,
    make_train_preprocess,
)
from gdl_tpu_torch.models.classifier import JointLogits
from gdl_tpu_torch.parallel.distributed import (
    all_reduce_,
    broadcast_module,
    is_primary,
    process_count,
)
from gdl_tpu_torch.parallel.mesh import (
    data_group,
    data_index,
    data_size,
    init_grid,
    model_size,
)
from gdl_tpu_torch.parallel.row_parallel import convert_row_parallel
from gdl_tpu_torch.serve import resolve_device
from gdl_tpu_torch.train.dgl import make_dgl_train_step, make_eval_step
from gdl_tpu_torch.train.joint import make_joint_train_step
from gdl_tpu_torch.train.optim import lr_for_epoch, make_optimizer
from gdl_tpu_torch.utils.checkpoint import (
    load_best_checkpoint,
    load_train_state,
    save_best_checkpoint,
    save_train_state,
)
from gdl_tpu_torch.utils.interop import load_pretrained_encoders
from gdl_tpu_torch.utils.logging import CSVLogger, TBLogger
from gdl_tpu_torch.utils.metrics import PerClassAccuracy
from gdl_tpu_torch.utils.profiling import annotate, step_trace, stop_trace
from gdl_tpu_torch.utils.seed import setup_seed

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RESUME_FILE = "resume_state.pth"


def check_supported(cfg: Config) -> None:
    """Raise for every option the CLI accepts and the port does not
    implement, and for a --dp / --mp / --batch_size that the process
    group cannot lay out; nothing is accepted and ignored. The DGL and
    joint lineages take the same options."""
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"--compute_dtype must be one of {list(_DTYPES)}, "
                         f"got {cfg.compute_dtype!r}")
    world = process_count()
    mp = max(cfg.mp, 1)
    if mp > 1 and world == 1:
        raise NotImplementedError(
            f"--mp {mp} needs {mp} processes or a multiple: launch it with "
            f"torchrun --nproc_per_node {mp * max(cfg.dp, 1)} (this process "
            f"has no process group)")
    if world % mp:
        raise ValueError(f"--mp {mp} does not divide torchrun's WORLD_SIZE "
                         f"{world}")
    data = world // mp
    if cfg.dp > 0 and cfg.dp != data:
        if world == 1:
            raise NotImplementedError(
                f"--dp {cfg.dp} needs {cfg.dp} processes: launch it with "
                f"torchrun --nproc_per_node {cfg.dp} (this process has no "
                f"process group; --dp -1 takes torchrun's world size)")
        over = f" over --mp {mp}" if mp > 1 else ""
        raise ValueError(f"--dp {cfg.dp} differs from torchrun's WORLD_SIZE "
                         f"{world}{over}")
    if mp > 1 and cfg.batch_size % data:  # gdl_tpu/train/loop.py:74-77
        raise ValueError(
            f"batch_size {cfg.batch_size} must divide the data-parallel "
            f"mesh size {data} (set --dp or adjust --batch_size)")
    if data > 1 and not cfg.sync_bn and cfg.dp < 1:
        raise ValueError(f"--sync_bn 0 over {data} ranks needs --dp {data} "
                         f"(the CLIs resolve --dp -1 to it)")
    if world > 1 and not cfg.eval_drop_last:
        raise ValueError(f"training or evaluating over {world} ranks needs "
                         f"--eval_drop_last 1 (a ragged final eval batch "
                         f"cannot be split evenly over the ranks)")


@dataclass
class Harness:
    cfg: Config
    model: torch.nn.Module
    optimizer: object
    device: torch.device
    generator: torch.Generator
    train_step: Callable
    eval_step: Callable
    start_epoch: int = 0
    # resume-state sidecar (e.g. step_in_epoch for mid-epoch preemption
    # resume, utils/preempt.py); empty for fresh runs
    resume_extra: dict = field(default_factory=dict)


def assemble_harness(cfg: Config, model: torch.nn.Module,
                     steps_per_epoch: int, make_train_step: Callable,
                     eval_model: Optional[torch.nn.Module] = None,
                     raw_batches: bool = True, device=None,
                     clip_norm: Optional[float] = 40.0) -> Harness:
    """Move `model` to the device, and build its optimizer (cfg.optimizer
    behind a clip at `clip_norm`, None for none), the device generator
    (seeded from cfg.random_seed) and the train and eval steps.
    `make_train_step(model, optimizer, preprocess, generator)` returns
    the family's train step; `eval_model` (default:
    `model`) is what the eval step calls, `(audio, visual) -> (out, out_a,
    out_v)`. `device` overrides cfg.device. With cfg.compute_dtype
    "bfloat16" both steps run under bf16 autocast (f32 parameters).
    cfg.pretrained_path is partial-loaded into the encoders first; then,
    under a process group, every rank takes rank 0's parameters and
    buffers; under --mp each rank then keeps its shards of the
    row-parallel layers; then a resume loads its state on every rank
    (gdl_tpu/train/loop.py:86-89)."""
    dev = resolve_device(device if device is not None else cfg.device)
    init_grid(cfg.mp)  # for library callers; the CLIs built it already
    if cfg.pretrained_path:
        load_pretrained_encoders(model, cfg.pretrained_path)
    generator = setup_seed(cfg.random_seed, dev)
    model = model.to(dev)
    if dev.type == "cuda":  # conv weights as cuDNN reads them beside
        # channels_last activations (models/resnet.py)
        model = model.to(memory_format=torch.channels_last)
    broadcast_module(model)  # every rank starts from rank 0's weights
    convert_row_parallel(model)
    optimizer = make_optimizer(cfg, model.parameters(), steps_per_epoch,
                               clip_norm=clip_norm)
    train_pre = make_train_preprocess(cfg, dev) if raw_batches else None
    eval_pre = make_eval_preprocess(cfg, dev) if raw_batches else None
    step = make_train_step(model, optimizer, train_pre, generator)
    ev = make_eval_step(model if eval_model is None else eval_model,
                        preprocess=eval_pre)
    dtype = _DTYPES[cfg.compute_dtype]

    def autocast():
        return torch.autocast(dev.type, dtype=dtype,
                              enabled=dtype != torch.float32)

    def train_step(batch):
        with autocast():
            return step(batch)

    def eval_step(batch):
        with autocast():
            return ev(batch)

    start_epoch = 0
    resume_extra = {}
    if cfg.resume:
        start_epoch, resume_extra = load_train_state(
            cfg.resume, model, optimizer, generator)
        print("Resumed from {} at epoch {}".format(cfg.resume, start_epoch))
    return Harness(cfg=cfg, model=model, optimizer=optimizer, device=dev,
                   generator=generator, train_step=train_step,
                   eval_step=eval_step, start_epoch=start_epoch,
                   resume_extra=resume_extra)


def build_harness(cfg: Config, model: torch.nn.Module, steps_per_epoch: int,
                  dgl: bool = True, raw_batches: bool = True,
                  device=None) -> Harness:
    """The `Harness` of a DGL classifier (`assemble_harness` with the
    one-backward DGL step, the optimizer's clip at 40) or, with
    dgl=False, of a joint classifier (the joint step, which clips before
    it modulates, an optimizer without a clip, and the joint eval step:
    the fused logits' argmax thrice)."""
    check_supported(cfg)

    def make_step(model, optimizer, preprocess, generator):
        if not dgl:
            return make_joint_train_step(model, cfg, optimizer,
                                         steps_per_epoch,
                                         preprocess=preprocess,
                                         generator=generator)
        return make_dgl_train_step(model, cfg, optimizer, clip_norm=40.0,
                                   preprocess=preprocess, generator=generator)

    return assemble_harness(cfg, model, steps_per_epoch, make_step,
                            eval_model=None if dgl else JointLogits(model),
                            raw_batches=raw_batches, device=device,
                            clip_norm=40.0 if dgl else None)


def _put_batch(batch: dict, device: torch.device, unit=None) -> dict:
    """Host batch → tensors on `device`. On CUDA the arrays pass through
    pinned memory and the copy does not block the host. `unit` is the
    step whose batch it is, for the spans."""
    host = {k: torch.as_tensor(v) for k, v in batch.items()}
    if device.type == "cuda":
        with annotate("data.pin", unit=unit):
            host = {k: t if t.is_cuda else t.pin_memory()
                    for k, t in host.items()}
    with annotate("data.h2d", unit=unit):
        return {k: t.to(device, non_blocking=True) for k, t in host.items()}


def _device_prefetch(iterator: Iterable[dict], device: torch.device,
                     depth: int = 2):
    """Keep `depth` batches in flight on the device while the current
    step runs. The spans of a batch's fetch carry the index of the step
    it feeds; the last `data.next`, which finds the iterator's end, that
    of the step after the last."""
    queue = collections.deque()
    iterator = iter(iterator)
    for unit in itertools.count():
        with annotate("data.next", unit=unit):
            batch = next(iterator, None)
        if batch is None:
            break
        queue.append(_put_batch(batch, device, unit))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def _to_host(steps: list) -> list:
    """The 0-dim entries of each step's metrics as Python floats, all
    steps in one device→host copy; under a process group their means over
    the data group (one all-reduce)."""
    with annotate("metrics.fetch"):
        keys = [k for k, v in steps[0].items() if v.dim() == 0]
        table = torch.stack([torch.stack([m[k].detach().float()
                                          for k in keys]) for m in steps])
        world = data_size()
        if world > 1:
            table = all_reduce_(table, group=data_group()) / world
        return [dict(zip(keys, row)) for row in table.tolist()]


def train_one_epoch(h: Harness, loader: Iterable[dict], epoch: int,
                    grad_csv: Optional[CSVLogger] = None,
                    log_every: int = 100, guard=None,
                    init_sums: Optional[dict] = None,
                    init_count: int = 0) -> dict:
    """Returns the epoch-mean scalars of the reference train_epoch
    (main_dgl.py:164-165). `loader` is a `Loader` or any iterable of
    batches. `guard` is an optional utils/preempt.PreemptionGuard
    checked once per step; when it fires, the epoch stops at the step
    boundary and the returned means carry preempted=True with `steps`
    counting only the completed steps (plus `_sums`, the running
    per-metric sums, so the resumed run can finish the epoch with
    unbiased full-epoch means). `init_sums`/`init_count` re-seed those
    accumulators on a mid-epoch resume. With cfg.profile_dir, epoch 0's
    steps 10-12 are traced into it (`utils/profiling.py`); the trace is
    closed when the epoch ends, whatever its length."""
    cfg = h.cfg
    if epoch < 20:
        print(epoch, lr_for_epoch(cfg, epoch))
    print("Start training ... ")
    sums = dict(init_sums) if init_sums else {}
    count = 0
    pending = []  # step metrics, drained in chunks: keeps the hot loop
    # free of device→host syncs without holding an epoch of buffers
    t0 = time.time()

    def drain():
        if not pending:
            return
        for m in _to_host(pending):
            if grad_csv is not None and "audio_grad_sum" in m:
                grad_csv.write_row([m["audio_grad_sum"],
                                    m["visual_grad_sum"]])
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v
        pending.clear()

    profile_dir = cfg.profile_dir if epoch == 0 else None
    preempted = False
    try:
        for step, batch in enumerate(_device_prefetch(loader, h.device)):
            with step_trace(profile_dir, step), annotate("train_step",
                                                          unit=step):
                metrics = h.train_step(batch)
            pending.append(metrics)
            if len(pending) >= 512:
                drain()
            if step % log_every == 0:
                m = _to_host([metrics])[0]
                print("unimodal_loss:", m["loss_a"] + m["loss_v"],
                      "cls_loss:", m["loss_f"])
                if "audio_grad_sum" in m:
                    print("grad:", m["audio_grad_sum"],
                          m["visual_grad_sum"])
                    print("unimodal", m["abs_out_a"], m["abs_out_v"])
            count += 1
            if guard is not None and guard.should_stop(count):
                preempted = True
                break
    finally:
        if profile_dir:
            stop_trace()
    drain()
    if grad_csv is not None:
        grad_csv.flush()
    total = init_count + count
    means = {k: v / max(total, 1) for k, v in sums.items()}
    means["steps"] = count  # steps THIS run (resume bookkeeping)
    means["wall_time"] = time.time() - t0
    means["preempted"] = preempted
    if preempted:  # carried into the resume state
        means["_sums"] = {k: float(v) for k, v in sums.items()}
    return means


def _pad_batch(batch: dict, target: int):
    """Edge-pad a ragged final batch to `target` rows (keeps the step's
    shapes fixed); returns (batch, n_valid)."""
    n = len(batch["label"])
    if n == target:
        return batch, n
    pad = target - n
    padded = {k: np.concatenate([np.asarray(v),
                                 np.repeat(np.asarray(v)[-1:], pad, axis=0)])
              for k, v in batch.items()}
    return padded, n


def evaluate(h: Harness, loader: Loader) -> tuple:
    """(acc, acc_a, acc_v) with the reference's per-class accounting.

    Ragged final batches (eval_drop_last=False) are edge-padded to the
    full batch size and the padding excluded from the counts."""
    counters = PerClassAccuracy(h.cfg.n_classes)
    target = getattr(loader, "local_batch", None)
    inflight = collections.deque()

    def consume():
        out, n = inflight.popleft()
        host = {k: out[k][:n].cpu().numpy()
                for k in ("pred", "pred_a", "pred_v", "label")}
        counters.update(host["pred"], host["pred_a"], host["pred_v"],
                        host["label"])

    for batch in loader:
        n = len(batch["label"])
        if target is not None:
            batch, n = _pad_batch(batch, target)
        inflight.append((h.eval_step(_put_batch(batch, h.device)), n))
        if len(inflight) >= 2:
            consume()
    while inflight:
        consume()
    if data_size() > 1:  # every data index's rows, on every rank
        arrays = (counters.num, counters.acc, counters.acc_a, counters.acc_v)
        total = all_reduce_(torch.from_numpy(np.stack(arrays)),
                            group=data_group()).numpy()
        for a, t in zip(arrays, total):
            a[:] = t
    return counters.results()


def sync_replica_stats(h: Harness) -> None:
    """With --sync_bn 0 over several ranks, every rank takes rank 0's
    running statistics (gdl_tpu's GroupedBatchNorm keeps replica 0's);
    called before each eval and checkpoint."""
    if not h.cfg.sync_bn and process_count() > 1:
        broadcast_module(h.model, parameters=False)


def run_training(cfg: Config, model: torch.nn.Module, train_set, test_set,
                 dgl: bool = True, raw_batches: bool = True,
                 epoch_callback=None, preempt_guard=None,
                 device=None) -> float:
    """Full --train flow (main_dgl.py:296-396). Returns best accuracy.

    raw_batches=False consumes pre-tensorized {'audio','visual','label'}
    batches with no in-step preprocessing (the loop parity tests feed
    this and gdl_tpu's loop the identical tensors).
    epoch_callback(epoch=..., means=..., acc=..., lr=..., state=...) is
    invoked after each epoch's train+eval, `state` being the Harness.

    Preemption (cfg.preempt_save, default on): SIGTERM stops training at
    the next step boundary and writes `resume_state.pth` carrying the
    epoch AND step-in-epoch; `--resume` then replays the remainder of
    the interrupted epoch (utils/preempt.py). `preempt_guard` injects a
    pre-configured guard (tests, external schedulers)."""
    train_loader, test_loader = make_loaders(cfg, train_set, test_set)
    steps_per_epoch = max(len(train_loader), 1)
    h = build_harness(cfg, model, steps_per_epoch, dgl=dgl,
                      raw_batches=raw_batches, device=device)

    if is_primary():
        os.makedirs(cfg.ckpt_path, exist_ok=True)
    acc_csv = CSVLogger(
        os.path.join(cfg.ckpt_path,
                     "{}_{}.csv".format(cfg.dataset, cfg.modality)),
        sentinel=[1000, 1000, 1000])
    grad_csv = None
    if dgl and cfg.log_grad_csv and cfg.modality == "full":
        grad_csv = CSVLogger("audio_visual_grad_vanilla.csv",
                             flush_every=256)
    tb = None
    if cfg.use_tensorboard and cfg.tensorboard_path:
        tb = TBLogger(cfg.tensorboard_path, cfg.dataset, cfg.fusion_method,
                      cfg.modulation)

    guard = preempt_guard
    owned_guard = False
    if guard is None and cfg.preempt_save:
        from gdl_tpu_torch.utils.preempt import PreemptionGuard

        guard = PreemptionGuard(
            sync_every=getattr(cfg, "preempt_sync_every", 32)).install()
        owned_guard = True
    # mid-epoch resume: re-enter the interrupted epoch past the batches
    # already trained (the saved optimizer step already reflects them)
    pending_skip = int(h.resume_extra.get("step_in_epoch", 0) or 0)
    pending_sums = h.resume_extra.get("partial_sums") or None
    resume_path = os.path.join(cfg.ckpt_path, RESUME_FILE)

    try:
        return _epoch_loop(h, cfg, train_loader, test_loader,
                           steps_per_epoch, guard, grad_csv, acc_csv, tb,
                           epoch_callback, pending_skip, pending_sums,
                           resume_path)
    finally:
        # a raise inside train/eval must not leak the SIGTERM handler nor
        # leave CSVs unflushed
        if owned_guard:
            guard.uninstall()
        if grad_csv is not None:
            grad_csv.close()
        acc_csv.close()
        if tb is not None:
            tb.close()


def make_loaders(cfg: Config, train_set, test_set):
    """(train, test) Loaders of the global batch cfg.batch_size; under a
    process group each rank decodes the contiguous rows of its data index
    in every batch, on the grid that `init_parallel` (or `init_grid`)
    built for cfg.mp."""
    if model_size() != max(cfg.mp, 1):
        raise RuntimeError(f"--mp {cfg.mp}: build its grid (parallel."
                           f"distributed.init_parallel) before the loaders")
    index, size = data_index(), data_size()
    kw = dict(num_workers=cfg.num_workers, seed=cfg.random_seed,
              process_index=index, process_count=size)
    test = Loader(test_set, cfg.batch_size, shuffle=False,
                  drop_last=cfg.eval_drop_last, **kw)
    if train_set is None:
        return None, test
    return Loader(train_set, cfg.batch_size, shuffle=True, drop_last=True,
                  **kw), test


def _save_resume(h: Harness, path: str, epoch: int, extra: dict) -> None:
    sync_replica_stats(h)
    save_train_state(path, h.model, h.optimizer, epoch, h.generator, extra)


def _epoch_loop(h: Harness, cfg: Config, train_loader, test_loader,
                steps_per_epoch: int, guard, grad_csv, acc_csv, tb,
                epoch_callback, pending_skip: int, pending_sums,
                resume_path: str) -> float:
    best_acc = 0.0
    for epoch in range(h.start_epoch, cfg.epochs):
        print("Epoch: {}: ".format(epoch))
        # resumed runs must replay epoch `epoch`'s shuffle order and
        # augmentation draws, not restart the loader's counter at 0
        train_loader.set_epoch(epoch)
        skip, pending_skip = pending_skip, 0
        init_sums, pending_sums = pending_sums, None
        if skip:
            train_loader.skip_next_batches(skip)
        # init_count only when the partial sums were actually restored
        means = train_one_epoch(h, train_loader, epoch, grad_csv=grad_csv,
                                guard=guard, init_sums=init_sums,
                                init_count=skip if init_sums else 0)
        # a flag raised after the last step's check must not defer the
        # stop past a full eval + next epoch
        if (not means.get("preempted") and guard is not None
                and guard.agree()):
            means["preempted"] = True
            means.setdefault("_sums", {})
        stop_after_epilogue = False
        if means.get("preempted"):
            steps_done = skip + int(means["steps"])
            if steps_done < steps_per_epoch:
                # mid-epoch: save and stop BEFORE eval (the uninterrupted
                # run only evals at epoch end; the resumed run finishes
                # this epoch and evals then)
                _save_resume(h, resume_path, epoch,
                             {"step_in_epoch": steps_done,
                              "partial_sums": means.get("_sums", {})})
                print("Preempted at epoch {} step {}; resume state saved "
                      "to {} (--resume to continue)".format(
                          epoch, steps_done, resume_path))
                break
            # fired on the final step: the epoch's training is COMPLETE.
            # Save the resume state now, then run the normal
            # eval/CSV/best-checkpoint epilogue: the resumed run starts
            # at epoch+1 and would otherwise never eval this epoch
            _save_resume(h, resume_path, epoch + 1, {"step_in_epoch": 0})
            stop_after_epilogue = True
        sync_replica_stats(h)
        acc, acc_a, acc_v = evaluate(h, test_loader)
        if epoch_callback is not None:
            epoch_callback(epoch=epoch, means=means,
                           acc=(acc, acc_a, acc_v),
                           lr=lr_for_epoch(cfg, epoch), state=h)
        acc_csv.write_row([acc, acc_a, acc_v])
        acc_csv.flush()
        if tb is not None:
            tb.log_epoch(epoch,
                         {"Total Loss": means.get("loss",
                                                  means.get("loss_f", 0.0)),
                          "Audio Loss": means.get("loss_a", 0.0),
                          "Visual Loss": means.get("loss_v", 0.0)},
                         {"Total Accuracy": acc, "Audio Accuracy": acc_a,
                          "Visual Accuracy": acc_v})

        if acc > best_acc and epoch:  # epoch>0 guard (main_dgl.py:349)
            best_acc = float(acc)
            path = save_best_checkpoint(cfg, h.model, epoch, acc)
            print("The best model has been saved at {}.".format(path))
            print("Loss: {:.3f}, Acc: {:.3f}".format(
                means.get("loss_f", 0.0), acc))
            print("Audio Acc: {:.3f}, Visual Acc: {:.3f} ".format(acc_a,
                                                                  acc_v))
        else:
            print("Loss: {:.3f}, Acc: {:.3f}, Best Acc: {:.3f}".format(
                means.get("loss_f", 0.0), acc, best_acc))
            print("Audio Acc: {:.3f}, Visual Acc: {:.3f} ".format(acc_a,
                                                                  acc_v))
        if cfg.save_every and (epoch + 1) % cfg.save_every == 0:
            _save_resume(h, resume_path, epoch + 1, {"step_in_epoch": 0})
        if stop_after_epilogue:
            print("Preempted at epoch {} step {} (epoch complete, eval "
                  "done); resume state saved to {} (--resume to "
                  "continue)".format(epoch, steps_per_epoch, resume_path))
            break
    return best_acc


def run_eval(cfg: Config, model: torch.nn.Module, test_set, ckpt_path: str,
             dgl: bool = True, raw_batches: bool = True,
             device=None) -> tuple:
    """Eval mode (main_dgl.py:398-418 / valid.py): load a reference-schema
    `.pth` (strict=False semantics, valid.py:148) and validate.
    raw_batches as in run_training; under a process group each rank
    evaluates its rows of every batch and all report the same counts."""
    _, test_loader = make_loaders(cfg, None, test_set)
    h = build_harness(cfg, model, max(len(test_loader), 1), dgl=dgl,
                      raw_batches=raw_batches, device=device)
    result = h.model.load_state_dict(load_best_checkpoint(ckpt_path, cfg),
                                     strict=False)
    if result.missing_keys:
        print(f"checkpoint: {len(result.missing_keys)} keys missing "
              f"(kept current values)")
    if result.unexpected_keys:
        print(f"checkpoint: {len(result.unexpected_keys)} checkpoint keys "
              f"unused")
    print("Trained model loaded!")
    acc, acc_a, acc_v = evaluate(h, test_loader)
    print("Accuracy: {}, accuracy_a: {}, accuracy_v: {}".format(
        acc, acc_a, acc_v))
    return acc, acc_a, acc_v
