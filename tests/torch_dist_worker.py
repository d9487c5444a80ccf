"""The data-parallel scenarios of tests/test_torch_distributed.py, run by
each rank of a process group on gloo (and, for the one-process
references, by the test itself without one).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dist_worker.py OUT_DIR INIT_PTH

runs every scenario of `SCENARIOS` on this rank and writes
OUT_DIR/<scenario>_rank<r>.pt (torch.save of a dict). INIT_PTH holds the
initial weights of the flagship classifier (a state dict). Imports
neither jax nor gdl_tpu: the test holds the results against those.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gdl_tpu_torch.config import Config  # noqa: E402
from gdl_tpu_torch.parallel import distributed as dist  # noqa: E402

N_CLASSES = 6
SPEC, HW, FRAMES = (33, 40), 32, 2
KW = dict(dataset="CREMAD", modulation="Normal", fusion_method="concat",
          alpha=4.0, learning_rate=2e-3, lr_decay_step=[2], batch_size=4,
          epochs=2, num_workers=1, encoder_width=8,
          encoder_stages=[1, 1, 1, 1], fps=FRAMES, log_grad_csv=True,
          eval_drop_last=True, preempt_save=0, random_seed=3, device="cpu")
SWIN_TINY = dict(swin_embed_dim=16, swin_depths=[1, 1], swin_heads=[2, 4],
                 swin_window=4, swin_img_size=32, swin_patch=4,
                 backbone="swin")
MMF = dict(num_classes=N_CLASSES, embed_dim=128, width=8, seq_len=16)


class PreTensorSet:
    """In-memory preprocessed dataset (the raw_batches=False contract),
    class-templated so training moves accuracy. `audio` / `visual` give
    the per-sample shapes."""

    def __init__(self, n, seed, audio=SPEC + (1,),
                 visual=(FRAMES, HW, HW, 3)):
        rng = np.random.default_rng(seed)
        ta = rng.standard_normal((N_CLASSES,) + tuple(audio))
        tv = rng.standard_normal((N_CLASSES,) + tuple(visual))
        self.label = rng.integers(0, N_CLASSES, n)
        self.audio = (0.8 * ta[self.label] + rng.standard_normal(
            (n,) + tuple(audio))).astype(np.float32)
        self.visual = (0.8 * tv[self.label] + rng.standard_normal(
            (n,) + tuple(visual))).astype(np.float32)

    def __len__(self):
        return len(self.label)

    def __getitem__(self, i):
        return {"audio": self.audio[i], "visual": self.visual[i],
                "label": np.int32(self.label[i])}


def _files(path):
    """Every file under `path` (relative names)."""
    out = []
    for root, _, names in os.walk(path):
        out += [os.path.relpath(os.path.join(root, n), path) for n in names]
    return sorted(out)


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _training(workdir, cfg, model, train_set, test_set, dgl=True,
              raw_batches=False, guard=None):
    """run_training from `workdir` → (log, generator state, harness)."""
    from gdl_tpu_torch.train.loop import run_training

    os.makedirs(workdir, exist_ok=True)
    here = os.getcwd()
    os.chdir(workdir)
    log, box = [], {}

    def callback(epoch, means, acc, lr, state):
        log.append((epoch, {k: v for k, v in means.items()
                            if not k.startswith("_")}, acc))
        box["h"] = state

    try:
        run_training(cfg, model, train_set, test_set, dgl=dgl,
                     raw_batches=raw_batches, epoch_callback=callback,
                     preempt_guard=guard)
    finally:
        os.chdir(here)
    h = box.get("h")
    return log, (h.generator.get_state() if h is not None else None)


def flagship(workdir, init, **kw):
    """Two epochs of the flagship DGL classifier (tiny) from `init`."""
    from gdl_tpu_torch.models.classifier import AVClassifierDGL

    cfg = Config(**dict(KW, ckpt_path="ckpt", **kw))
    model = AVClassifierDGL(cfg)
    model.load_state_dict(init)
    log, gen = _training(workdir, cfg, model, PreTensorSet(16, 0),
                         PreTensorSet(8, 1))
    return dict(state=_state(model), log=log, gen=gen,
                files=_files(workdir))


def augmented(workdir):
    """Raw batches: the crop and flip drawn on the device from the
    generator (fps 1, two steps an epoch)."""
    from gdl_tpu_torch.data.synthetic import SyntheticDataset
    from gdl_tpu_torch.models.classifier import AVClassifierDGL

    cfg = Config(**dict(KW, ckpt_path="ckpt", fps=1, log_grad_csv=False))
    model = AVClassifierDGL(cfg, generator=torch.Generator().manual_seed(4))
    log, gen = _training(workdir, cfg, model,
                         SyntheticDataset(cfg, size=8, seed=10),
                         SyntheticDataset(cfg, size=4, seed=50),
                         raw_batches=True)
    return dict(state=_state(model), log=log, gen=gen)


def joint(workdir, **kw):
    """The joint lineage under OGM-GE with the PE heads and the modality
    drop on: the coefficients of every step. `kw` overrides the Config."""
    import gdl_tpu_torch.train.joint as joint_mod
    from gdl_tpu_torch.models.classifier import AVClassifier

    coeffs = []
    inner = joint_mod.ogm_coefficients

    def recording(*args):
        out = inner(*args)
        coeffs.append([float(c) for c in out])
        return out

    joint_mod.ogm_coefficients = recording
    try:
        cfg = Config(**dict(KW, ckpt_path="ckpt", modulation="OGM_GE",
                            alpha=0.3, pe=1, beta=0.01, drop=1, **kw))
        model = AVClassifier(cfg, generator=torch.Generator().manual_seed(5))
        log, gen = _training(workdir, cfg, model, PreTensorSet(16, 0),
                             PreTensorSet(8, 1), dgl=False)
    finally:
        joint_mod.ogm_coefficients = inner
    return dict(state=_state(model), log=log, gen=gen, coeffs=coeffs)


def swin(workdir):
    """A tiny Swin DGL classifier with DropPath 0.1."""
    from gdl_tpu_torch.models.classifier import AVClassifierSwinDGL

    cfg = Config(**dict(KW, ckpt_path="ckpt", **SWIN_TINY))
    model = AVClassifierSwinDGL(cfg, drop_path_rate=0.1,
                                generator=torch.Generator().manual_seed(6))
    log, gen = _training(workdir, cfg, model,
                         PreTensorSet(8, 2, (32, 32, 1), (2, 32, 32, 3)),
                         PreTensorSet(4, 3, (32, 32, 1), (2, 32, 32, 3)))
    return dict(state=_state(model), log=log, gen=gen)


def mmformer(batched_inter=False, epochs=2, **kw):
    """A tiny mmformer_n (dropout 0.1 in its blocks and attention) under
    the AUXI step, two epochs; with batched_inter its three fusion passes'
    inter half runs as one [3b] call, whose masks take three segments of
    the stream on each rank. `kw` overrides the Config."""
    from gdl_tpu_torch.models.intermediate import MMFormerN
    from gdl_tpu_torch.train.auxi import make_auxi_train_step
    from gdl_tpu_torch.train.loop import (
        assemble_harness,
        make_loaders,
        train_one_epoch,
    )

    cfg = Config(**dict(KW, ckpt_path="ckpt", alpha=2.0, beta=0.01, **kw))
    model = MMFormerN(generator=torch.Generator().manual_seed(7),
                      batched_inter=batched_inter, **MMF)
    train_set = PreTensorSet(8, 4, (64, 64, 3), (64, 64, 3))
    loader, _ = make_loaders(cfg, train_set, train_set)

    def make_step(model, optimizer, preprocess, generator):
        return make_auxi_train_step(model, cfg, optimizer, seven_tuple=True,
                                    generator=generator, av_inputs=False)

    h = assemble_harness(cfg, model, len(loader), make_step,
                         raw_batches=False)
    losses = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        losses.append(train_one_epoch(h, loader, epoch)["loss"])
    return dict(state=_state(model), losses=losses,
                gen=h.generator.get_state())


def mmformer_batched():
    return mmformer(batched_inter=True)


def preempt(workdir, init):
    """The flagship run stopped by a flag raised on rank 1 alone (after
    its first step; agreement every 2 steps), then resumed from the
    resume state to the end of epoch 1."""
    from gdl_tpu_torch.models.classifier import AVClassifierDGL
    from gdl_tpu_torch.utils.preempt import PreemptionGuard

    os.makedirs(workdir, exist_ok=True)
    ckpt = os.path.join(workdir, "ckpt")  # shared by the ranks
    cfg = Config(**dict(KW, ckpt_path=ckpt, log_grad_csv=False))
    model = AVClassifierDGL(cfg)
    model.load_state_dict(init)
    trigger = 1 if dist.process_index() == 1 else None
    guard = PreemptionGuard(sync_every=2, trigger_after=trigger)
    first, _ = _training(os.path.join(workdir, f"cwd{dist.process_index()}"),
                         cfg, model, PreTensorSet(16, 0), PreTensorSet(8, 1),
                         guard=guard)
    resume = os.path.join(ckpt, "resume_state.pth")
    saved = torch.load(resume, weights_only=False)
    cfg2 = Config(**dict(KW, ckpt_path=ckpt, log_grad_csv=False,
                         resume=resume))
    model2 = AVClassifierDGL(cfg2, generator=torch.Generator().manual_seed(8))
    rest, gen = _training(os.path.join(workdir, f"cwd{dist.process_index()}"),
                          cfg2, model2, PreTensorSet(16, 0),
                          PreTensorSet(8, 1))
    return dict(first=first, step_in_epoch=saved["extra"]["step_in_epoch"],
                resume_epoch=saved["epoch"], rest=rest,
                state=_state(model2), gen=gen)


def bn_inputs():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((4, 3, 5, 6)) * 2 + 1).float()
    g = torch.from_numpy(rng.standard_normal((4, 3, 5, 6))).float()
    return x, g


def global_bn():
    """GlobalBatchNorm2d on this rank's rows of bn_inputs(), two training
    steps: the outputs, input and parameter gradients, running stats."""
    from gdl_tpu_torch.models.layers import batch_norm

    x, g = bn_inputs()
    rows = x.shape[0] // dist.process_count()
    lo = dist.process_index() * rows
    bn = batch_norm(3)
    out = []
    for step in range(2):
        xr = (x[lo:lo + rows] * (step + 1)).requires_grad_(True)
        y = bn(xr)
        (y * g[lo:lo + rows]).sum().backward()
        out.append(dict(y=y.detach(), dx=xr.grad,
                        dw=bn.weight.grad.clone(), db=bn.bias.grad.clone()))
        bn.weight.grad = bn.bias.grad = None
    return dict(steps=out, running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone(),
                tracked=int(bn.num_batches_tracked))


def refusals():
    """check_supported under the process group: --dp 3 against 2 ranks,
    --eval_drop_last 0, --sync_bn 0 with --dp -1 left unresolved."""
    from gdl_tpu_torch.train.loop import check_supported

    out = {}
    for name, kw in (("dp3", dict(dp=3)),
                     ("drop_last", dict(eval_drop_last=False)),
                     ("unresolved_dp", dict(sync_bn=False))):
        try:
            check_supported(Config(**dict(KW, **kw)))
            out[name] = None
        except Exception as e:  # the message is what the test reads
            out[name] = f"{type(e).__name__}: {e}"
    return out


def run_all(out_dir, init):
    r = dist.process_index()
    work = os.path.join(out_dir, "work")
    scenarios = {
        "bn": global_bn,
        "refusals": refusals,
        "sync": lambda: flagship(os.path.join(work, f"sync{r}"), init),
        "nosync": lambda: flagship(os.path.join(work, f"nosync{r}"), init,
                                   sync_bn=False,
                                   dp=dist.process_count()),
        "augmented": lambda: augmented(os.path.join(work, f"aug{r}")),
        "joint": lambda: joint(os.path.join(work, f"joint{r}")),
        "swin": lambda: swin(os.path.join(work, f"swin{r}")),
        "mmformer": mmformer,
        "mmformer_batched": mmformer_batched,
        "preempt": lambda: preempt(os.path.join(work, "preempt"), init),
    }
    for name, fn in scenarios.items():
        result = fn()
        torch.save(result, os.path.join(out_dir, f"{name}_rank{r}.pt"))


def main(argv):
    out_dir, init_path = argv
    torch.set_num_threads(1)
    if not dist.maybe_initialize(device="cpu"):
        raise SystemExit("no process group: set RANK / WORLD_SIZE / "
                         "MASTER_ADDR / MASTER_PORT")
    try:
        run_all(out_dir, torch.load(init_path))
    except Exception:
        traceback.print_exc()
        raise SystemExit(1)
    finally:
        dist.destroy()


if __name__ == "__main__":
    main(sys.argv[1:])
