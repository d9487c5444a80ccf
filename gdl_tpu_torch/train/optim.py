"""Optimizer and LR schedule, port of `gdl_tpu/train/optim.py` (SGD).

The reference trains DGL with a global-norm clip at 40 followed by torch
SGD (momentum 0.9, not Nesterov; coupled weight decay 1e-4, added to the
clipped gradient before the momentum buffer) under MultiStepLR stepped at
the top of every epoch. gdl_tpu's optax chain is clip → add_decayed_weights
→ trace → −lr(step); `ClippedSGD` is the same chain on torch SGD.

The clip is optax's rule: keep the gradient when ‖g‖ < max_norm, else use
g/‖g‖·max_norm (torch's clip_grad_norm_ adds 1e-6 to ‖g‖; this does not).

Dead fusion parameters: gdl_tpu's `dead_fusion_param_mask` exempts the
concat-DGL head's `fc_auxi`, which never gets a gradient, from weight
decay, because torch SGD skips a parameter whose grad is None. Here
nothing is needed for that: the port never computes a gradient for
`fc_auxi`, its `.grad` stays None, and torch SGD skips it (no decay, no
momentum), so it stays at its initial value.

AdaGrad, Adam and the OGM modulation come with the joint-lineage slice.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from gdl_tpu_torch.config import Config

MOMENTUM = 0.9
WEIGHT_DECAY = 1e-4  # coupled: added to the clipped gradient


def lr_for_epoch(cfg: Config, epoch: int) -> float:
    """LR in effect during 0-indexed `epoch` under the reference schedule:
    MultiStepLR stepped at the TOP of each epoch, so milestone m takes
    effect during epoch m-1; with cfg.warmup, a linear warmup over
    cfg.total_epoch epochs first."""
    base = cfg.learning_rate
    if cfg.optimizer != "sgd":
        return base
    if getattr(cfg, "warmup", False):
        e = epoch + 1
        if e <= cfg.total_epoch:
            return base * (float(e) / cfg.total_epoch)
        decays = sum(1 for m in cfg.lr_decay_step
                     if (e - cfg.total_epoch) >= m)
        return base * (cfg.lr_decay_ratio ** decays)
    decays = sum(1 for m in cfg.lr_decay_step if epoch + 1 >= m)
    return base * (cfg.lr_decay_ratio ** decays)


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable:
    """schedule(step) -> the LR of optimizer step `step` (0-indexed)."""

    def schedule(step: int) -> float:
        return lr_for_epoch(cfg, step // steps_per_epoch)

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) over the tensors, in f32, on their device (no host
    sync)."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class ClippedSGD(torch.optim.SGD):
    """clip(max_norm) → SGD(momentum 0.9, coupled weight decay 1e-4) at
    lr = schedule(k) for the k-th step. Parameters whose grad is None
    are skipped, as torch SGD skips them."""

    def __init__(self, params, schedule: Callable[[int], float],
                 clip_norm: float = 40.0):
        super().__init__(params, lr=schedule(0), momentum=MOMENTUM,
                         weight_decay=WEIGHT_DECAY, nesterov=False)
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.steps = 0

    @torch.no_grad()
    def step(self, closure=None, grad_norm: Optional[torch.Tensor] = None):
        """One update. `grad_norm` may pass ‖g‖ already computed from the
        same gradients (the train step reports it)."""
        if closure is not None:
            raise ValueError("ClippedSGD takes no closure")
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if grads:
            norm = global_norm(grads) if grad_norm is None else grad_norm
            coef = torch.where(norm < self.clip_norm,
                               torch.ones_like(norm),
                               self.clip_norm / norm)
            torch._foreach_mul_(grads, coef)
        lr = self.schedule(self.steps)
        for group in self.param_groups:
            group["lr"] = lr
        super().step()
        self.steps += 1


def make_optimizer(cfg: Config, params, steps_per_epoch: int,
                   clip_norm: float = 40.0) -> ClippedSGD:
    """The update of a reference DGL run over `params`."""
    if cfg.optimizer == "sgd":
        return ClippedSGD(params, make_lr_schedule(cfg, steps_per_epoch),
                          clip_norm)
    if cfg.optimizer in ("AdaGrad", "Adam"):
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported to gdl_tpu_torch "
            f"yet (it comes with the joint/OGM-GE slice)")
    raise ValueError(f"unknown optimizer {cfg.optimizer}")
