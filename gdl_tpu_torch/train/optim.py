"""Optimizers, LR schedule and the OGM / OGM-GE gradient modulation,
port of `gdl_tpu/train/optim.py`.

The reference trains DGL with a global-norm clip at 40 followed by torch
SGD (momentum 0.9, not Nesterov; coupled weight decay 1e-4, added to the
clipped gradient before the momentum buffer) under MultiStepLR stepped at
the top of every epoch. gdl_tpu's optax chain is clip → add_decayed_weights
→ trace → −lr(step); `ClippedSGD` is the same chain on torch SGD.
`ClippedAdaGrad` is gdl_tpu's clip → scale_by_rss(0, eps 1e-10) → −lr and
`ClippedAdamW` its clip → scale_by_adam(0.9, 0.999, 1e-8) → decoupled
decay 0.01 → −lr (torch AdamW(weight_decay=0.01)); neither has a schedule
in the reference, so lr_for_epoch gives them the base rate.

The clip is optax's rule: keep the gradient when ‖g‖ < max_norm, else use
g/‖g‖·max_norm (torch's clip_grad_norm_ adds 1e-6 to ‖g‖; this does not).
clip_norm=None leaves it out: the joint step clips before it modulates
and the optimizer must not clip the modulated gradients again.

Dead fusion parameters: gdl_tpu's `dead_fusion_param_mask` exempts the
concat-DGL head's `fc_auxi`, which never gets a gradient, from weight
decay, because torch SGD skips a parameter whose grad is None. Here
nothing is needed for that: the port never computes a gradient for
`fc_auxi`, its `.grad` stays None, and every optimizer here skips it (no
decay, no momentum, no accumulator), so it stays at its initial value.

`ogm_coefficients` and `apply_ogm` are the OGM / OGM-GE modulation of
the joint step (main.py:286-332): per-modality coefficients from the
ratio of the label's softmax scores, applied to the encoders' 4-D conv
kernels, with Gaussian noise of the gradient's own spread under OGM-GE.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.parallel.distributed import all_reduce_
from gdl_tpu_torch.parallel.mesh import data_group, model_group, model_size
from gdl_tpu_torch.parallel.row_parallel import is_sharded

MOMENTUM = 0.9
WEIGHT_DECAY = 1e-4  # coupled: added to the clipped gradient
ADAMW_WEIGHT_DECAY = 0.01  # decoupled, torch AdamW's default
ADAGRAD_EPS = 1e-10


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


def gradient_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """‖g‖ of the gradients of `params` that have one: `global_norm` of
    them, or under `--mp` √(Σ of the replicated ‖g‖² + the model group's
    sum of the shards' Σ ‖g‖²) in f32, the whole gradient's norm on every
    model rank (optax.global_norm's sum in another order, which gdl_tpu
    takes under mp > 1)."""
    params = [p for p in params if p.grad is not None]
    if model_size() == 1 or not params:
        return global_norm(p.grad for p in params)

    def squares(part):
        if not part:
            return torch.zeros((), device=params[0].grad.device)
        norms = torch._foreach_norm([p.grad.float() for p in part])
        return torch.stack(norms).square().sum()

    whole = squares([p for p in params if not is_sharded(p)])
    split = squares([p for p in params if is_sharded(p)])
    return torch.sqrt(whole + all_reduce_(split, group=model_group()))


class _Scheduled:
    """The clip and the schedule in front of a torch optimizer's update:
    clip(max_norm) unless clip_norm is None, then lr = schedule(k) for
    the k-th step. Parameters whose grad is None are skipped."""

    def _setup(self, schedule: Callable[[int], float],
               clip_norm: Optional[float]) -> None:
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.steps = 0

    @torch.no_grad()
    def step(self, closure=None, grad_norm: Optional[torch.Tensor] = None):
        """One update. `grad_norm` may pass ‖g‖ already computed from the
        same gradients (the train step reports it)."""
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        if grads and self.clip_norm is not None:
            norm = gradient_norm(params) if grad_norm is None else grad_norm
            coef = torch.where(norm < self.clip_norm,
                               torch.ones_like(norm),
                               self.clip_norm / norm)
            torch._foreach_mul_(grads, coef)
        lr = self.schedule(self.steps)
        for group in self.param_groups:
            group["lr"] = lr
        super().step()
        self.steps += 1


class ClippedSGD(_Scheduled, torch.optim.SGD):
    """clip(max_norm) → SGD(momentum 0.9, coupled weight decay 1e-4) at
    lr = schedule(k) for the k-th step."""

    def __init__(self, params, schedule: Callable[[int], float],
                 clip_norm: Optional[float] = 40.0):
        super().__init__(params, lr=schedule(0), momentum=MOMENTUM,
                         weight_decay=WEIGHT_DECAY, nesterov=False)
        self._setup(schedule, clip_norm)


class ClippedAdamW(_Scheduled, torch.optim.AdamW):
    """clip(max_norm) → AdamW(betas (0.9, 0.999), eps 1e-8, decoupled
    weight decay 0.01): optax's scale_by_adam then add_decayed_weights,
    the same update up to rounding."""

    def __init__(self, params, schedule: Callable[[int], float],
                 clip_norm: Optional[float] = 40.0):
        super().__init__(params, lr=schedule(0), betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=ADAMW_WEIGHT_DECAY)
        self._setup(schedule, clip_norm)


class _RSS(torch.optim.Optimizer):
    """optax.scale_by_rss(initial_accumulator_value=0, eps) → −lr:
    acc += g², p -= lr · g · rsqrt(acc + eps). (torch's Adagrad divides
    by sqrt(acc) + eps instead, which moves an element whose gradients
    are near sqrt(eps) by up to 30% more.)"""

    def __init__(self, params, lr: float, eps: float):
        super().__init__(params, dict(lr=lr, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            accs = []
            for p in params:
                state = self.state[p]
                if "sum" not in state:
                    state["sum"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                accs.append(state["sum"])
            torch._foreach_addcmul_(accs, grads, grads)
            scale = torch._foreach_add(accs, group["eps"])
            torch._foreach_rsqrt_(scale)
            torch._foreach_mul_(scale, grads)
            torch._foreach_add_(params, scale, alpha=-group["lr"])


class ClippedAdaGrad(_Scheduled, _RSS):
    """clip(max_norm) → AdaGrad as gdl_tpu's optax chain computes it
    (initial accumulator 0, eps 1e-10)."""

    def __init__(self, params, schedule: Callable[[int], float],
                 clip_norm: Optional[float] = 40.0):
        super().__init__(params, lr=schedule(0), eps=ADAGRAD_EPS)
        self._setup(schedule, clip_norm)


_OPTIMIZERS = {"sgd": ClippedSGD, "AdaGrad": ClippedAdaGrad,
               "Adam": ClippedAdamW}


def make_optimizer(cfg: Config, params, steps_per_epoch: int,
                   clip_norm: Optional[float] = 40.0) -> _Scheduled:
    """The update of a reference run over `params` (cfg.optimizer "sgd",
    "AdaGrad" or "Adam", the last torch AdamW as in the reference).
    clip_norm=None gives a chain with no clip (the joint step's)."""
    if cfg.optimizer not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer}")
    return _OPTIMIZERS[cfg.optimizer](
        params, make_lr_schedule(cfg, steps_per_epoch), clip_norm)


# ---------------------------------------------------------------------------
# OGM / OGM-GE gradient modulation (main.py:286-332)
# ---------------------------------------------------------------------------


def ogm_coefficients(out_a: torch.Tensor, out_v: torch.Tensor,
                     labels: torch.Tensor, alpha: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coeff_a, coeff_v) from the ratio of the summed softmax scores of
    the labels (main.py:287-306), in f32 under any autocast: the
    modality with the larger score gets 1 - tanh(α · relu(ratio)), the
    other 1. Under a process group the scores are summed over the data
    group's rows (one all-reduce), so every rank gets the global batch's
    coefficients."""
    idx = torch.arange(labels.shape[0], device=labels.device)
    labels = labels.long()
    scores = torch.stack([
        torch.softmax(out.float(), dim=-1)[idx, labels].sum()
        for out in (out_a, out_v)])
    score_a, score_v = all_reduce_(scores, group=data_group())
    ratio_v = score_v / score_a
    ratio_a = 1.0 / ratio_v
    v_big = ratio_v > 1.0
    one = torch.ones_like(ratio_v)
    coeff_v = torch.where(v_big, 1.0 - torch.tanh(alpha * torch.relu(ratio_v)),
                          one)
    coeff_a = torch.where(v_big, one,
                          1.0 - torch.tanh(alpha * torch.relu(ratio_a)))
    return coeff_a, coeff_v


def ogm_active(cfg: Config, step: int, steps_per_epoch: int) -> bool:
    """Whether the k-th step (0-indexed) modulates: OGM or OGM_GE without
    --strict_compat, inside modulation_starts ≤ epoch ≤ modulation_ends
    for epoch = step // steps_per_epoch (gdl_tpu/train/joint.py:130-165)."""
    epoch = step // steps_per_epoch
    return (cfg.modulation in ("OGM", "OGM_GE") and not cfg.strict_compat
            and cfg.modulation_starts <= epoch <= cfg.modulation_ends)


def ogm_noise(shape, generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """OGM-GE's standard-normal draw for one gradient, f32 on `device`
    from the explicit generator."""
    src = generator.device if generator is not None else device
    return torch.randn(tuple(shape), generator=generator, device=src,
                       dtype=torch.float32).to(device)


def ogm_targets(named_params: Iterable[Tuple[str, torch.nn.Parameter]]
                ) -> list:
    """[(name, parameter, "audio" | "visual")] of the parameters OGM
    modulates: 4-D (conv kernels) under a top-level module whose name
    holds "audio" or "visual" (main.py:315-318; with --pe the PE heads'
    convs too), in named_parameters order."""
    out = []
    for name, p in named_params:
        top = name.split(".", 1)[0]
        modality = ("audio" if "audio" in top
                    else "visual" if "visual" in top else None)
        if modality is not None and p.dim() == 4:
            out.append((name, p, modality))
    return out


@torch.no_grad()
def apply_ogm(targets: Sequence, coeff_a: torch.Tensor,
              coeff_v: torch.Tensor, mode: str,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Callable] = None) -> None:
    """Scale, in place, the gradient of each of `targets` (`ogm_targets`)
    by its modality's coefficient; under OGM_GE add N(0, 1) · (std(g) +
    1e-8), std the population one of the unscaled gradient
    (main.py:314-330). The draws come from `noise(name, shape)` if given,
    else from `generator`, in targets' order. The caller applies it only
    inside the modulation's epoch window."""
    if mode not in ("OGM", "OGM_GE"):
        return
    for name, p, modality in targets:
        g = p.grad
        if g is None:
            continue
        coeff = coeff_a if modality == "audio" else coeff_v
        if mode == "OGM_GE":
            eps = (noise(name, g.shape) if noise is not None
                   else ogm_noise(g.shape, generator, g.device))
            spread = torch.std(g, correction=0) + 1e-8
            g.mul_(coeff).add_(eps.to(g.dtype) * spread)
        else:
            g.mul_(coeff)
