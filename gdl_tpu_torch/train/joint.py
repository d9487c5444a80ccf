"""Joint multimodal training, the main.py (OGM-GE) lineage: port of
`gdl_tpu/train/joint.py`.

One fused CE loss plus, under --pe, the KL regularizer of the PE heads
weighted by --beta (main.py:92-102, :213); the feature-diversity
diagnostics (main.py:77-89); and OGM / OGM-GE per-modality gradient
modulation between the backward and the optimizer (main.py:286-332):
live here as in gdl_tpu, off under --strict_compat and for --modulation
Normal. The order is the reference's: clip the gradient, then modulate
it, then the optimizer (which must not clip again).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models.classifier import JointLogits
from gdl_tpu_torch.parallel.distributed import all_reduce_grads
from gdl_tpu_torch.train.auxi import regurize
from gdl_tpu_torch.train.dgl import cross_entropy, make_eval_step
from gdl_tpu_torch.train.optim import (
    apply_ogm,
    gradient_norm,
    ogm_active,
    ogm_coefficients,
    ogm_targets,
)

CLIP_NORM = 40.0  # main.py:240 clip_grad_norm_(max_norm=40)


def feature_diversity(feat: torch.Tensor) -> torch.Tensor:
    """main.py:77-89 `get_feature_diversity` on an NHWC map, in f32: the
    batch mean of ‖corr‖_F / (HW)², corr the correlation between spatial
    positions over the channels (torch.std unbiased, ddof 1)."""
    b, h, w, c = feat.shape
    f = feat.reshape(b, h * w, c).float()
    f = f - f.mean(dim=2, keepdim=True)
    sim = torch.bmm(f, f.transpose(1, 2))
    std = torch.std(f, dim=2, correction=1)
    sim = sim / (std[:, :, None] * std[:, None, :])
    return (torch.linalg.matrix_norm(sim) / (h * w) ** 2).mean()


def feature_diff(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """main.py:105-122 `get_feature_diff`: both NHWC maps resized to 7×7
    (bilinear, antialiased when it shrinks, as jax.image.resize's
    "linear"), then the MSE over the channel vectors (a cross-modal
    diagnostic; the reference computes it and does not use it)."""

    def pool7(x):
        b, h, w, c = x.shape
        x = x.float()
        if (h, w) != (7, 7):
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(7, 7),
                              mode="bilinear", align_corners=False,
                              antialias=True).permute(0, 2, 3, 1)
        return x.reshape(-1, c)

    return torch.mean((pool7(x1) - pool7(x2)) ** 2)


def joint_loss_fn(model, batch, cfg: Config,
                  generator: Optional[torch.Generator] = None):
    """The joint loss → (loss, metrics): loss = CE(out) + β·(KL_a +
    KL_v), the KL terms only under cfg.pe. loss_a and loss_v are
    reported as loss_f, the reference's overwrite (main.py:179-181). The
    metrics hold out_a / out_v for the modulation; the diagnostics
    (diversity, KL terms) are detached."""
    (a, v, out, a_feature, v_feature, a_mul, a_std, v_mul, v_std, out_a,
     out_v) = model(batch["audio"], batch["visual"], generator)
    loss_f = cross_entropy(out, batch["label"])
    if cfg.pe:
        re_a, re_v = regurize(a_mul, a_std), regurize(v_mul, v_std)
        loss = loss_f + (re_a + re_v) * cfg.beta
    else:
        re_a = re_v = torch.zeros((), device=loss_f.device)
        loss = loss_f
    with torch.no_grad():
        metrics = {"loss_f": loss_f, "loss_a": loss_f, "loss_v": loss_f,
                   "a_diversity": feature_diversity(a_feature),
                   "v_diversity": feature_diversity(v_feature),
                   "a_re": re_a, "v_re": re_v,
                   "out_a": out_a, "out_v": out_v}
    return loss, metrics


def make_joint_train_step(model, cfg: Config, optimizer,
                          steps_per_epoch: int,
                          preprocess: Optional[Callable] = None,
                          generator: Optional[torch.Generator] = None,
                          ogm_noise: Optional[Callable] = None) -> Callable:
    """train_step(batch) -> metrics: one joint step of `model` (put in
    training mode) and `optimizer` (`train.optim.make_optimizer` with
    clip_norm=None).

    After the backward every gradient is scaled by min(1, 40 / (‖g‖ +
    1e-12)) (gdl_tpu's joint clip, joint.py:145-157); then, where
    `train.optim.ogm_active` says so for step optimizer.steps, the
    encoders' conv kernels are modulated (`train.optim.apply_ogm`).
    `generator` feeds the augmentation of `preprocess`, then the model's
    DropPath, PE noise and modality drop, then the OGM-GE noise;
    `ogm_noise(name, shape)` replaces the last draws when given. The
    encoders run once a step, so BatchNorm statistics update once.
    Under a process group the gradients are averaged over the ranks after
    the backward, and the OGM scores are the global batch's. Autocast, if
    wanted, is the caller's.

    The metrics are gdl_tpu's (loss, loss_f/a/v, a/v_diversity,
    a/v_re) plus grad_norm (before the clip), as 0-dim tensors."""
    targets = ogm_targets(model.named_parameters())

    def train_step(batch):
        if preprocess is not None:
            batch = preprocess(batch, generator)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = joint_loss_fn(model, batch, cfg, generator)
        loss.backward()
        all_reduce_grads(model.parameters())

        grads = [p.grad for p in model.parameters() if p.grad is not None]
        gnorm = gradient_norm(model.parameters())
        torch._foreach_mul_(grads, torch.clamp(
            CLIP_NORM / (gnorm + 1e-12), max=1.0))
        if ogm_active(cfg, optimizer.steps, steps_per_epoch):
            coeff_a, coeff_v = ogm_coefficients(
                metrics["out_a"], metrics["out_v"], batch["label"],
                cfg.alpha)
            apply_ogm(targets, coeff_a, coeff_v, cfg.modulation, generator,
                      ogm_noise)
        optimizer.step()
        out = {k: v.detach() for k, v in metrics.items()
               if k not in ("out_a", "out_v")}
        out["loss"] = loss.detach()
        out["grad_norm"] = gnorm
        return out

    return train_step


def make_joint_eval_step(model, preprocess: Optional[Callable] = None
                         ) -> Callable:
    """eval_step(batch) -> the argmax of the fused logits as pred, pred_a
    and pred_v (the reference's valid() overwrites out_a / out_v with
    out, main.py:459-460), the label and the logits, as
    `train.dgl.make_eval_step` gives them."""
    return make_eval_step(JointLogits(model), preprocess)
