"""The DGL training step and the eval forward, in plain PyTorch.

One step (the reference's `main_dgl.py` train loop, its two backwards
with the fusion gradients erased in between, written as one loss):

    loss = α · (CE(out_a) + CE(out_v)) + CE(out)

out_a / out_v from the head with its parameters detached, out from the
detached features; then the global-norm clip at 40 (kept when the norm
is under 40, else scaled to 40) and SGD with momentum 0.9 and coupled
weight decay 1e-4 (torch SGD's update; its first step takes the
momentum buffer as the decayed gradient). A parameter without a
gradient (`fc_auxi`) is skipped, as torch SGD skips it.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.harness.weights import load_weights
from portbench.reference.models import DGLClassifier
from portbench.reference.preprocess import (
    eval_inputs,
    to_device,
    train_inputs,
)

CLIP = 40.0
MOMENTUM = 0.9
WEIGHT_DECAY = 1e-4


class ReferenceTrainer:
    """The reference's model, optimizer state and augmentation generator.
    `half_batch` plants a fault (the step sees the first half of each
    batch's rows), for reading what such a fault reads."""

    def __init__(self, config: dict, seed: int, device, aug_seed: int,
                 half_batch: bool = False):
        self.config = config
        self.recipe = config["recipe"]
        self.model = reference_model(config, seed, device)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(aug_seed)
        self.momentum: Dict[str, torch.Tensor] = {}
        self.half_batch = half_batch
        self.steps = 0

    def step(self, raw: dict, keep_grads: bool = False):
        """One training step on a raw host batch → (loss, the clipped
        gradients {name: tensor} the update took, or None)."""
        batch = to_device(raw, self.device)
        if self.half_batch:
            keep = batch["label"].shape[0] // 2
            batch = {k: v[:keep] for k, v in batch.items()}
        audio, visual, label = train_inputs(batch, self.config, self.gen)
        model = self.model.train()
        a, v = model.features(audio, visual, label.shape[0], self.gen)
        out, out_a, out_v = model.logits(a, v, detach_head=True)
        alpha = self.recipe["alpha"]
        loss = (alpha * (F.cross_entropy(out_a, label)
                         + F.cross_entropy(out_v, label))
                + F.cross_entropy(out, label))
        params = {n: p for n, p in model.named_parameters()}
        for p in params.values():
            p.grad = None
        loss.backward()
        grads = {n: p.grad for n, p in params.items() if p.grad is not None}
        norm = torch.sqrt(sum(g.float().square().sum()
                              for g in grads.values()))
        coef = torch.where(norm < CLIP, torch.ones_like(norm), CLIP / norm)
        lr = self.recipe["learning_rate"]
        with torch.no_grad():
            for n, g in grads.items():
                g.mul_(coef)
                d = g + WEIGHT_DECAY * params[n]
                if n in self.momentum:
                    self.momentum[n].mul_(MOMENTUM).add_(d)
                else:
                    self.momentum[n] = d.clone()
                params[n].sub_(lr * self.momentum[n])
        self.steps += 1
        if not keep_grads:
            return float(loss.detach()), None
        return float(loss.detach()), {n: g.detach().clone()
                                      for n, g in grads.items()}


def reference_model(config: dict, seed: int, device) -> DGLClassifier:
    """The reference model on `device` with the seeded weights."""
    with torch.device(device):
        model = DGLClassifier(config).to(device)
    load_weights(model, seed, config["init"])
    return model


@torch.no_grad()
def eval_logits(model: DGLClassifier, config: dict, raw: dict, device):
    """(out, out_a, out_v) of the eval forward of a raw batch."""
    audio, visual, label = eval_inputs(to_device(raw, device), config)
    return model.eval()(audio, visual, label.shape[0])
