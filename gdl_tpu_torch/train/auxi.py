"""AUXI multi-task training for the intermediate-fusion nets, port of
`gdl_tpu/train/auxi.py` (and of the plain-CE step of
`main_intermediate.py` for SE-fusion).

    loss = α·(CE_a + CE_b) + CE_fused + β·KL

with every parameter live; the KL term (`regurize`) exists for
SURF_Fomer_N's 7-tuple, whose PE heads return (mu, std). One backward,
the global-norm clip and SGD of `train/optim.py`.

BatchNorm statistics are updated by every call of a module in training
mode, in call order: with `share_streams` each token-projection
BatchNorm of MMFormerN runs twice a step (live input, zero input),
without it three times, as gdl_tpu's mutable batch_stats compound.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.parallel.distributed import all_reduce_grads
from gdl_tpu_torch.train.dgl import cross_entropy
from gdl_tpu_torch.train.optim import gradient_norm


def regurize(mu: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, std²) ‖ N(0, 1)) regularizer, main.py:62-65 (the reference
    hardcodes /64; the mean over the batch matches it at batch 64)."""
    mu, std = mu.float(), std.float()
    var = std ** 2
    kl = 0.5 * (mu ** 2 + var - torch.log(var + 1e-8) - 1.0)
    return kl.reshape(kl.shape[0], -1).sum(dim=1).mean()


def auxi_loss_fn(model, batch, cfg: Config, seven_tuple: bool,
                 generator: Optional[torch.Generator] = None,
                 **forward_kwargs):
    """The AUXI training loss → (loss, metrics)."""
    outputs = model(batch["audio"], batch["visual"], generator,
                    **forward_kwargs)
    labels = batch["label"]
    if seven_tuple:
        x_f, mu_a, std_a, mu_b, std_b, x_a, x_b = outputs
        kl = regurize(mu_a, std_a) + regurize(mu_b, std_b)
    else:
        x_f, x_a, x_b = outputs
        kl = 0.0
    loss_f = cross_entropy(x_f, labels)
    loss_a = cross_entropy(x_a, labels)
    loss_b = cross_entropy(x_b, labels)
    loss = cfg.alpha * (loss_a + loss_b) + loss_f + cfg.beta * kl
    return loss, {"loss_f": loss_f, "loss_a": loss_a, "loss_v": loss_b}


def sefusion_loss_fn(model, batch, cfg: Config,
                     generator: Optional[torch.Generator] = None,
                     **forward_kwargs):
    """Plain CE for SURF_Multi's single-logits forward (sefusion.py:52-63)."""
    out = model(batch["audio"], batch["visual"], generator, **forward_kwargs)
    loss = cross_entropy(out, batch["label"])
    return loss, {"loss_f": loss, "loss_a": loss, "loss_v": loss}


def _make_step(model, optimizer, loss_fn: Callable,
               preprocess: Optional[Callable],
               generator: Optional[torch.Generator]) -> Callable:
    def train_step(batch):
        if preprocess is not None:
            batch = preprocess(batch, generator)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch)
        loss.backward()
        all_reduce_grads(model.parameters())  # the global batch's mean
        gnorm = gradient_norm(model.parameters())
        optimizer.step(grad_norm=gnorm)
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        out["grad_norm"] = gnorm
        return out

    return train_step


def make_auxi_train_step(model, cfg: Config, optimizer,
                         seven_tuple: bool = False,
                         preprocess: Optional[Callable] = None,
                         generator: Optional[torch.Generator] = None,
                         **forward_kwargs) -> Callable:
    """train_step(batch) -> metrics: one AUXI step of `model` and
    `optimizer` (`train.optim.make_optimizer`, which holds the clip).

    seven_tuple=False: the model returns (out, out_a, out_b) (MMTMNet);
    seven_tuple=True: SURF_Fomer_N's (x_f, mu_a, std_a, mu_b, std_b, x_a,
    x_b) with the KL regularizer weighted by cfg.beta. `generator` feeds
    the augmentation of `preprocess`, then the model's dropout, PE noise
    and modality drop. Autocast, if wanted, is the caller's. The metrics
    are gdl_tpu's (loss, loss_f/a/v) plus grad_norm (before the clip), as
    0-dim tensors on the device."""

    def loss_fn(batch):
        return auxi_loss_fn(model, batch, cfg, seven_tuple, generator,
                            **forward_kwargs)

    return _make_step(model, optimizer, loss_fn, preprocess, generator)


def make_sefusion_step(model, cfg: Config, optimizer,
                       preprocess: Optional[Callable] = None,
                       generator: Optional[torch.Generator] = None,
                       **forward_kwargs) -> Callable:
    """train_step(batch) -> metrics for a single-logits model: plain CE."""

    def loss_fn(batch):
        return sefusion_loss_fn(model, batch, cfg, generator,
                                **forward_kwargs)

    return _make_step(model, optimizer, loss_fn, preprocess, generator)
