"""DGL steps, port of `gdl_tpu/train/dgl.py`.

The reference (main_dgl.py:69-165) runs two backwards per step and
erases the fusion head's gradients in between. Like gdl_tpu, the port
runs ONE backward of

    loss = α·(CE(out_a) + CE(out_v)) + CE(out)

where out_a/out_v come from the fusion head with its parameters
detached (`model.unimodal_logits`, the erasure done beforehand) and out
from the head with the features detached (`model.fused_logits`). So the
encoders learn from α·(CE_a + CE_v) alone and the head from CE_f alone.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.parallel.distributed import all_reduce_, all_reduce_grads
from gdl_tpu_torch.parallel.mesh import model_group, model_size
from gdl_tpu_torch.parallel.row_parallel import is_sharded
from gdl_tpu_torch.train.optim import gradient_norm


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """nn.CrossEntropyLoss(): mean softmax CE over the batch, in f32."""
    return F.cross_entropy(logits.float(), labels.long())


def _encoder_grad_probe(named_params: Dict[str, torch.Tensor],
                        prefix: str) -> torch.Tensor:
    """Σ over the parameters whose name contains `prefix` of mean|grad|
    (main_dgl.py:132-143), over the whole gradient of a row-parallel
    shard (`--mp`: its Σ|g| summed over the model group). A parameter
    without a gradient adds 0."""
    params = [p for name, p in named_params.items() if prefix in name]
    if not params:
        return torch.zeros(())
    l1 = list(torch._foreach_norm([p.grad.float() for p in params], 1))
    numel = [p.numel() for p in params]
    split = [i for i, p in enumerate(params) if is_sharded(p)]
    if split:
        sums = all_reduce_(torch.stack([l1[i] for i in split]),
                           group=model_group())
        for j, i in enumerate(split):
            l1[i], numel[i] = sums[j], numel[i] * model_size()
    return sum(n / k for n, k in zip(l1, numel))


def dgl_loss_fn(model, batch: Dict[str, torch.Tensor], cfg: Config,
                generator: Optional[torch.Generator] = None):
    """The DGL training loss → (loss, metrics). batch: audio [B,F,T,1],
    visual [B,T,H,W,3], label [B]. `generator` feeds DropPath.

    With modality != "full" the three CE terms of the reference are one
    CE of the same logits, so the loss is (2α+1)·CE (gdl_tpu's rule)."""
    label = batch["label"]
    if cfg.modality != "full":
        out, _, _ = model(batch["audio"], batch["visual"], generator)
        ce = cross_entropy(out, label)
        metrics = {"loss_f": ce, "loss_a": ce, "loss_v": ce,
                   "out": out, "out_a": out, "out_v": out}
        return (2.0 * cfg.alpha + 1.0) * ce, metrics

    a, v = model.encode(batch["audio"], batch["visual"], generator)
    out_a, out_v = model.unimodal_logits(a, v)
    out = model.fused_logits(a, v)
    loss_a = cross_entropy(out_a, label)
    loss_v = cross_entropy(out_v, label)
    loss_f = cross_entropy(out, label)
    loss = cfg.alpha * (loss_a + loss_v) + loss_f
    metrics = {"loss_f": loss_f, "loss_a": loss_a, "loss_v": loss_v,
               "out": out, "out_a": out_a, "out_v": out_v}
    return loss, metrics


def make_dgl_train_step(model, cfg: Config, optimizer,
                        clip_norm: float = 40.0,
                        preprocess: Optional[Callable] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Callable:
    """train_step(batch) -> metrics: one DGL step of `model` (put in
    training mode) and `optimizer` (`train.optim.make_optimizer`).

    A model with BatchNorm updates its running statistics once per step:
    the loss runs the encoders once, in training mode, as gdl_tpu's step
    mutates its batch_stats once (`gdl_tpu/train/dgl.py:126-143`). The
    buffers are not parameters, so they reach neither the global norm
    nor the optimizer.

    With `preprocess` (`data.preprocess.make_train_preprocess`) the batch
    arrives raw and is preprocessed on the device inside the step.
    `generator` (on the model's device) feeds the augmentation and then
    DropPath, in that order; None uses torch's default generator.
    Autocast, if wanted, is the caller's: it wraps the step.

    Under a process group the gradients are averaged over the ranks
    after the backward (`parallel.distributed.all_reduce_grads`; no
    collective at world size 1), so the clip and the update see the
    global batch's gradient; the metrics stay this rank's.

    The metrics are gdl_tpu's, as 0-dim tensors on the device: loss,
    loss_f/a/v, audio/visual_grad_sum (post-clip per-encoder Σ mean|g|;
    0 unless cfg.log_grad_csv), abs_out_a/v (mean |unimodal logits|) and
    grad_norm (before the clip)."""

    def train_step(batch):
        if preprocess is not None:
            batch = preprocess(batch, generator)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = dgl_loss_fn(model, batch, cfg, generator)
        loss.backward()
        all_reduce_grads(model.parameters())

        named = {n: p for n, p in model.named_parameters()
                 if p.grad is not None}
        gnorm = gradient_norm(model.parameters())
        clip_coef = torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)
        zero = torch.zeros((), device=gnorm.device)
        audio_probe = visual_probe = zero
        if cfg.log_grad_csv:  # diagnostics only
            if cfg.modality in ("full", "audio"):
                audio_probe = clip_coef * _encoder_grad_probe(named,
                                                              "audio_net")
            if cfg.modality in ("full", "visual"):
                visual_probe = clip_coef * _encoder_grad_probe(named,
                                                               "visual_net")
        optimizer.step(grad_norm=gnorm)
        return {
            "loss": loss.detach(),
            "loss_f": metrics["loss_f"].detach(),
            "loss_a": metrics["loss_a"].detach(),
            "loss_v": metrics["loss_v"].detach(),
            "audio_grad_sum": audio_probe,
            "visual_grad_sum": visual_probe,
            "abs_out_a": metrics["out_a"].detach().float().abs().mean(),
            "abs_out_v": metrics["out_v"].detach().float().abs().mean(),
            "grad_norm": gnorm,
        }

    return train_step


def make_eval_step(model, preprocess: Optional[Callable] = None) -> Callable:
    """eval_step(batch) -> per-example argmaxes of the three logits, the
    label, and the logits themselves under 'logits' (out, out_a, out_v).

    An nn.Module is put in eval mode (BatchNorm then uses its running
    statistics, main_dgl.py:186; the train step puts it back in training
    mode); a plain callable is used as it is. The caller chooses the
    autocast dtype."""

    @torch.inference_mode()
    def eval_step(batch):
        if isinstance(model, torch.nn.Module):
            model.eval()
        if preprocess is not None:
            batch = preprocess(batch)
        out, out_a, out_v = model(batch["audio"], batch["visual"])
        return {
            "pred": out.argmax(dim=-1),
            "pred_a": out_a.argmax(dim=-1),
            "pred_v": out_v.argmax(dim=-1),
            "label": batch["label"],
            "logits": (out, out_a, out_v),
        }

    return eval_step
