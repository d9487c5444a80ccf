"""Serving entry of the port: the counterpart of
`gdl_tpu/serve.py::export_from_checkpoint`.

    from gdl_tpu_torch.serve import load_from_checkpoint
    served = load_from_checkpoint(cfg, "best_model.pth", device="cuda")
    out, out_a, out_v = served(audio, visual)   # preprocessed inputs
    result = served.eval_batch(raw_batch)       # raw requests

The model is rebuilt from `cfg` and loaded from a reference-schema
`.pth` ({"model": state_dict}, `module.` prefixes allowed, strict=False
semantics), for either backbone (cfg.backbone "swin" or "resnet") and
either lineage: the DGL classifiers, or with dgl=False the joint ones
of main.py, whose 11-tuple is served as its fused logits (`out` thrice,
the joint eval step's predictions). Where gdl_tpu replays a serialized
jax.export artifact, the port runs the eager module: on the card its
window attention launches the hand-written CUDA kernel.

`load_intermediate_from_checkpoint` is the counterpart of
`gdl_tpu/serve.py::export_intermediate_from_checkpoint` for the
intermediate-fusion family (MMTM, SE-fusion, mmformer-N): it reads a
`.pth` written by `python -m gdl_tpu_torch.main_intermediate`.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from gdl_tpu_torch.config import Config
from gdl_tpu_torch.data.preprocess import make_eval_preprocess
from gdl_tpu_torch.models.classifier import (
    AVClassifier,
    AVClassifierDGL,
    AVClassifierSwin,
    AVClassifierSwinDGL,
    JointLogits,
)
from gdl_tpu_torch.train.dgl import make_eval_step
from gdl_tpu_torch.utils.interop import load_reference_pth

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """torch.device(device), raising where a CUDA device is asked for and
    none is available (never a silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev


class ServedModel:
    """An eval-mode classifier on `device`, called as
    `(audio [B,F,T,1], visual [B,T,224,224,3]) -> (out, out_a, out_v)`.
    A compute dtype of bfloat16 runs under bf16 autocast."""

    def __init__(self, model: torch.nn.Module, cfg: Config, device,
                 compute_dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.model = model.to(self.device).eval().requires_grad_(False)
        self._eval_step = make_eval_step(
            self._forward, make_eval_preprocess(cfg, self.device))

    def _forward(self, audio, visual):
        with torch.autocast(self.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            out = self.model(audio, visual)
        return tuple(o.float() for o in out)

    @torch.inference_mode()
    def __call__(self, audio, visual):
        return self._forward(torch.as_tensor(audio).to(self.device),
                             torch.as_tensor(visual).to(self.device))

    def eval_batch(self, batch: dict) -> dict:
        """Raw batch {'wave', 'frames', 'label'} → preprocessing on the
        device → forward → argmaxes (and logits) of the eval step."""
        return self._eval_step(batch)


def build_model(cfg: Config, attn_impl: str = "auto",
                seed: Optional[int] = None,
                dgl: bool = True) -> torch.nn.Module:
    """The DGL classifier for `cfg` (cfg.backbone "resnet" or "swin"), or
    with dgl=False the joint one (AVClassifier / AVClassifierSwin),
    initialised on the CPU from `seed`. attn_impl is the impl of the
    backbone's hand-written kernels: the Swin window attention and MLP, or
    the ResNet stem max-pool's backward ("auto": the CUDA kernels on the
    card; "plain": their plain PyTorch versions). Under "auto" the Swin
    encoders follow cfg's kernel flags (`use_pallas_attn`,
    `use_pallas_attn_eval`, `fuse_qkv_gemm`, `fuse_mlp`), as
    `AVClassifierSwinDGL` describes; an explicit "plain" wins."""
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    if cfg.backbone == "swin":
        cls = AVClassifierSwinDGL if dgl else AVClassifierSwin
        return cls(cfg, attn_impl=attn_impl, generator=gen)
    if cfg.backbone == "resnet":
        cls = AVClassifierDGL if dgl else AVClassifier
        return cls(cfg, pool_impl=attn_impl, generator=gen)
    raise ValueError(f"unknown backbone {cfg.backbone!r}")


def load_from_checkpoint(cfg: Config, ckpt_path: str, device,
                         compute_dtype: Optional[str] = None,
                         attn_impl: str = "auto",
                         dgl: bool = True) -> ServedModel:
    """Build the DGL classifier for `cfg` (with dgl=False the joint one,
    served as `JointLogits`), load a reference-schema `.pth` into it, and
    return it ready to serve on `device`.

    compute_dtype defaults to cfg.compute_dtype ("float32" or
    "bfloat16"). cfg.backbone selects dual Swin or dual ResNet-18
    encoders. attn_impl="plain" selects the plain PyTorch versions of
    the backbone's kernels (for holding the kernels to them); "auto"
    launches the CUDA kernels on the card."""
    dev = resolve_device(device)
    dtype = _DTYPES[compute_dtype or cfg.compute_dtype]
    model = build_model(cfg, attn_impl=attn_impl, seed=0, dgl=dgl)
    result = model.load_state_dict(load_reference_pth(ckpt_path, cfg),
                                   strict=False)
    if result.missing_keys or result.unexpected_keys:
        warnings.warn(f"checkpoint {ckpt_path}: {len(result.missing_keys)} "
                      f"keys missing (kept current values), "
                      f"{len(result.unexpected_keys)} unused")
    return ServedModel(model if dgl else JointLogits(model), cfg, dev, dtype)


def load_intermediate_from_checkpoint(cfg: Config, model_name: str,
                                      ckpt_path: str, device,
                                      share_streams: bool = False,
                                      batched_inter: bool = False,
                                      compute_dtype: Optional[str] = None,
                                      impl: str = "auto") -> ServedModel:
    """Build the intermediate-family model `model_name` ("mmtm",
    "sefusion", "mmformer_n") at cfg.encoder_width, load a `.pth` that
    `main_intermediate` wrote (strict: every key must match), and return
    it ready to serve on `device`: `(audio [B,F,T,1], visual [B,1,224,224,3])
    -> (out, out_a, out_v)`, the AV adapter inside. share_streams and
    batched_inter do not change eval outputs. impl="plain" selects the
    plain PyTorch versions of the family's kernels."""
    from gdl_tpu_torch.models.intermediate import (
        TripleLogits,
        build_intermediate,
    )

    dev = resolve_device(device)
    dtype = _DTYPES[compute_dtype or cfg.compute_dtype]
    model, kind = build_intermediate(
        model_name, cfg.n_classes, cfg.encoder_width,
        share_streams=share_streams, batched_inter=batched_inter, impl=impl,
        generator=torch.Generator().manual_seed(0))
    model.load_state_dict(load_reference_pth(ckpt_path, cfg), strict=True)
    return ServedModel(TripleLogits(model, kind), cfg, dev, dtype)
