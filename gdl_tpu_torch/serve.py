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

The serving artifact, gdl_tpu's ahead-of-time export, through
`torch.export`:

    python -m gdl_tpu_torch.valid --ckpt_path best.pth --export_path m.pt2
    from gdl_tpu_torch.serve import load_exported
    out, out_a, out_v = load_exported("m.pt2", "cuda").call(audio, visual)

`export_eval` traces a model's eval forward (weights included) into a
`torch.export.ExportedProgram`, with the batch pinned or, under
poly_batch, one symbolic `torch.export.Dim` shared by dim 0 of every
input. A compute dtype of bfloat16 traces the forward under bf16
autocast, which the program keeps as autocast regions that follow the
rules of the device it runs on; outputs are float32, as `ServedModel`
returns them. On the card, the model's eval kernels #1
(window attention), #13 (self-attention) and #15 (the fused MLP) are
recorded as the operators `gdl_tpu_torch::wa_qkv_fused_eval`,
`::sa_fused_eval` and `::mlp_fused_fwd`, registered for CUDA alone: a
replay launches the same kernels and counts them in
`kernels.launch_counts`. Such an operator has no CPU implementation, so
`export_from_checkpoint` and `export_intermediate_from_checkpoint` build
the model with the plain versions wherever the artifact is to serve on
the CPU or at any batch (gdl_tpu's rule for its Pallas kernels), and a
fixed-shape CUDA-only artifact keeps the kernels.

Devices: an artifact names the devices it serves on (`devices`). The
file holds ONE program, traced once on one device and saved with its
weights on the CPU; `load_exported(path, device)` moves it to the
device asked for (`torch.export.passes.move_to_device_pass`, which also
moves the devices the forward wrote into its graph, such as that of an
`arange`; its autocast regions are set to that device), and raises,
naming it, for a device the artifact was not exported for. Loading needs
the port's operators registered, so `load_exported` imports
`gdl_tpu_torch.ops`: the counterpart of gdl_tpu's custom calls needing
their TPU runtime.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import warnings
from typing import Optional, Sequence

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
from gdl_tpu_torch.parallel.distributed import local_device
from gdl_tpu_torch.train.dgl import make_eval_step
from gdl_tpu_torch.utils.interop import load_reference_pth
from gdl_tpu_torch.utils.profiling import annotate

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """torch.device(device), raising where a CUDA device is asked for and
    none is available (never a silent fall back to the CPU). Under a
    process group, "cuda" without an index is this rank's card,
    cuda:LOCAL_RANK (`parallel.distributed.local_device`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return local_device(dev)


class _EvalForward(torch.nn.Module):
    """`model(audio, visual, **apply_kwargs)` under bf16 autocast when
    compute_dtype is bfloat16, its tensor outputs float32: the forward
    that `ServedModel` runs and `export_eval` traces."""

    def __init__(self, model: torch.nn.Module, compute_dtype: torch.dtype,
                 device_type: str, apply_kwargs: Optional[dict] = None):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype
        self.device_type = device_type
        self.apply_kwargs = dict(apply_kwargs or {})

    def forward(self, audio, visual):
        with torch.autocast(self.device_type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            out = self.model(audio, visual, **self.apply_kwargs)
        if isinstance(out, torch.Tensor):
            return out.float()
        return tuple(o.float() if isinstance(o, torch.Tensor) else o
                     for o in out)


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
        self._forward = _EvalForward(self.model, compute_dtype,
                                     self.device.type)
        self._eval_step = make_eval_step(
            self._forward, make_eval_preprocess(cfg, self.device))
        self._requests = 0  # the unit of the next request's spans

    @torch.inference_mode()
    def __call__(self, audio, visual):
        return self._forward(torch.as_tensor(audio).to(self.device),
                             torch.as_tensor(visual).to(self.device))

    def eval_batch(self, batch: dict) -> dict:
        """Raw batch {'wave', 'frames', 'label'} → preprocessing on the
        device → forward → argmaxes (and logits) of the eval step; the
        span `request` while a profiler records."""
        unit, self._requests = self._requests, self._requests + 1
        with annotate("request", unit=unit):
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


_EXPORT_META = "gdl_tpu_torch_export.json"


class Exported:
    """A serving artifact on one device: `.call(audio, visual)` replays the
    traced eval forward (the counterpart of gdl_tpu's `jax.export`
    Exported). `program` is the `torch.export.ExportedProgram`; `devices`
    the devices the artifact serves on; a fixed-shape artifact raises for
    inputs of another shape."""

    def __init__(self, program, devices: Sequence[str], device,
                 poly_batch: bool):
        self.program = program
        self.devices = tuple(devices)
        self.device = torch.device(device)
        self.poly_batch = poly_batch
        self._module = None

    def call(self, audio, visual):
        if self._module is None:
            self._module = self.program.module()
        audio, visual = (torch.as_tensor(t).to(self.device, torch.float32)
                         for t in (audio, visual))
        with torch.inference_mode():
            return self._module(audio, visual)


def _check_devices(devices: Sequence[str]) -> tuple:
    devices = tuple(devices)
    unknown = [d for d in devices if d not in ("cpu", "cuda")]
    if not devices or unknown:
        raise ValueError(f"devices must name 'cpu' and/or 'cuda', got "
                         f"{devices!r}")
    return devices


def _kernel_ops(program) -> list:
    """The port's kernel operators that a traced program calls, in its
    graph and in the graphs of its autocast regions."""
    return sorted({str(n.target) for gm in program.graph_module.modules()
                   if isinstance(gm, torch.fx.GraphModule)
                   for n in gm.graph.nodes
                   if str(n.target).startswith("gdl_tpu_torch.")})


def export_eval(model: torch.nn.Module, example_inputs,
                devices: Optional[Sequence[str]] = None,
                apply_kwargs: Optional[dict] = None,
                poly_batch: bool = False,
                compute_dtype: torch.dtype = torch.float32) -> Exported:
    """Trace `model(*example_inputs, **apply_kwargs)` in eval mode, weights
    included, into an `Exported` on the examples' device (the model is
    moved there and put in eval mode, without gradients).

    devices: the devices the artifact serves on (default: the examples'
    device type); the examples' device must be one of them. poly_batch:
    one symbolic batch dimension shared by dim 0 of every input, so one
    artifact serves any batch size; otherwise the examples' batch is
    pinned. compute_dtype bfloat16 traces under bf16 autocast. Raises if
    the traced program holds a kernel operator (no CPU implementation)
    and "cpu" is among devices."""
    example_inputs = tuple(example_inputs)
    dev = example_inputs[0].device
    devices = _check_devices(devices or (dev.type,))
    if dev.type not in devices:
        raise ValueError(f"the example inputs are on {dev}, which is not "
                         f"among devices {devices!r}")
    model = model.to(dev).eval().requires_grad_(False)
    wrapped = _EvalForward(model, compute_dtype, dev.type, apply_kwargs)
    dynamic = None
    if poly_batch:
        b = torch.export.Dim("b")
        dynamic = tuple({0: b} for _ in example_inputs)
    with torch.no_grad(), warnings.catch_warnings():
        # a Swin block caches its shift mask at first use: a trace that
        # fills the cache holds the mask as a constant of the program
        warnings.filterwarnings("ignore", message="The tensor attributes")
        program = torch.export.export(wrapped, example_inputs,
                                      dynamic_shapes=dynamic)
    ops = _kernel_ops(program)
    if ops and "cpu" in devices:
        raise ValueError(f"the traced forward launches {ops}, which run on "
                         f"CUDA alone; export it for devices=('cuda',) or "
                         f"build the model with the plain versions")
    return Exported(program, devices, dev, poly_batch)


def _moved(program, device: torch.device):
    """`program` on `device`, in place: its weights, the devices its graph
    names, and its autocast regions, which then follow the autocast rules
    of `device` (as `ServedModel` does there)."""
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(program, str(device))
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                if node.target is torch.ops.higher_order.wrap_with_autocast:
                    node.args = (device.type,) + tuple(node.args[1:])
            gm.recompile()
    return program


def save_exported(exported: Exported, path: str) -> None:
    """Write the artifact: the program with its weights on the CPU, the
    devices it serves on and whether its batch is symbolic."""
    program = exported.program
    if exported.device.type != "cpu":
        program = _moved(copy.deepcopy(program), torch.device("cpu"))
    meta = {"devices": list(exported.devices),
            "poly_batch": exported.poly_batch}
    torch.export.save(program, path, extra_files={_EXPORT_META:
                                                  json.dumps(meta)})


def load_exported(path: str, device) -> Exported:
    """The artifact at `path` on `device`, ready for `.call(audio,
    visual)`. Raises for a device the artifact was not exported for."""
    import gdl_tpu_torch.ops.mlp  # noqa: F401  (registers the operators)
    import gdl_tpu_torch.ops.self_attention  # noqa: F401

    extra = {_EXPORT_META: ""}
    with open(path, "rb") as f:
        program = torch.export.load(f, extra_files=extra)
    meta = json.loads(extra[_EXPORT_META])
    dev = torch.device(device)
    if dev.type not in meta["devices"]:
        raise ValueError(f"{path} was exported for devices "
                         f"{tuple(meta['devices'])}, not {dev.type!r}")
    dev = resolve_device(dev)
    if dev.type != "cpu":
        program = _moved(program, dev)
    return Exported(program, meta["devices"], dev, meta["poly_batch"])


def _trace_device(devices: tuple, device) -> torch.device:
    """Where an export from a checkpoint traces: `device`, else the card
    when the artifact serves there (raising without one), else the CPU."""
    if device is None:
        device = "cuda" if "cuda" in devices else "cpu"
    return resolve_device(device)


def export_from_checkpoint(cfg: Config, ckpt_path: str, out_path: str,
                           batch_size: Optional[int] = None,
                           devices: Sequence[str] = ("cpu", "cuda"),
                           dgl: bool = True, poly_batch: bool = False,
                           device=None) -> Exported:
    """Build the classifier for `cfg` (the DGL family; dgl=False the joint
    one of main.py), load a reference-schema `.pth` into it (strict=False,
    as `load_from_checkpoint`) and write its serving artifact to
    `out_path`. The artifact takes (audio [B,F,T,1] f32, visual
    [B,T,224,224,3] f32) and returns (out, out_a, out_v) for DGL, the
    11-tuple for joint. B is `batch_size` (default cfg.batch_size), or
    any batch under poly_batch. With "cpu" among devices, or poly_batch,
    the model runs the plain versions of its kernels (gdl_tpu forces its
    XLA eval path there, `gdl_tpu/serve.py:121-132`); a fixed-shape
    devices=("cuda",) artifact keeps kernel #1 and, under cfg.fuse_mlp,
    #15. `device` is where the forward is traced (default: CUDA when
    "cuda" is among devices, else the CPU; the CLIs pass --device)."""
    devices = _check_devices(devices)
    dev = _trace_device(devices, device)
    attn_impl = "auto"
    if "cpu" in devices or poly_batch:
        attn_impl = "plain"
        cfg = dataclasses.replace(cfg, use_pallas_attn_eval=False,
                                  fuse_mlp=False)
    model = build_model(cfg, attn_impl=attn_impl, seed=0, dgl=dgl)
    result = model.load_state_dict(load_reference_pth(ckpt_path, cfg),
                                   strict=False)
    if result.missing_keys or result.unexpected_keys:
        warnings.warn(f"checkpoint {ckpt_path}: {len(result.missing_keys)} "
                      f"keys missing (kept current values), "
                      f"{len(result.unexpected_keys)} unused")
    b = batch_size or cfg.batch_size
    f, t = cfg.spec_shape
    inputs = (torch.zeros((b, f, t, 1), device=dev),
              torch.zeros((b, cfg.fps, 224, 224, 3), device=dev))
    exported = export_eval(model, inputs, devices, poly_batch=poly_batch,
                           compute_dtype=_DTYPES[cfg.compute_dtype])
    save_exported(exported, out_path)
    return exported


def export_intermediate_from_checkpoint(cfg: Config, model_name: str,
                                        ckpt_path: str, out_path: str,
                                        batch_size: Optional[int] = None,
                                        devices: Sequence[str] = ("cpu",
                                                                  "cuda"),
                                        share_streams: bool = False,
                                        poly_batch: bool = False,
                                        device=None,
                                        **model_kwargs) -> Exported:
    """`main_intermediate --export_path`: the serving artifact of the
    intermediate family's eval forward, from a `.pth` that
    `main_intermediate` wrote (loaded strictly). It takes (audio
    [B,F,T,1] f32, visual [B,1,224,224,3] f32), runs the AV adapter
    inside, and returns the model's own outputs: MMTM's (out, out_a,
    out_v), SE-fusion's logits, mmformer-N's 7-tuple. devices,
    poly_batch and device as for `export_from_checkpoint`: a fixed-shape
    devices=("cuda",) artifact keeps kernel #13."""
    from gdl_tpu_torch.models.intermediate import build_intermediate

    devices = _check_devices(devices)
    dev = _trace_device(devices, device)
    impl = "plain" if "cpu" in devices or poly_batch else "auto"
    model, _ = build_intermediate(
        model_name, cfg.n_classes, cfg.encoder_width,
        share_streams=share_streams, impl=impl,
        generator=torch.Generator().manual_seed(0), **model_kwargs)
    model.load_state_dict(load_reference_pth(ckpt_path, cfg), strict=True)
    b = batch_size or cfg.batch_size
    f, t = cfg.spec_shape
    inputs = (torch.zeros((b, f, t, 1), device=dev),
              torch.zeros((b, 1, 224, 224, 3), device=dev))
    exported = export_eval(model, inputs, devices,
                           apply_kwargs={"av_inputs": True},
                           poly_batch=poly_batch,
                           compute_dtype=_DTYPES[cfg.compute_dtype])
    save_exported(exported, out_path)
    return exported
