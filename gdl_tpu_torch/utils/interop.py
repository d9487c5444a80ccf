"""Weight bridge between gdl_tpu's parameter trees, the reference `.pth`
schema and the port's modules.

`state_dict_from_flax` re-implements, in numpy, the name and layout map
of `gdl_tpu/utils/torch_interop.py::flax_to_torch_state_dict`
(importing that module would load jax): flax module paths become the
reference's torch names (`stage{S}_block{B}` → `layers.S.blocks.B`,
`merge{S}` → `layers.S.downsample`, `mlp_fc1` → `mlp.fc1`, ...), dense
kernels [I, O] become weights [O, I], conv kernels [kH, kW, I, O] become
[O, I, kH, kW], and LayerNorm scales become weights.

`load_reference_pth` reads the reference's checkpoint file
({"model": state_dict, ...}, keys prefixed `module.` by DataParallel).

`load_pretrained_encoders` is `--pretrained_path`: the partial load of a
torchvision-format backbone (`gdl_tpu/utils/torch_interop.py:287`).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch


def _torch_components(path: List[str]) -> List[str]:
    out: List[str] = []
    for comp in path:
        m = re.fullmatch(r"(layer\d+)_(\d+)", comp)
        if m:
            out += [m.group(1), m.group(2)]
            continue
        m = re.fullmatch(r"stage(\d+)_block(\d+)", comp)
        if m:
            out += ["layers", m.group(1), "blocks", m.group(2)]
            continue
        m = re.fullmatch(r"merge(\d+)", comp)
        if m:
            out += ["layers", m.group(1), "downsample"]
            continue
        out += {"downsample_conv": ["downsample", "0"],
                "downsample_bn": ["downsample", "1"],
                "mlp_fc1": ["mlp", "fc1"],
                "mlp_fc2": ["mlp", "fc2"]}.get(comp, [comp])
    return out


def _flat_with_path(tree, prefix=()) -> List[Tuple[Tuple[str, ...], object]]:
    if hasattr(tree, "items"):
        out = []
        for k in sorted(tree.keys()):
            out += _flat_with_path(tree[k], prefix + (str(k),))
        return out
    return [(prefix, tree)]


def _param_leaf(leaf: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "kernel":
        if arr.ndim == 4:  # conv [kH, kW, I, O] -> [O, I, kH, kW]
            return "weight", np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:  # dense [I, O] -> [O, I]
            return "weight", arr.T
        return "weight", arr
    if leaf in ("scale", "embedding"):
        return "weight", arr
    return leaf, arr


_STATS = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_flax(params, batch_stats,
                         prefix: str = "") -> Dict[str, torch.Tensor]:
    """gdl_tpu parameter and batch-stat trees (numpy or array leaves) →
    the port's state dict, in the reference's torch names and layouts.
    Each BatchNorm also gets num_batches_tracked=0."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flat_with_path(params):
        name, val = _param_leaf(path[-1], np.asarray(arr))
        key = prefix + ".".join(_torch_components(list(path[:-1])) + [name])
        sd[key] = torch.from_numpy(np.array(val, order="C"))
    for path, arr in _flat_with_path(batch_stats):
        comps = _torch_components(list(path[:-1]))
        name = _STATS.get(path[-1], path[-1])
        sd[prefix + ".".join(comps + [name])] = torch.from_numpy(
            np.array(arr, order="C"))
        if name == "running_var":
            sd[prefix + ".".join(comps + ["num_batches_tracked"])] = (
                torch.tensor(0, dtype=torch.int64))
    return sd


def strip_module_prefix(sd: Dict[str, torch.Tensor]):
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def load_reference_pth(path: str, cfg=None) -> Dict[str, torch.Tensor]:
    """The state dict of a reference checkpoint, `module.` stripped.
    With `cfg`, the reference's compatibility asserts run first
    (main_dgl.py:409-410): the file's modulation and fusion method must
    be cfg's.

    Accepts the reference's saved dict ({'model': sd, 'modulation', ...})
    and a bare state dict. The caller loads it with strict=False, the
    reference valid.py's semantics: keys missing from the file keep the
    model's current values. The file is unpickled in full (the
    reference's metadata holds plain Python objects), so load only
    checkpoints from a trusted source."""
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(loaded, dict):
        raise ValueError(f"unsupported checkpoint object: {type(loaded)}")
    if cfg is not None and "modulation" in loaded:
        assert loaded["modulation"] == cfg.modulation, (
            "inconsistency between modulation method of loaded model and "
            "args !")
        assert loaded["fusion"] == cfg.fusion_method, (
            "inconsistency between fusion method of loaded model and args !")
    sd = loaded.get("model", loaded)
    return strip_module_prefix({k: v for k, v in sd.items()
                                if isinstance(v, torch.Tensor)})


def load_pretrained_encoders(model: torch.nn.Module, path: str,
                             targets=None) -> Dict[str, dict]:
    """Partial-load a torchvision-format backbone state dict (a LOCAL
    file, e.g. torchvision's ImageNet resnet18 saved with
    torch.save(model.state_dict(), ...); {"model": ...} and `module.`
    prefixes allowed) into each target encoder of `model`, in place.

    The reference's filter (models/resnet18_se.py:228-248), per encoder as
    gdl_tpu does it: every key of the encoder that the file holds with
    the same shape is copied in, running statistics included; a key of
    another shape is skipped (the 1-channel audio stem against
    torchvision's 3-channel conv1), and keys of no encoder (`fc.*`) are
    ignored. `num_batches_tracked` is neither loaded nor counted, as
    gdl_tpu's trees have no such leaf. targets default to every top-level
    child with a `conv1` (ResNet) or a `patch_embed` (Swin). Prints one
    line per target, as gdl_tpu does, and returns per target the keys
    {"missing", "unexpected", "mismatched"}."""
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(loaded, dict) and isinstance(loaded.get("model"), dict):
        loaded = loaded["model"]
    sd = strip_module_prefix({k: v for k, v in loaded.items()
                              if isinstance(v, torch.Tensor)})
    children = dict(model.named_children())
    if targets is None:
        targets = [name for name, child in children.items()
                   if hasattr(child, "conv1") or hasattr(child, "patch_embed")]
    reports = {}
    for name in targets:
        if name not in children:
            continue
        own = {k: v for k, v in children[name].state_dict().items()
               if not k.endswith("num_batches_tracked")}
        adopted, missing, mismatched = {}, [], []
        for k, v in own.items():
            if k not in sd:
                missing.append(k)
            elif tuple(sd[k].shape) != tuple(v.shape):
                mismatched.append(k)
            else:
                adopted[k] = sd[k].to(v.dtype)
        children[name].load_state_dict(adopted, strict=False)
        print(f"pretrained[{name}]: loaded={len(adopted)} "
              f"missing={len(missing)} shape-skipped={len(mismatched)}")
        reports[name] = {
            "missing": missing, "mismatched": mismatched,
            "unexpected": [k for k in sd if k not in own
                           and not k.endswith("num_batches_tracked")]}
    return reports
