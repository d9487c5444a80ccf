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
