"""Seeded weights, made on the device in one draw.

The benchmark makes every weight from `--seed` and hands the same
tensors to the program and to the plain reference, by the names of the
reference `.pth` schema that both use. Values depend on a leaf's name
and shape only, never on the order a model lists them in: the leaves
that take random values are laid out in sorted-name order over one
`torch.randn` of their total size from a generator on the device, then
scaled by the configuration's rule.

Rules (`init` of a configuration file):
- a 4-D weight (a convolution): `conv` — "kaiming_fan_out" for
  std = sqrt(2 / (out · kh · kw)), or a number, the std;
- a 2-D weight (a linear): `linear` — "xavier" for std =
  sqrt(2 / (in + out)), or a number; names holding `fusion_module` use
  `head` where it is given;
- `relative_position_bias_table`: `table`, a number;
- every other weight (norms) 1, biases 0, BN running mean 0, running
  variance 1, `num_batches_tracked` 0.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from portbench.harness.inputs import sub_seed


def _std(name: str, shape: Tuple[int, ...], init: dict):
    """The std of a random leaf, or (None, fill) for a constant one."""
    if name.endswith("running_var"):
        return None, 1.0
    if name.endswith(("running_mean", "num_batches_tracked", ".bias")):
        return None, 0.0
    if name.endswith("relative_position_bias_table"):
        return float(init["table"]), None
    if name.endswith(".weight") and len(shape) == 4:
        rule = init["conv"]
        if rule == "kaiming_fan_out":
            return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])), None
        return float(rule), None
    if name.endswith(".weight") and len(shape) == 2:
        rule = init.get("head", init["linear"]) if "fusion_module" in name \
            else init["linear"]
        if rule == "xavier":
            return math.sqrt(2.0 / (shape[0] + shape[1])), None
        return float(rule), None
    if name.endswith(".weight"):
        return None, 1.0
    raise ValueError(f"no initial value for {name} {shape}")


def make_weights(leaves: Iterable[Tuple[str, Tuple[int, ...], torch.dtype]],
                 seed: int, init: dict, device) -> Dict[str, torch.Tensor]:
    """{name: tensor on `device`} for the (name, shape, dtype) leaves."""
    leaves = sorted((n, tuple(s), d) for n, s, d in leaves)
    rules = {n: _std(n, s, init) for n, s, _ in leaves}
    total = sum(math.prod(s) for n, s, _ in leaves if rules[n][0] is not None)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape, dtype in leaves:
        std, fill = rules[name]
        if std is None:
            out[name] = torch.full(shape, fill, dtype=dtype, device=device)
            continue
        n = math.prod(shape)
        out[name] = (flat[offset:offset + n].view(shape) * std).to(dtype)
        offset += n
    return out


@torch.no_grad()
def load_weights(module: torch.nn.Module, seed: int, init: dict) -> None:
    """Fill `module`'s state (parameters and persistent buffers) in place
    with the seeded weights, on the device it lives on."""
    state = module.state_dict()
    device = next(iter(state.values())).device
    weights = make_weights([(n, tuple(t.shape), t.dtype)
                            for n, t in state.items()], seed, init, device)
    for name, t in state.items():
        t.copy_(weights.pop(name))
