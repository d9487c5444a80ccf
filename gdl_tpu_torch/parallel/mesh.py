"""The (data, model) grid of `--mp`, the counterpart of
`gdl_tpu/parallel/mesh.py`.

gdl_tpu lays its devices out as a ('data', 'model') mesh
(`make_mesh(dp, mp)`): the batch is split over 'data', and the dense
kernels that `_param_spec` names are row-parallel over 'model', each
model shard contracting its slice of the input dimension while XLA
all-reduces the partial products. No activation is ever split over
'model'. The port runs one process a device under `torchrun` and builds
the same grid from `torch.distributed` groups:

- rank = data index · M + model index, the row-major order of
  `create_device_mesh((dp, mp))`;
- one model group a data index (its M ranks hold the same rows and the
  shards of the row-parallel weights), one data group a model index
  (its D ranks hold the same shard and different rows).

The batch-facing code asks this module for the data index and size (the
loader's stride, the random draws' rows, the BatchNorm statistics, the
gradient mean, the metrics); the row-parallel layers
(`parallel/row_parallel.py`) ask it for the model group. Without a
process group, or with M = 1, the data index and size are the rank and
the world size, both groups are the default group, and no group is made.

`is_row_parallel` is `_param_spec`'s rule on the port's parameter names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch.distributed as dist


@dataclass(frozen=True)
class Grid:
    mp: int
    data_index: int
    data_size: int
    model_index: int
    data_group: Optional[object]  # None: the default group
    model_group: Optional[object]
    world: object  # the default group the grid was built on


_GRID: Optional[Grid] = None


def init_grid(mp: int = 1) -> Optional[Grid]:
    """Build the grid of torchrun's process group for `--mp mp` and keep
    it; a grid already built on the same group for the same mp is kept.
    Every rank must call it (a new group is a collective). Without a
    process group it builds nothing and returns None; mp > 1 then
    raises."""
    global _GRID
    if not dist.is_initialized():
        if mp > 1:
            raise NotImplementedError(
                f"--mp {mp} needs a process group: launch it with torchrun "
                f"--nproc_per_node N, N a multiple of {mp} (this process "
                f"has no process group)")
        _GRID = None
        return None
    world = dist.group.WORLD
    if _GRID is not None and _GRID.world is world and _GRID.mp == mp:
        return _GRID
    size, rank = dist.get_world_size(), dist.get_rank()
    if mp < 1 or size % mp:
        raise ValueError(f"--mp {mp} does not divide torchrun's WORLD_SIZE "
                         f"{size}")
    if mp == 1:
        _GRID = Grid(1, rank, size, 0, None, None, world)
        return _GRID
    dp = size // mp
    data_index, model_index = divmod(rank, mp)
    model_groups = [dist.new_group(list(range(d * mp, (d + 1) * mp)))
                    for d in range(dp)]
    data_groups = [dist.new_group(list(range(m, size, mp)))
                   for m in range(mp)]
    _GRID = Grid(mp, data_index, dp, model_index, data_groups[model_index],
                 model_groups[data_index], world)
    return _GRID


def reset_grid() -> None:
    """Forget the grid (its groups go with the process group)."""
    global _GRID
    _GRID = None


def _grid() -> Optional[Grid]:
    """The grid if it was built on the present process group."""
    if (_GRID is None or not dist.is_initialized()
            or _GRID.world is not dist.group.WORLD):
        return None
    return _GRID


def data_index() -> int:
    g = _grid()
    if g is not None:
        return g.data_index
    return dist.get_rank() if dist.is_initialized() else 0


def data_size() -> int:
    g = _grid()
    if g is not None:
        return g.data_size
    return dist.get_world_size() if dist.is_initialized() else 1


def model_index() -> int:
    g = _grid()
    return g.model_index if g is not None else 0


def model_size() -> int:
    g = _grid()
    return g.mp if g is not None else 1


def data_group():
    """The ranks of this rank's model index (None: the default group)."""
    g = _grid()
    return g.data_group if g is not None else None


def model_group():
    """The ranks of this rank's data index (None: the default group, only
    where model_size() is 1)."""
    g = _grid()
    return g.model_group if g is not None else None


def is_row_parallel(name: str, shape: Sequence[int], mp: int) -> bool:
    """gdl_tpu's `_param_spec` (`gdl_tpu/parallel/mesh.py:55-77`) on the
    port's names and layouts: a 2-D parameter is split over the model
    group when mp > 1, its input dimension divides by mp, and its name
    has a component holding "fusion" or "classifier", or `mlp.fc2` (flax's
    `mlp_fc2`), or both `ffn` and `fc2`. nn.Linear stores [out, in]
    where flax stores [in, out], so the input dimension is shape[1]. An
    `fc2` under neither `mlp` nor `ffn` (the SE blocks') stays whole."""
    if mp <= 1 or len(shape) != 2 or shape[1] % mp:
        return False
    comps = name.split(".")[:-1]
    mlp_fc2 = any(a == "mlp" and b == "fc2" for a, b in zip(comps, comps[1:]))
    return (any("fusion" in c or "classifier" in c for c in comps)
            or mlp_fc2 or ("fc2" in comps and "ffn" in comps))
