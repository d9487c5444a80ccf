"""Row-parallel linear layers over the model group of `--mp`
(`parallel/mesh.py`), and the whole-tensor views of a split model that
checkpoints read and write.

A row-parallel layer holds the columns [j·K, (j+1)·K) of an nn.Linear
weight [out, in], K = in / M, on model index j, and computes

    y = all_reduce_model(x[..., j·K:(j+1)·K] · W_jᵀ) + b

the bias added once, after the reduce; the partial products are reduced
in f32 and y takes the product's dtype (bf16 under autocast), as one
GEMM with its bias rounds once. Every rank of a model group holds the
same x and gets the same y, so the backward's dy is the same on all of
them: dW_j = dyᵀ · x_j and db = Σ dy stay local, and dx is the
all-gather of the slices dy · W_j over the model group. Two autograd
functions carry the collectives (`_SliceToModel`: slice forward,
all-gather backward; `_ReduceFromModel`: all-reduce forward, identity
backward); the product itself is F.linear, under whatever autocast is on.

`gather_columns` is the other way GSPMD treats a split operand: a kernel
that takes the whole weight (#15, `models/swin.py::Mlp`) gets the shard
all-gathered, and its gradient keeps this rank's columns of the whole
dW, which is the same on every model rank (no reduce-scatter, which
would multiply it by M).

`convert_row_parallel` swaps every nn.Linear whose weight
`mesh.is_row_parallel` names for a `RowParallelLinear` holding this
rank's shard. `full_state_dict` and `full_optimizer_state` all-gather
the shards (a collective of the model group) into the one-process
schema; `RowParallelLinear` loads a whole weight by slicing it, and
`shard_optimizer_state` slices a whole optimizer state.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from gdl_tpu_torch.parallel import mesh
from gdl_tpu_torch.parallel.distributed import all_gather_, all_reduce_


class _SliceToModel(torch.autograd.Function):
    """x[..., index·k:(index+1)·k] forward; the all-gather of the slices'
    gradients over the model group backward."""

    @staticmethod
    def forward(ctx, x, k, index, group):
        ctx.group = group
        return x[..., index * k:(index + 1) * k].clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, dx):
        return (torch.cat(all_gather_(dx.contiguous(), ctx.group), -1),
                None, None, None)


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward; the identity backward (every
    rank's dy is the sum's)."""

    @staticmethod
    def forward(ctx, part, group):
        return all_reduce_(part.clone(), group=group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherColumns(torch.autograd.Function):
    """The whole [out, in] weight from the shards' columns forward; this
    rank's columns of the whole gradient backward."""

    @staticmethod
    def forward(ctx, shard, index, group):
        ctx.k, ctx.index = shard.shape[1], index
        return torch.cat(all_gather_(shard.contiguous(), group), 1)

    @staticmethod
    def backward(ctx, dw):
        lo = ctx.index * ctx.k
        return dw[:, lo:lo + ctx.k], None, None


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                        bias=None) -> torch.Tensor:
    """x [..., in] through this rank's shard `weight` [out, in / M] of a
    row-parallel linear over the model group, with the whole `bias`.
    The weight and bias may be detached (the DGL unimodal stream's
    head): x still gets its gradient."""
    part = F.linear(_SliceToModel.apply(x, weight.shape[1],
                                        mesh.model_index(),
                                        mesh.model_group()), weight)
    y = _ReduceFromModel.apply(part.float(), mesh.model_group())
    if bias is not None:
        y = y + bias.float()
    return y.to(part.dtype)


def gather_columns(shard: torch.Tensor) -> torch.Tensor:
    """The whole weight of a row-parallel shard, with a gradient that
    keeps this rank's columns."""
    return _GatherColumns.apply(shard, mesh.model_index(),
                                mesh.model_group())


class RowParallelLinear(nn.Module):
    """An nn.Linear(in_features, out_features) split by its input
    dimension over the model group: `weight` is this rank's [out, in / M]
    columns, `bias` the whole bias. Its state-dict keys are nn.Linear's;
    loading a whole [out, in] weight takes this rank's columns of it."""

    def __init__(self, in_features: int, out_features: int, index: int,
                 size: int, bias: bool = True, device=None, dtype=None):
        super().__init__()
        if in_features % size:
            raise ValueError(f"in_features {in_features} does not divide "
                             f"by {size} model ranks")
        self.in_features, self.out_features = in_features, out_features
        self.index, self.size = index, size
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(
            (out_features, in_features // size), **kw))
        self.weight._row_parallel = True
        self.register_parameter("bias", nn.Parameter(torch.empty(
            (out_features,), **kw)) if bias else None)

    @classmethod
    def from_linear(cls, layer: nn.Linear, index: int,
                    size: int) -> "RowParallelLinear":
        w = layer.weight
        new = cls(layer.in_features, layer.out_features, index, size,
                  layer.bias is not None, w.device, w.dtype)
        with torch.no_grad():
            new.weight.copy_(new.shard_of(w))
            if layer.bias is not None:
                new.bias.copy_(layer.bias)
        new.weight.requires_grad_(w.requires_grad)
        if layer.bias is not None:
            new.bias.requires_grad_(layer.bias.requires_grad)
        return new

    def shard_of(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a whole [out, in] tensor."""
        k = self.in_features // self.size
        return full[:, self.index * k:(self.index + 1) * k]

    def forward(self, x):
        return row_parallel_linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"shard={self.index}/{self.size}")

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "weight"
        full = state_dict.get(key)
        if full is not None and tuple(full.shape) == (self.out_features,
                                                      self.in_features):
            state_dict[key] = self.shard_of(full)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def convert_row_parallel(model: nn.Module) -> List[str]:
    """Swap, in place, every nn.Linear of `model` whose weight
    `mesh.is_row_parallel` names for a `RowParallelLinear` holding this
    rank's shard; returns their names. A layer reached under two names is
    swapped once. Every 2-D parameter the rule names must be such a
    weight (raises otherwise). Nothing changes at model size 1."""
    size = mesh.model_size()
    if size == 1:
        return []
    named = [n for n, p in model.named_parameters()
             if mesh.is_row_parallel(n, p.shape, size)]
    index, done, swapped = mesh.model_index(), {}, []
    for name, module in list(model.named_modules()):
        for child_name, child in list(module.named_children()):
            full = f"{name}.{child_name}" if name else child_name
            if id(child) in done:
                setattr(module, child_name, done[id(child)])
            elif (isinstance(child, nn.Linear) and mesh.is_row_parallel(
                    full + ".weight", child.weight.shape, size)):
                done[id(child)] = RowParallelLinear.from_linear(child, index,
                                                                size)
                setattr(module, child_name, done[id(child)])
                swapped.append(full)
    split = {id(m.weight) for m in done.values()}
    params = dict(model.named_parameters())
    whole = [n for n in named if id(params.get(n)) not in split]
    if whole:
        raise ValueError(f"--mp {size}: {whole} are row-parallel in "
                         f"gdl_tpu's rule but not nn.Linear weights")
    return swapped


def is_sharded(param: torch.Tensor) -> bool:
    """Whether `param` is a row-parallel shard (set by RowParallelLinear)."""
    return getattr(param, "_row_parallel", False)


def _row_parallel_layers(model: nn.Module) -> Dict[str, RowParallelLinear]:
    return {name: m for name, m in model.named_modules()
            if isinstance(m, RowParallelLinear)}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with each row-parallel weight whole: every
    rank of the model group must call it (one all-gather a layer, in
    module order). The model's own state dict at model size 1."""
    sd = model.state_dict()
    for name, layer in _row_parallel_layers(model).items():
        key = f"{name}.weight" if name else "weight"
        sd[key] = torch.cat(all_gather_(layer.weight.detach(),
                                        mesh.model_group()), 1)
    return sd


def _param_list(optimizer) -> list:
    return [p for group in optimizer.param_groups for p in group["params"]]


def full_optimizer_state(optimizer, model: nn.Module) -> dict:
    """`optimizer.state_dict()` with each state tensor of a row-parallel
    weight (momentum, AdaGrad's sum, Adam's moments) whole: every rank of
    the model group must call it."""
    sd = optimizer.state_dict()
    shards = {id(m.weight) for m in _row_parallel_layers(model).values()}
    for i, p in enumerate(_param_list(optimizer)):
        if id(p) not in shards or i not in sd["state"]:
            continue
        sd["state"][i] = {
            k: (torch.cat(all_gather_(v, mesh.model_group()), 1)
                if torch.is_tensor(v) and v.shape == p.shape else v)
            for k, v in sd["state"][i].items()}
    return sd


def shard_optimizer_state(sd: dict, optimizer, model: nn.Module) -> dict:
    """A whole optimizer state (`full_optimizer_state`'s, or a one-process
    run's) with each state tensor of a row-parallel weight cut to this
    rank's columns; `sd` itself is left as it is."""
    layers = {id(m.weight): m for m in _row_parallel_layers(model).values()}
    state = dict(sd["state"])
    for i, p in enumerate(_param_list(optimizer)):
        layer = layers.get(id(p))
        if layer is None or i not in state:
            continue
        whole = (layer.out_features, layer.in_features)
        state[i] = {
            k: (layer.shard_of(v).clone()
                if torch.is_tensor(v) and tuple(v.shape) == whole else v)
            for k, v in state[i].items()}
    return dict(sd, state=state)
