"""Multi-process data parallelism on `torch.distributed`, the counterpart
of `gdl_tpu/parallel/distributed.py`.

gdl_tpu scales one jitted program over a data-parallel mesh; the port
runs one process per device, launched by `torchrun`, and computes what
that program computes over the global batch:

- `maybe_initialize` joins the process group that torchrun's environment
  (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) describes:
  gloo for the CPU, NCCL for CUDA.
- Each rank decodes its contiguous rows of every global batch
  (`data.loader.Loader`'s striding), and `all_reduce_grads` averages the
  gradients after each backward, in buckets.
- Every random draw with a batch dimension is made at the global batch
  from the generator that every rank seeds alike, and each rank keeps its
  own rows (`local_rows`; the dropout masks take their place in the
  stream instead, `element_layout`), so the generators stay equal across
  ranks and N ranks draw what one process draws.

Under `--mp M` (`parallel/mesh.py`) the ranks form a data × model grid:
everything above that speaks of a rank's rows speaks of its data index
and the data group (the M ranks of a data index hold the same rows),
and the gradient mean runs over the data group. Preemption agreement
and the start-up broadcast stay over the world.

Only all-reduce, all-gather, broadcast and barrier are used: gloo has
them for CPU tensors, and a tensor on another device goes through a CPU
copy under gloo. At world size 1, and without a process group, every
function here issues no collective.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from gdl_tpu_torch.parallel import mesh

BUCKET_BYTES = 25 * 2 ** 20  # gradient all-reduce bucket size
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def maybe_initialize(backend=None, device=None) -> bool:
    """Join the process group of torchrun's environment → True, or False
    when there is none (a plain `python -m ...` run). `backend` None
    picks gloo for `device` "cpu" and NCCL otherwise; NCCL first binds
    this process to cuda:LOCAL_RANK. Idempotent."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if backend is None:
        cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if cpu else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(_local_cuda_device())
    dist.init_process_group(backend=backend, init_method="env://")
    return True


def destroy() -> None:
    """Leave the process group, if any, and forget its grid."""
    mesh.reset_grid()
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_parallel(cfg) -> None:
    """The CLIs' one step after `maybe_initialize`, before any model is
    built: build `--mp`'s grid on the process group (`mesh.init_grid`; a
    per-replica BatchNorm checks its groups against the grid's data size
    when it is built, and the loaders stride by its data index), then
    set a `cfg.dp` of -1 to the size it names, the world size over --mp
    (1 without a process group), as gdl_tpu's `make_mesh(-1, mp)` reads
    it."""
    mesh.init_grid(cfg.mp)
    if cfg.dp <= 0:
        cfg.dp = max(process_count() // max(cfg.mp, 1), 1)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def is_primary() -> bool:
    return process_index() == 0


def _local_cuda_device() -> torch.device:
    """cuda:LOCAL_RANK, raising where this machine has no such card (never
    a wrap-around, never the CPU)."""
    idx = local_rank()
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if idx >= count:
        raise RuntimeError(f"LOCAL_RANK {idx} has no CUDA device: this "
                           f"machine has {count}")
    return torch.device("cuda", idx)


def local_device(device) -> torch.device:
    """The device of this rank for the configured `device`: "cuda" without
    an index is cuda:LOCAL_RANK (bound with torch.cuda.set_device) under a
    process group; an explicit index and "cpu" stay as they are."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = _local_cuda_device()
        torch.cuda.set_device(dev)
    return dev


def _comm_device() -> torch.device:
    """Where a collective's tensor must lie: the bound card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def group_size(group=None) -> int:
    """The ranks of `group` (None: the default group); 1 without a
    process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce_(tensor: torch.Tensor, op: str = "sum",
                group=None) -> torch.Tensor:
    """In place over the ranks of `group` (None: all ranks; op "sum" or
    "max") and returned; a tensor that the backend cannot reduce where it
    lies goes through a copy."""
    if group_size(group) == 1:
        return tensor
    dev = _comm_device()
    if tensor.device.type == dev.type and tensor.is_contiguous():
        dist.all_reduce(tensor, op=_OPS[op], group=group)
        return tensor
    staged = tensor.to(dev).contiguous()
    dist.all_reduce(staged, op=_OPS[op], group=group)
    tensor.copy_(staged)
    return tensor


def all_gather_(tensor: torch.Tensor, group=None) -> list:
    """Every rank's `tensor` of `group`, in rank order, on `tensor`'s
    device ([tensor] for a group of one)."""
    n = group_size(group)
    if n == 1:
        return [tensor]
    dev = _comm_device()
    staged = tensor.to(dev).contiguous()
    parts = [torch.empty_like(staged) for _ in range(n)]
    dist.all_gather(parts, staged, group=group)
    return [p.to(tensor.device) for p in parts]


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Average the gradients of `params` over the data group: the
    gradient of the global-batch mean loss, each rank's loss being the
    mean over its rows. A row-parallel shard's gradient is the data mean
    of that shard (the data group holds one shard); a replicated one's
    is the same on the M ranks of a data index, which computed it from
    the same rows. Gradients of one dtype are packed into buckets of at
    most BUCKET_BYTES, one all-reduce a bucket. Parameters without a
    gradient (the same on every rank) are skipped. No collective at data
    size 1."""
    world = mesh.data_size()
    if world == 1:
        return
    group = mesh.data_group()
    grads = [p.grad for p in params if p.grad is not None]
    bucket, size = [], 0
    for i, g in enumerate(grads):
        bucket.append(g)
        size += g.numel() * g.element_size()
        last = i + 1 == len(grads)
        if last or size >= BUCKET_BYTES or grads[i + 1].dtype != g.dtype:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            all_reduce_(flat, group=group).div_(world)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()
            bucket, size = [], 0


def broadcast_module(module: torch.nn.Module,
                     parameters: bool = True) -> None:
    """Copy rank 0's buffers, and its parameters unless `parameters` is
    False, into every rank."""
    if process_count() == 1:
        return
    tensors = [p.data for p in module.parameters()] if parameters else []
    tensors += list(module.buffers())
    dev = _comm_device()
    with torch.no_grad():
        for t in tensors:
            if t.device.type == dev.type and t.is_contiguous():
                dist.broadcast(t, 0)
            else:  # another device, or channels_last memory
                staged = t.to(dev).contiguous()
                dist.broadcast(staged, 0)
                t.copy_(staged)


def local_rows(draw: Callable[[int], torch.Tensor],
               rows: int) -> torch.Tensor:
    """This rank's `rows` rows of `draw(rows × D)`, D the data size: a
    random draw whose leading dimension is the batch, made at the global
    batch so that every rank's generator advances alike; the M ranks of a
    data index keep the same rows. `draw(rows)` itself at data size 1."""
    index, world = mesh.data_index(), mesh.data_size()
    if world == 1:
        return draw(rows)
    start = index * rows
    return draw(rows * world)[start:start + rows]


def element_layout(local_numel: int, passes: int = 1) -> tuple:
    """(offset, seg_elems, seg_stride): where this rank's elements lie in
    the global tensor, for a tensor of `local_numel` elements a rank whose
    leading dimension is `passes` stacked batches ([passes·b, ...]; data
    index k's row p·b + r is row p·B + k·b + r of the one-process
    [passes·B, ...] stack, B = D·b, D the data size). Its local element
    e is global element offset + (e // seg_elems)·seg_stride + e %
    seg_elems: the layout of a counter-based mask (`ops/dropout.py`) that
    makes a rank's mask its rows of the global one. One pass is one
    segment (seg_stride == seg_elems), starting at the rank's first
    element."""
    if passes < 1 or local_numel % passes:
        raise ValueError(f"{local_numel} elements are not {passes} equal "
                         f"passes")
    seg = local_numel // passes
    index, world = mesh.data_index(), mesh.data_size()
    start = index * seg
    if passes == 1:
        return start, seg, seg
    return start, seg, seg * world
