"""Shared layer building blocks and weight-init parity helpers, port of
`gdl_tpu/models/layers.py`.

The reference applies `utils/utils.py:15-23 weight_init` to the whole
model after construction (main_dgl.py:238), overriding any module-local
init:
  - nn.Linear: xavier_normal weight, zero bias
  - nn.Conv2d: kaiming_normal fan_out (relu) weight
  - nn.BatchNorm2d: weight 1, bias 0
The constructors below draw those distributions from an explicit
generator.

gdl_tpu's `max_pool_3x3_s2_scatterfree` / `_padbwd` are XLA-level
rewrites of the pooling backward, not kernels, and have no counterpart
here; its Pallas backward does (`ops/maxpool.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gdl_tpu_torch.ops import maxpool as _maxpool
from gdl_tpu_torch.parallel.distributed import all_reduce_
from gdl_tpu_torch.parallel.mesh import data_group, data_index, data_size


def conv(in_channels: int, features: int, kernel: int, stride: int = 1,
         generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """Bias-free conv with padding kernel // 2 and the reference's
    kaiming-normal (fan_out, relu) init: std = sqrt(2 / fan_out)."""
    layer = nn.Conv2d(in_channels, features, kernel, stride=stride,
                      padding=kernel // 2, bias=False)
    with torch.no_grad():
        nn.init.kaiming_normal_(layer.weight, mode="fan_out",
                                nonlinearity="relu", generator=generator)
    return layer


def xavier_linear(in_dim: int, out_dim: int,
                  generator: Optional[torch.Generator] = None) -> nn.Linear:
    """nn.Linear with the reference's xavier-normal weight, zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        nn.init.xavier_normal_(layer.weight, generator=generator)
        layer.bias.zero_()
    return layer


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's default kernel init (nn.Dense, nn.Conv): a normal of
    variance 1/fan_in truncated at two standard deviations (the constant
    restores the variance)."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


class _GlobalBatchNormFn(torch.autograd.Function):
    """Training-mode BatchNorm over the global batch: the ranks of the
    data group (every rank without `--mp`; the M ranks of a data index
    hold the same rows and are not counted twice). The forward
    all-reduces over it one [D, 2C + 1] f32 table, D the data size, in
    which each rank fills the row of its data index with its per-channel
    statistics and count; the backward all-reduces the per-channel sums
    of dy and dy·(x − mean). The parameters' gradients stay this rank's
    sums: the gradient all-reduce averages them with the rest.

    On CUDA the passes over x are torch's fused SyncBatchNorm primitives:
    a row is (mean, invstd, count), and `batch_norm_gather_stats_with_counts`
    combines the rows and updates the running statistics in one launch. On
    the CPU, which has none of them, a row is (mean, Σ(x − mean)², count),
    combined by Chan's parallel variance: the raw sum of squares
    E[x²] − E[x]² loses digits where |mean| ≫ std, as the log-spectrogram
    stem's activations have it. Both store torch's unbiased running
    variance over the global count."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum):
        c = x.shape[1]
        ctx.fused = x.is_cuda
        if ctx.fused:
            x = x.contiguous(memory_format=_memory_format(x))
            mean_r, invstd_r = torch.batch_norm_stats(x, eps)
            index, size = data_index(), data_size()
            table = mean_r.new_zeros((size, 2 * c + 1))
            table[index] = torch.cat(
                [mean_r, invstd_r, mean_r.new_full((1,), x.numel() // c)])
            all_reduce_(table, group=data_group())
            counts = table[:, 2 * c]
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                x, table[:, :c], table[:, c:2 * c], running_mean,
                running_var, momentum, eps, counts)
            ctx.save_for_backward(x, weight, mean, invstd, counts)
            return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()
        var_r, mean_r = torch.var_mean(xf, dims, correction=0)
        n_r = x.numel() // c
        index, size = data_index(), data_size()
        table = xf.new_zeros((size, 2 * c + 1))
        table[index] = torch.cat([mean_r, var_r * n_r,
                                  xf.new_full((1,), n_r)])
        all_reduce_(table, group=data_group())
        counts = table[:, 2 * c:]
        n = counts.sum()
        mean = (table[:, :c] * counts).sum(0) / n
        m2 = (table[:, c:2 * c]
              + counts * (table[:, :c] - mean) ** 2).sum(0)
        var = m2 / n
        invstd = torch.rsqrt(var + eps)
        with torch.no_grad():  # torch's rule: the unbiased variance
            running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
            running_var.mul_(1.0 - momentum).add_(m2 / (n - 1.0),
                                                  alpha=momentum)
        shape = (1, c) + (1,) * (x.dim() - 2)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        return (xhat * weight.view(shape) + bias.view(shape)).to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        if ctx.fused:
            x, weight, mean, invstd, counts = ctx.saved_tensors
            gy = gy.contiguous(memory_format=_memory_format(x))
            sum_dy, sum_dy_xmu, grad_w, grad_b = (
                torch.batch_norm_backward_reduce(gy, x, mean, invstd, weight,
                                                 True, True, True))
            c = sum_dy.shape[0]
            sums = all_reduce_(torch.cat([sum_dy, sum_dy_xmu]),
                               group=data_group())
            dx = torch.batch_norm_backward_elemt(
                gy, x, mean, invstd, weight, sums[:c], sums[c:],
                counts.to(torch.int32))
            return dx, grad_w, grad_b, None, None, None, None
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = (1, c) + (1,) * (x.dim() - 2)
        gyf = gy.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sum_dy = gyf.sum(dims)
        sum_dy_xhat = (gyf * xhat).sum(dims)
        sums = all_reduce_(torch.cat([sum_dy, sum_dy_xhat]),
                           group=data_group())
        dx = (weight * invstd).view(shape) * (
            gyf - (sums[:c] / n).view(shape)
            - xhat * (sums[c:] / n).view(shape))
        return (dx.to(x.dtype), sum_dy_xhat.to(weight.dtype),
                sum_dy.to(weight.dtype), None, None, None, None)


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last if x.dim() == 4
            and x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training statistics are those of the global
    batch, gdl_tpu's BatchNorm under its one program: with a data group
    of more than one rank, `global_forward`; otherwise (and in eval mode)
    nn.BatchNorm2d itself, bit for bit. The state-dict keys are
    nn.BatchNorm2d's."""

    def forward(self, x):
        if not self.training or data_size() == 1:
            return super().forward(x)
        return self.global_forward(x)

    def global_forward(self, x):
        """The training forward through `_GlobalBatchNormFn`, whatever the
        world size (at world size 1 its all-reduces are no-ops)."""
        self.num_batches_tracked.add_(1)
        momentum = (1.0 / float(self.num_batches_tracked)
                    if self.momentum is None else self.momentum)
        return _GlobalBatchNormFn.apply(x, self.weight, self.bias,
                                        self.running_mean, self.running_var,
                                        self.eps, momentum)


def batch_norm(features: int, groups: int = 1) -> nn.BatchNorm2d:
    """BatchNorm with torch defaults (eps 1e-5, running-stat momentum 0.1,
    weight 1, bias 0). torch stores the UNBIASED batch variance in
    running_var, which is what gdl_tpu's GroupedBatchNorm copies.

    groups == 1: global batch statistics over every data index
    (`GlobalBatchNorm2d`). groups > 1 is gdl_tpu's per-replica
    (DataParallel-semantics) BN, one statistic group per data index: a
    plain nn.BatchNorm2d on each rank's own rows, whose running
    statistics the loop takes from rank 0 (`train/loop.py`)."""
    if groups == 1:
        return GlobalBatchNorm2d(features, eps=1e-5, momentum=0.1)
    size = data_size()
    if groups != size:
        raise ValueError(f"per-replica BatchNorm with {groups} groups needs "
                         f"a data-parallel size of {groups}, not {size}")
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


def max_pool_3x3_s2(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1) on an NCHW
    tensor. On a CUDA tensor its backward is the hand-written kernel
    (`ops/maxpool.py`), on by default; impl="plain" selects the plain
    version of the backward."""
    return _maxpool.max_pool_3x3_s2(x, impl)
