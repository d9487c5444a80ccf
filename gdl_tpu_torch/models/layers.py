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


def batch_norm(features: int, groups: int = 1) -> nn.BatchNorm2d:
    """BatchNorm with torch defaults (eps 1e-5, running-stat momentum 0.1,
    weight 1, bias 0). torch stores the UNBIASED batch variance in
    running_var, which is what gdl_tpu's GroupedBatchNorm copies.

    groups > 1 is gdl_tpu's per-replica (DataParallel-semantics) BN, one
    statistic group per data-parallel replica; it comes with the
    multi-GPU slice."""
    if groups > 1:
        raise NotImplementedError(
            f"per-replica BatchNorm (--sync_bn 0 with --dp {groups}) is not "
            f"ported to gdl_tpu_torch yet: it needs the multi-GPU slice")
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


def max_pool_3x3_s2(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1) on an NCHW
    tensor. On a CUDA tensor its backward is the hand-written kernel
    (`ops/maxpool.py`), on by default; impl="plain" selects the plain
    version of the backward."""
    return _maxpool.max_pool_3x3_s2(x, impl)
