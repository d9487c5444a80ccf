"""DGL fusion heads, port of `gdl_tpu/models/fusion.py` (eval forward).

Each head's `forward(x, y)` returns the reference 3-tuple
`(x_out, y_out, fused_out)`. Only the default DGL head, concat, is
ported so far; the others raise NotImplementedError in `make_fusion`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _xavier_linear(in_dim: int, out_dim: int,
                   gen: Optional[torch.Generator]) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        nn.init.xavier_uniform_(lin.weight, generator=gen)
        lin.bias.zero_()
    return lin


class ConcatFusionDGL(nn.Module):
    """The default DGL fusion (--fusion_method concat): unimodal logits
    come from the SAME fc_out fed zero-padded single-modality features,
    the fused logits from the concatenated features. The reference's
    `fc_auxi` is never used; it is kept so that state dicts load
    strictly."""

    def __init__(self, input_dim: int = 1024, output_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc_out = _xavier_linear(input_dim, output_dim, generator)
        self.fc_auxi = _xavier_linear(input_dim, output_dim, generator)

    def unimodal(self, x, y):
        x_out = self.fc_out(torch.cat([x, torch.zeros_like(y)], dim=-1))
        y_out = self.fc_out(torch.cat([torch.zeros_like(x), y], dim=-1))
        return x_out, y_out

    def fuse(self, x, y):
        return self.fc_out(torch.cat([x, y], dim=-1).detach())

    def forward(self, x, y):
        x_out, y_out = self.unimodal(x, y)
        return x_out, y_out, self.fuse(x, y)


def make_fusion(method: str, n_classes: int, dgl: bool,
                input_dim: int = 512,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Fusion selection mirroring gdl_tpu's make_fusion."""
    if method == "concat" and dgl:
        return ConcatFusionDGL(2 * input_dim, n_classes, generator)
    raise NotImplementedError(
        f"fusion {method!r} (dgl={dgl}) is not ported to gdl_tpu_torch yet")
