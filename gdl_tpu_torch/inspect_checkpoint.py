"""Print what a reference-schema `.pth` holds: counterpart of
`tools/inspect_checkpoint.py` (the reference's grammar_test.py probe of
per-modality fusion weight magnitudes) for the port's checkpoints
(`utils/checkpoint.py`).

    python -m gdl_tpu_torch.inspect_checkpoint best_model_*.pth \
        [--encoder_dim 512]

Prints saved_epoch, acc, fusion and alpha; for each layer of the fusion
head its weight's shape and mean |w|, and for a [n, 2d] weight the mean
|w| of its audio and visual halves, columns [:, :d] and [:, d:] (rows of
gdl_tpu's [2d, n] kernel); then the parameter count of each top-level
module, BatchNorm statistics not counted. The numbers are those that
`tools/inspect_checkpoint.py` prints for gdl_tpu's msgpack of the same
weights; gdl_tpu's msgpack files themselves are refused, as
`utils/checkpoint.py` refuses them.
"""

from __future__ import annotations

import argparse

import torch

from gdl_tpu_torch.utils.checkpoint import require_torch_file
from gdl_tpu_torch.utils.interop import strip_module_prefix

_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def inspect(path: str, encoder_dim: int = 512) -> list:
    """The lines the CLI prints for the `.pth` at `path`."""
    require_torch_file(path)
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    sd = strip_module_prefix({k: v for k, v in
                              loaded.get("model", loaded).items()
                              if isinstance(v, torch.Tensor)})
    lines = ["saved_epoch: {}  acc: {}  fusion: {}  alpha: {}".format(
        loaded.get("saved_epoch"), loaded.get("acc"), loaded.get("fusion"),
        loaded.get("alpha"))]
    d = encoder_dim
    for key, w in sd.items():
        parts = key.split(".")
        if len(parts) != 3 or parts[0] != "fusion_module" or \
                parts[2] != "weight":
            continue
        w = w.detach().float()
        lines.append(f"{parts[1]}: weight {tuple(w.shape)} "
                     f"|w|={w.abs().mean().item():.5f}")
        if w.dim() == 2 and w.shape[1] == 2 * d:
            lines.append(f"  |audio half|  = "
                         f"{w[:, :d].abs().mean().item():.5f}")
            lines.append(f"  |visual half| = "
                         f"{w[:, d:].abs().mean().item():.5f}")
    counts = {}
    for key, v in sd.items():
        if key.rsplit(".", 1)[-1] in _BN_BUFFERS:
            continue
        top = key.split(".", 1)[0]
        counts[top] = counts.get(top, 0) + v.numel()
    lines += [f"{top}: {n:,} params" for top, n in counts.items()]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gdl_tpu_torch.inspect_checkpoint")
    ap.add_argument("ckpt")
    ap.add_argument("--encoder_dim", type=int, default=512)
    args = ap.parse_args(argv)
    for line in inspect(args.ckpt, args.encoder_dim):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
