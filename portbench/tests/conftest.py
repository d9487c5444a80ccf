"""Shared pieces of the benchmark's own tests (`python -m pytest
portbench/tests`): the repository root on the import path, a cell cut
to tiny widths for CPU runs, and the fixture that skips card tests
where no card is present."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_cell(workload: str):
    """The cell `workload` at tiny widths and batches, for the CPU: the
    same drivers, reference and limits."""
    from portbench.harness.spec import find_cell

    cell = find_cell(workload)
    config, traffic = cell.config, cell.traffic
    if config["model"] == "resnet18_dgl":
        config["widths"] = {"width": 8, "stages": [1, 1, 1, 1]}
        config["program"].update(encoder_width=8, encoder_stages=[1, 1, 1, 1])
    else:
        config["widths"].update(embed_dim=16, depths=[2, 2], heads=[1, 2])
        config["program"].update(swin_embed_dim=16, swin_depths=[2, 2],
                                 swin_heads=[1, 2])
    traffic.update(batch=4, pool=4)
    if traffic["driver"] == "serve":
        traffic.update(rate_per_s=20.0, check_requests=3, trace_requests=3)
    else:
        traffic.update(trace_steps=2)
    return cell


@pytest.fixture
def cuda_device():
    """The first card; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
