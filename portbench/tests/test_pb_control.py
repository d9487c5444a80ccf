"""The control, on the card: the plain reference in TF32 put in the
program's place, at the cell's own size, comes out not correct against
the cell's limits; a planted half batch too. Run with
`python -m pytest -m cuda portbench/tests/test_pb_control.py`."""

from __future__ import annotations

import pytest

from portbench.harness.compare import verdict
from portbench.harness.spec import find_cell


@pytest.mark.cuda
@pytest.mark.parametrize("workload, arm", [
    ("resnet18_dgl_cremad.train_b64", "tf32"),
    ("resnet18_dgl_cremad.train_b64", "half_batch"),
    ("swin_b_dgl_vggsound.train_b32", "tf32"),
    ("swin_b_dgl_vggsound.train_b32", "half_batch"),
    ("swin_b_dgl_vggsound.serve_b16", "tf32"),
])
def test_the_control_is_not_correct(workload, arm, cuda_device):
    from portbench.control import readings

    cell = find_cell(workload)
    correct, checks = verdict(readings(cell, 2147483900, arm, cuda_device),
                              cell.limits)
    assert not correct, checks
