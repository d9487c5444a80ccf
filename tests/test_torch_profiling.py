"""`--profile_dir` of the port (`gdl_tpu_torch/utils/profiling.py`,
wired into `train/loop.py::train_one_epoch` as gdl_tpu/train/loop.py
wires `gdl_tpu/utils/profiling.py`), on the CPU.

`python -m gdl_tpu_torch.main_dgl ... --profile_dir D` traces steps 10-12
of epoch 0 with torch.profiler into one Chrome trace-event JSON file
under D, each step a `train_step` span, and nothing for later epochs; an
epoch that ends inside the window still writes a closed trace, in the DGL
and the joint loop alike."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from gdl_tpu_torch import main_dgl
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.data.synthetic import SyntheticDataset
from gdl_tpu_torch.models.classifier import AVClassifier, AVClassifierDGL
from gdl_tpu_torch.train.loop import build_harness, train_one_epoch
from gdl_tpu_torch.utils import profiling

TINY = ["--encoder_width", "8", "--encoder_stages", "1,1,1,1"]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _step_spans(path):
    """The trace's `train_step` spans on the host (on a card the trace
    also holds their device-side copies, category gpu_user_annotation)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("name") == "train_step"
            and e.get("cat") == "user_annotation"]


def test_main_dgl_traces_steps_10_to_12_of_epoch_0(tmp_path, monkeypatch):
    """Two epochs of 14 steps on synthetic data: one trace file, rank 0's,
    with exactly three step spans, written during epoch 0 (epoch 1 adds
    no file and rewrites none)."""
    def synthetic(cfg, mode):
        return SyntheticDataset(cfg, size=28 if mode == "train" else 4,
                                seed=100 if mode == "train" else 900)

    written = []
    stop = profiling.stop_trace

    def recording_stop():
        path = stop()
        if path is not None:
            written.append((path, os.path.getmtime(path)))
        return path

    monkeypatch.setattr(main_dgl, "make_dataset", synthetic)
    monkeypatch.setattr(profiling, "stop_trace", recording_stop)
    monkeypatch.setattr("gdl_tpu_torch.train.loop.stop_trace",
                        recording_stop)
    monkeypatch.chdir(tmp_path)
    epochs = []
    inner = train_one_epoch

    def counting(h, loader, epoch, **kw):
        means = inner(h, loader, epoch, **kw)
        epochs.append((epoch, means["steps"],
                       len(glob.glob(str(tmp_path / "prof" / "*")))))
        return means

    monkeypatch.setattr("gdl_tpu_torch.train.loop.train_one_epoch", counting)
    main_dgl.main(["--train", "--device", "cpu", "--dataset", "CREMAD",
                   "--modulation", "Normal", "--fusion_method", "concat",
                   "--alpha", "4", "--batch_size", "2", "--epochs", "2",
                   "--fps", "1", "--num_workers", "1", "--ckpt_path",
                   str(tmp_path / "ckpt"), "--profile_dir",
                   str(tmp_path / "prof")] + TINY)
    assert epochs == [(0, 14, 1), (1, 14, 1)]
    files = glob.glob(str(tmp_path / "prof" / "*"))
    assert len(files) == 1
    name = os.path.basename(files[0])
    assert name.startswith("rank0.") and name.endswith(".pt.trace.json")
    assert len(written) == 1 and written[0] == (files[0],
                                                os.path.getmtime(files[0]))
    assert len(_step_spans(files[0])) == 3


@pytest.mark.parametrize("dgl", [True, False], ids=["dgl", "joint"])
def test_an_epoch_ending_in_the_window_writes_a_closed_trace(tmp_path, dgl):
    """An epoch of 12 steps ends inside the window (steps 10-12): the loop
    closes the trace at the epoch's end, and the file parses with the two
    step spans it saw; no trace stays open. The joint loop (main.py's)
    traces as the DGL loop does."""
    spec, hw, n_classes = (33, 40), 32, 6
    cfg = Config(dataset="CREMAD", modulation="Normal", alpha=0.3 if not dgl
                 else 4.0, encoder_width=8, encoder_stages=[1, 1, 1, 1],
                 fps=1, batch_size=2, log_grad_csv=False, device="cpu",
                 profile_dir=str(tmp_path / "prof"))
    gen = torch.Generator().manual_seed(3)
    model = (AVClassifierDGL if dgl else AVClassifier)(cfg, generator=gen)
    h = build_harness(cfg, model, 12, dgl=dgl, raw_batches=False)
    rng = np.random.default_rng(5)
    batches = [{"audio": rng.standard_normal((2,) + spec + (1,),
                                             dtype=np.float32),
                "visual": rng.standard_normal((2, 1, hw, hw, 3),
                                              dtype=np.float32),
                "label": rng.integers(0, n_classes, 2).astype(np.int32)}
               for _ in range(12)]
    train_one_epoch(h, batches, 0)
    assert profiling._active is None
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    assert len(_step_spans(files[0])) == 2
    train_one_epoch(h, batches[:11], 1)  # not epoch 0: no trace
    assert len(glob.glob(str(tmp_path / "prof" / "*"))) == 1
