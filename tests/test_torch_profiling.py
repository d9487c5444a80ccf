"""`--profile_dir` of the port (`gdl_tpu_torch/utils/profiling.py`,
wired into `train/loop.py::train_one_epoch` as gdl_tpu/train/loop.py
wires `gdl_tpu/utils/profiling.py`), on the CPU.

`python -m gdl_tpu_torch.main_dgl ... --profile_dir D` traces steps 10-12
of epoch 0 with torch.profiler into one Chrome trace-event JSON file
under D, each step a `train_step` span, and nothing for later epochs; an
epoch that ends inside the window still writes a closed trace, in the DGL
and the joint loop alike.

The span log behind `annotate`: nothing while no profiler records; under
one, each stage of a tiny DGL epoch and of a served request once a step
or request, nested and carrying its unit, on kineto's clock, from every
thread, up to the log's cap."""

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

STAGES = ("preprocess", "forward", "backward", "clip", "optimizer")


def _tiny_dgl():
    """A tiny ResNet DGL harness on raw batches (the train preprocess in
    the step) and three raw batches of two clips."""
    from gdl_tpu_torch.data.synthetic import synthetic_batch

    cfg = Config(dataset="CREMAD", modulation="Normal", alpha=4.0,
                 encoder_width=8, encoder_stages=[1, 1, 1, 1], fps=1,
                 batch_size=2, log_grad_csv=False, device="cpu")
    model = AVClassifierDGL(cfg, generator=torch.Generator().manual_seed(3))
    h = build_harness(cfg, model, 3)
    batches = [synthetic_batch(cfg, 2, seed=s) for s in range(3)]
    return cfg, h, batches


def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def profiled_epoch():
    """Three steps of a tiny DGL epoch under torch.profiler (CPU
    activity) → (the logged spans, the profiler)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _, h, batches = _tiny_dgl()
        profiling.reset_spans()
        with _cpu_profile() as prof:
            train_one_epoch(h, batches, 0)
        return profiling.spans(), prof
    finally:
        torch.set_num_threads(before)


def test_annotate_off_is_one_shared_no_op_that_logs_nothing(monkeypatch):
    """No profiler records: `annotate` hands out the same object every
    call, never enters record_function, and a tiny DGL epoch logs no
    span."""
    assert profiling.annotate("a") is profiling.annotate("b", unit=3)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, h, batches = _tiny_dgl()
    profiling.reset_spans()
    train_one_epoch(h, batches, 0)
    assert profiling.spans() == [] and profiling.dropped == 0


def test_a_profiled_epoch_logs_each_stage_once_a_step(profiled_epoch):
    """Each of the three steps logs one `train_step`, its batch's
    `data.next` and `data.h2d`, and the DGL step's stages inside its
    `train_step`, all with the step's unit; the fourth `data.next` finds
    the loader's end."""
    log, _ = profiled_epoch
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in log)
    names = [s.name for s in log]
    for name in ("train_step", "data.h2d") + STAGES:
        assert names.count(name) == 3, name
    assert names.count("data.next") == 4
    assert names.count("metrics.fetch") == 2  # step 0's log, the drain
    steps = [s for s in log if s.name == "train_step"]
    assert [s.unit for s in steps] == [0, 1, 2]
    assert all(s.parent is None for s in steps)
    for name in ("data.next", "data.h2d"):
        spans = [s for s in log if s.name == name]
        assert all(s.parent is None for s in spans)
        assert [s.unit for s in spans] == list(range(len(spans)))
    for step in steps:
        stages = [s for s in log if s.parent is step]
        assert [s.name for s in stages] == list(STAGES)
        assert all(s.unit == step.unit for s in stages)
        assert all(step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
                   for s in stages)
        # the batch a step trains on was fetched before the step began
        fetch = next(s for s in log if s.name == "data.h2d"
                     and s.unit == step.unit)
        assert fetch.end_ns <= step.start_ns


def test_span_stamps_sit_on_kineto_s_clock(profiled_epoch):
    """Each span's stamps lie within 1 ms of its record_function event,
    the event placed at kineto's trace_start_ns() plus its relative
    time."""
    log, prof = profiled_epoch
    t0 = prof.profiler.kineto_results.trace_start_ns()
    names = {s.name for s in log}
    events = sorted((ev for ev in prof.events() if ev.name in names),
                    key=lambda ev: ev.time_range.start)
    assert len(events) == len(log)
    for name in names:
        spans = [s for s in log if s.name == name]
        evs = [ev for ev in events if ev.name == name]
        for s, ev in zip(spans, evs):
            start = t0 + ev.time_range.start * 1e3
            end = t0 + ev.time_range.end * 1e3
            assert abs(s.start_ns - start) < 1e6, name
            assert abs(s.end_ns - end) < 1e6, name


def test_a_served_request_logs_its_stages():
    """`ServedModel.eval_batch` logs `request` ⊃ `preprocess` ⊃
    `data.h2d`, then `forward` and `answer`, each request its unit."""
    from gdl_tpu_torch.data.synthetic import synthetic_batch
    from gdl_tpu_torch.serve import ServedModel

    cfg, h, _ = _tiny_dgl()
    served = ServedModel(h.model, cfg, "cpu")
    raw = synthetic_batch(cfg, 2, seed=9)
    profiling.reset_spans()
    with _cpu_profile():
        served.eval_batch(raw)
        served.eval_batch(raw)
    log = profiling.spans()
    requests = [s for s in log if s.name == "request"]
    assert [s.unit for s in requests] == [0, 1]
    for req in requests:
        inner = [s for s in log if s.parent is req]
        assert [s.name for s in inner] == ["preprocess", "forward", "answer"]
        copies = [s for s in log if s.parent is inner[0]]
        assert [s.name for s in copies] == ["data.h2d"]
        assert all(s.unit == req.unit for s in inner + copies)


def test_a_span_on_another_thread_takes_the_open_step_s_unit():
    """A span opened on another thread (autograd's device thread runs the
    backward's kernel wrappers) has no parent and the unit of the span
    with a unit open on the main thread."""
    import threading

    def kernel():
        with profiling.annotate("kernel.k"):
            pass

    profiling.reset_spans()
    with _cpu_profile():
        with profiling.annotate("train_step", unit=7):
            worker = threading.Thread(target=kernel)
            worker.start()
            worker.join()
        with profiling.annotate("after"):
            pass
    step, kernel, after = profiling.spans()
    assert kernel.name == "kernel.k" and kernel.parent is None
    assert kernel.unit == 7 and kernel.thread != step.thread
    assert after.unit is None


def test_the_log_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 2)
    profiling.reset_spans()
    with _cpu_profile():
        for k in range(5):
            with profiling.annotate("s", unit=k):
                pass
    assert [s.unit for s in profiling.spans()] == [0, 1]
    assert profiling.dropped == 3
    profiling.reset_spans()
    assert profiling.spans() == [] and profiling.dropped == 0


def test_threads_logging_at_once_lose_no_span_and_no_drop(monkeypatch):
    """Eight threads log 200 spans each against a cap of 1000, the
    interpreter switching threads every microsecond: every span is
    logged or counted as dropped."""
    import sys
    import threading

    def worker():
        for _ in range(200):
            with profiling.annotate("s"):
                pass

    monkeypatch.setattr(profiling, "SPAN_CAP", 1000)
    profiling.reset_spans()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            threads = [threading.Thread(target=worker) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(profiling.spans()) == 1000 and profiling.dropped == 600
