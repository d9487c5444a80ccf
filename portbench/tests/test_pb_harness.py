"""The harness: cells found by name, the refusal without a card, the
import boundary, and what a planted fault does to `correct`."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, tiny_cell

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "gdl_tpu"}


def _sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & FORBIDDEN


def test_the_run_names_jax_modules_by_whole_top_level_name(monkeypatch):
    import types

    from portbench.harness.device import forbidden_modules

    monkeypatch.setitem(sys.modules, "gdl_tpu_torchx", types.ModuleType("x"))
    assert "gdl_tpu_torchx" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "gdl_tpu.config", types.ModuleType("x"))
    assert "gdl_tpu" in forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert "gdl_tpu_torch" not in tops, path


def _string_constants(tree):
    docstrings = {id(n.body[0].value) for n in ast.walk(tree)
                  if isinstance(n, (ast.Module, ast.FunctionDef,
                                    ast.ClassDef, ast.AsyncFunctionDef))
                  and n.body and isinstance(n.body[0], ast.Expr)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docstrings]


def test_nothing_reads_the_jax_benchmarks_or_chip_smoke():
    for path in _sources():
        tree = ast.parse(path.read_text())
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & {"benchmarks", "bench", "chip_smoke"}, path
        for text in _string_constants(tree):
            for word in ("benchmarks/", "bench.py", "chip_smoke"):
                assert word not in text, (path, text)


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "resnet18_dgl_cremad.train_b64", "--seed", "2147483999",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    from portbench.harness import spec

    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((copy / "traffic" / "train_b64.json").read_text())
    traffic["batch"] = 48
    (copy / "traffic" / "train_b48.json").write_text(json.dumps(traffic))
    config = json.loads((copy / "configs" / "resnet18_dgl_cremad.json")
                        .read_text())
    config["name"] = "resnet18_dgl_ks"
    config["frames"] = 3
    (copy / "configs" / "resnet18_dgl_ks.json").write_text(
        json.dumps(config))
    (copy / "limits" / "resnet18_dgl_ks.train_b48.json").write_bytes(
        (copy / "limits" / "resnet18_dgl_cremad.train_b64.json")
        .read_bytes())
    (copy / "layer_metrics" / "steps.train.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    bench["workloads"].append({"name": "resnet18_dgl_ks.train_b48",
                               "config": "resnet18_dgl_ks",
                               "traffic": "train_b48", "chips": 1,
                               "why": "a new cell"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "whole step",
                               "moves": "train_clips_per_s"})
    bench["end_to_end"][0]["workloads"].append("resnet18_dgl_ks.train_b48")
    monkeypatch.setattr(spec, "BENCH_DIR", copy)
    cell = spec.find_cell("resnet18_dgl_ks.train_b48", bench)
    assert cell.traffic["batch"] == 48 and cell.config["frames"] == 3
    assert [m["name"] for m in cell.end_to_end] == ["train_clips_per_s",
                                                   "setup_s"]
    assert "steps.train" in [m["name"] for m in cell.per_layer]
    assert cell.driver.__name__.endswith("train")
    ctx = type("Ctx", (), {"steps": 7})()
    assert spec.metric_reader("steps.train").read(ctx) == 7.0
    assert all(p.read_bytes() == b for p, b in before.items())


def _run_tiny(workload, seed=2147483648, trace=False):
    import time

    import torch

    from portbench.run import run_cell

    return run_cell(tiny_cell(workload), seed, 0.5, trace,
                    torch.device("cpu"), time.perf_counter())


def test_the_trace_window_runs_from_the_first_to_the_last_device_op():
    from portbench.harness.trace import HOST_OUTSIDE, Trace

    device_ops = [("gemm_a", 10.0, 30.0), ("elementwise_b", 25.0, 40.0),
                  ("gemm_a", 100.0, 160.0)]
    host_ops = [("cudaStreamSynchronize", 45.0, 95.0)]
    tr = Trace(device_ops, host_ops, (10.0, 160.0), units=2)
    assert tr.window_s == 150e-6
    assert tr.busy_s == 90e-6  # [10, 40] and [100, 160]
    assert tr.idle_gaps() == [["cudaStreamSynchronize", 60e-6]]
    tr = Trace(device_ops, [], (10.0, 160.0), units=2)
    assert tr.idle_gaps() == [[HOST_OUTSIDE, 60e-6]]


@pytest.mark.parametrize("workload", ["resnet18_dgl_cremad.train_b64",
                                      "swin_b_dgl_vggsound.serve_b16"])
def test_a_traced_run_reports_what_it_can_read(workload):
    result = _run_tiny(workload, trace=True)
    assert result["correct"], result["checks"]
    kind = "train" if "train" in workload else "serve"
    # the CPU has no device operations: only the model FLOP utilization
    assert list(result["metrics"]) == [f"mfu.{kind}"]
    assert result["metrics"][f"mfu.{kind}"]["value"] > 0
    assert result["device"]["busy_s"] == 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_traced_stretch_holds_as_many_steps_as_it_counts():
    import time

    import torch

    cell = tiny_cell("resnet18_dgl_cremad.train_b64")
    cell.traffic["trace_steps"] = cell.traffic["pool"] + 2  # cycles the pool
    out = cell.driver.run(cell, 2147483649, 0.5, True, torch.device("cpu"),
                          time.perf_counter())
    tr = out["trace"]
    assert tr.units == cell.traffic["trace_steps"]
    assert sum(op[0] == "train_step" for op in tr.host_ops) == tr.units


@pytest.mark.parametrize("workload", ["resnet18_dgl_cremad.train_b64",
                                      "swin_b_dgl_vggsound.train_b32",
                                      "swin_b_dgl_vggsound.serve_b16"])
def test_a_sound_run_is_correct(workload):
    result = _run_tiny(workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


def _unchanged_state(monkeypatch):
    from gdl_tpu_torch.train import optim

    # on the class itself: torch wraps a subclass's step once per process
    monkeypatch.setattr(optim.ClippedSGD, "step",
                        lambda self, closure=None, grad_norm=None: None)


def _half_batch(monkeypatch):
    from gdl_tpu_torch.train import dgl

    loss_fn = dgl.dgl_loss_fn

    def half(model, batch, cfg, generator=None):
        keep = batch["label"].shape[0] // 2
        return loss_fn(model, {k: v[:keep] for k, v in batch.items()}, cfg,
                       generator)

    monkeypatch.setattr(dgl, "dgl_loss_fn", half)


def _answer_altered(monkeypatch):
    from gdl_tpu_torch.serve import ServedModel

    serve = ServedModel.eval_batch

    def altered(self, batch):
        out = serve(self, batch)
        out["pred"] = (out["pred"] + 1) % out["logits"][0].shape[1]
        return out

    monkeypatch.setattr(ServedModel, "eval_batch", altered)


def _logits_altered(monkeypatch):
    from gdl_tpu_torch.serve import ServedModel

    serve = ServedModel.eval_batch

    def altered(self, batch):
        out = serve(self, batch)
        out["logits"] = (out["logits"][0] * 1.001,) + out["logits"][1:]
        return out

    monkeypatch.setattr(ServedModel, "eval_batch", altered)


@pytest.mark.parametrize("workload, fault", [
    ("resnet18_dgl_cremad.train_b64", _unchanged_state),
    ("resnet18_dgl_cremad.train_b64", _half_batch),
    ("swin_b_dgl_vggsound.train_b32", _unchanged_state),
    ("swin_b_dgl_vggsound.train_b32", _half_batch),
    ("swin_b_dgl_vggsound.serve_b16", _answer_altered),
    ("swin_b_dgl_vggsound.serve_b16", _logits_altered),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run_tiny(workload)["correct"]
