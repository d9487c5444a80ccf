"""The port's CLI under `torchrun` on the CPU: two gloo ranks over the
on-disk fixture tree of tests/test_torch_cli.py.

`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
gdl_tpu_torch.main_dgl --device cpu --dp 2 --eval_drop_last 1 ...` trains
with both ranks printing the same accuracy and rank 0 alone writing the
CSVs (each file holds one run's rows); `gdl_tpu_torch.valid` under two
ranks reports the one-process accuracy; `--dp 2 --mp 2` over four ranks
trains to the one-process run's losses and accuracies; --dp 3 and --mp 3
against two ranks, and main_intermediate's --profile_dir, raise by
name."""

import glob
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from gdl_tpu_torch import main_intermediate
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models.classifier import AVClassifierDGL
from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint
from tests.test_torch_cli import REPO_ROOT, _fixture_tree


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=REPO_ROOT + ":" + os.environ.get("PYTHONPATH", ""))


def _torchrun(args, cwd, module, nproc=2):
    """torchrun of `module` → (the launcher's CompletedProcess, each
    rank's stdout), the ranks' output captured apart."""
    logs = os.path.join(cwd, f"torchrun_logs_{module}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "--log_dir", logs,
           "--redirects", "1", "-m", module] + args
    out = subprocess.run(cmd, cwd=cwd, env=_env(), capture_output=True,
                         text=True, timeout=300)
    ranks = []
    for r in range(nproc):
        files = glob.glob(os.path.join(logs, "*", "attempt_0", str(r),
                                       "stdout.log"))
        ranks.append(open(files[0]).read() if files else "")
    shutil.rmtree(logs, ignore_errors=True)
    return out, ranks


def _common(audio, visual):
    return ["--dataset", "CREMAD", "--modulation", "Normal",
            "--fusion_method", "concat", "--alpha", "4",
            "--audio_path", audio, "--visual_path", visual,
            "--batch_size", "4", "--num_workers", "1",
            "--encoder_width", "8", "--encoder_stages", "1,1,1,1",
            "--learning_rate", "0.002", "--device", "cpu",
            "--eval_drop_last", "1"]


def _epoch_lines(text):
    """Each rank's per-epoch "Loss: ..., Acc: ..." line."""
    return re.findall(r"^Loss: .*Acc: .*$", text, re.M)


def test_torchrun_trains_and_evaluates_on_two_ranks(tmp_path):
    """Two epochs of main_dgl over two ranks: the run ends, each epoch's
    accuracy is printed once by each rank and alike, and the accuracy CSV
    and the grad CSV hold one run's rows (rank 1 writes nothing). Then
    valid under two ranks reports, on both, the accuracy one process
    reports for the same checkpoint."""
    audio, visual = _fixture_tree(tmp_path)
    common = _common(audio, visual)
    out, ranks = _torchrun(["--train", "--ckpt_path", str(tmp_path / "ckpt"),
                            "--epochs", "2", "--dp", "2"] + common,
                           tmp_path, "gdl_tpu_torch.main_dgl")
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    lines = [_epoch_lines(text) for text in ranks]
    assert len(lines[0]) == 2 and lines[0] == lines[1], ranks
    rows = (tmp_path / "ckpt" / "CREMAD_full.csv").read_text().split()
    assert rows[0] == "1000,1000,1000" and len(rows) == 3
    grad_rows = (tmp_path / "audio_visual_grad_vanilla.csv").read_text()
    assert len(grad_rows.split()) == 2 * 3  # 12 clips / 4 a step, 2 epochs

    cfg = Config(dataset="CREMAD", modulation="Normal",
                 fusion_method="concat", alpha=4.0, encoder_width=8,
                 encoder_stages=[1, 1, 1, 1])
    model = AVClassifierDGL(cfg, generator=torch.Generator().manual_seed(2))
    pth = save_best_checkpoint(cfg, model, 1, 0.5,
                               path=str(tmp_path / "best.pth"))
    valid = ["--ckpt_path", pth] + common
    one = subprocess.run([sys.executable, "-m", "gdl_tpu_torch.valid"]
                         + valid, cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    two, ranks = _torchrun(valid, tmp_path, "gdl_tpu_torch.valid")
    assert two.returncode == 0, (two.stdout + two.stderr)[-4000:]
    want = re.findall(r"Accuracy: .*", one.stdout)
    assert len(want) == 1
    for text in ranks:
        assert re.findall(r"Accuracy: .*", text) == want


def test_torchrun_trains_with_model_parallel(tmp_path):
    """One epoch of main_dgl under `--dp 2 --mp 2` over four ranks: the
    run ends, the four ranks print the one-process run's epoch line (loss
    and accuracies), rank 0 writes the one-process run's accuracy CSV,
    and a resume state whose tensors have the one-process run's shapes."""
    audio, visual = _fixture_tree(tmp_path)
    common = _common(audio, visual) + ["--epochs", "1", "--save_every", "1"]
    out, ranks = _torchrun(["--train", "--ckpt_path",
                            str(tmp_path / "mp"), "--dp", "2", "--mp", "2"]
                           + common, tmp_path, "gdl_tpu_torch.main_dgl",
                           nproc=4)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    one = subprocess.run([sys.executable, "-m", "gdl_tpu_torch.main_dgl",
                          "--train", "--ckpt_path", str(tmp_path / "one")]
                         + common, cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    want = _epoch_lines(one.stdout)
    assert len(want) == 1
    for text in ranks:
        assert _epoch_lines(text) == want
    assert ((tmp_path / "mp" / "CREMAD_full.csv").read_text()
            == (tmp_path / "one" / "CREMAD_full.csv").read_text())
    shapes = [{k: tuple(v.shape) for k, v in torch.load(
        tmp_path / d / "resume_state.pth", weights_only=False)[
            "model"].items()} for d in ("mp", "one")]
    assert shapes[0] == shapes[1]


def test_refusals_name_the_option(tmp_path):
    """--dp 3 under two ranks raises on both, naming torchrun's
    WORLD_SIZE; --mp 3 under two ranks raises ValueError on both, naming
    --mp; --profile_dir (main_intermediate, whose reference loop traces
    nothing; main_dgl and main take it) raises NotImplementedError naming
    the option; all before any work."""
    audio, visual = _fixture_tree(tmp_path)
    common = _common(audio, visual)
    for flag, value, message in (
            ("--dp", "3", "differs from torchrun's WORLD_SIZE 2"),
            ("--mp", "3", "ValueError: --mp 3 does not divide torchrun's "
                          "WORLD_SIZE 2")):
        out, _ = _torchrun(["--train", "--ckpt_path",
                            str(tmp_path / "ckpt"), "--epochs", "1", flag,
                            value] + common, tmp_path,
                           "gdl_tpu_torch.main_dgl")
        assert out.returncode != 0
        assert out.stderr.count(message) >= 2, out.stderr[-3000:]
        assert not (tmp_path / "ckpt").exists()
    with pytest.raises(NotImplementedError, match="--profile_dir"):
        main_intermediate.main(["--train", "--ckpt_path",
                                str(tmp_path / "c"), "--profile_dir", "p"]
                               + common)
    assert not (tmp_path / "c").exists() and not (tmp_path / "p").exists()
