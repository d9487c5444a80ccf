"""`python -m gdl_tpu_torch.main_dgl --device cpu ...` as a subprocess
over an on-disk fixture tree: argparse → dataset → loader → train → eval
→ CSV + checkpoint, exactly as a user would run the port; then eval from
the `.pth` it wrote. The flags and assertions are those of
tests/test_cli_end_to_end.py for gdl_tpu's main_dgl.py."""

import glob
import os
import subprocess
import sys

from tests.test_datasets import make_cremad_tree

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    # a tiny model: more intra-op threads only spin, and under a parallel
    # test run they starve the other workers
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO_ROOT + ":" + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "gdl_tpu_torch.main_dgl"] + args
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=540)


def test_port_cli_train_then_eval(tmp_path):
    names = [(f"clip{i}", lbl) for i, lbl in enumerate(
        ["NEU", "HAP", "SAD", "FEA", "DIS", "ANG"] * 2)]
    audio, visual, data_root = make_cremad_tree(tmp_path, names)
    # CremadDataset reads ./dataset/data/CREMAD/*.csv relative to cwd
    os.makedirs(tmp_path / "dataset", exist_ok=True)
    os.symlink(data_root.rstrip("/"), tmp_path / "dataset" / "data")

    common = ["--dataset", "CREMAD", "--modulation", "Normal",
              "--fusion_method", "concat", "--alpha", "4",
              "--audio_path", audio, "--visual_path", visual,
              "--batch_size", "8", "--num_workers", "2",
              "--encoder_width", "8", "--encoder_stages", "1,1,1,1",
              "--learning_rate", "0.002"]

    # without --device cpu, a machine without CUDA raises and runs nothing
    out = _run(["--train", "--ckpt_path", str(tmp_path / "none"),
                "--epochs", "1"] + common, tmp_path)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "Start training" not in out.stdout
    assert not (tmp_path / "none").exists()

    # three epochs: the best checkpoint is written only after epoch 0
    out = _run(["--train", "--ckpt_path", str(tmp_path / "ckpt"),
                "--epochs", "3", "--device", "cpu",
                "--eval_drop_last", "0"] + common, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Start training" in out.stdout
    csv_path = tmp_path / "ckpt" / "CREMAD_full.csv"
    assert csv_path.exists()
    rows = csv_path.read_text().strip().splitlines()
    assert rows[0] == "1000,1000,1000" and len(rows) == 4
    # per-step grad CSV written in cwd (main_dgl.py:148-152 artifact)
    grad_rows = (tmp_path / "audio_visual_grad_vanilla.csv").read_text()
    assert len(grad_rows.strip().splitlines()) == 3  # 1 step per epoch

    accs = [float(r.split(",")[0]) for r in rows[1:]]
    pths = glob.glob(str(tmp_path / "ckpt" / "best_model_of_dataset_*.pth"))
    if max(accs[1:]) > 0:  # accuracy improved after epoch 0
        assert pths and "The best model has been saved" in out.stdout
        name = os.path.basename(pths[0])
        assert name.startswith("best_model_of_dataset_CREMAD_Normal_alpha_"
                               "4.0optimizer_sgd_modulate_starts_0_ends_50_")
    else:  # nothing to save: write one through the same writer
        import torch

        from gdl_tpu_torch.config import Config
        from gdl_tpu_torch.serve import build_model
        from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint

        cfg = Config(modulation="Normal", encoder_width=8,
                     encoder_stages=[1, 1, 1, 1],
                     ckpt_path=str(tmp_path / "ckpt"))
        pths = [save_best_checkpoint(cfg, build_model(cfg, seed=0), 1, 0.0)]
        assert torch.load(pths[0], weights_only=False)["fusion"] == "concat"

    # eval from the .pth (no --train)
    out = _run(["--ckpt_path", pths[0], "--device", "cpu",
                "--eval_drop_last", "0"] + common, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Trained model loaded!" in out.stdout
    assert "Accuracy: " in out.stdout

    # the reference's consistency assert (main_dgl.py:409-410)
    out = _run(["--ckpt_path", pths[0], "--device", "cpu",
                "--modulation", "OGM"] + common[:2] + common[4:], tmp_path)
    assert out.returncode != 0
    assert "inconsistency between modulation" in out.stderr
