"""`python -m gdl_tpu_torch.main_dgl --device cpu ...` as a subprocess
over an on-disk fixture tree: argparse → dataset → loader → train → eval
→ CSV + checkpoint, exactly as a user would run the port; then eval from
the `.pth` it wrote. The flags and assertions are those of
tests/test_cli_end_to_end.py for gdl_tpu's main_dgl.py.

`python -m gdl_tpu_torch.main_intermediate --device cpu ...` the same way
for the intermediate-fusion family: two epochs of mmformer_n at width 8,
the CSV, the `.pth`, the `.pth` served back through
`serve.load_intermediate_from_checkpoint` and exported with
`--export_path`; one epoch of mmtm and sefusion; the refusals."""

import glob
import os
import subprocess
import sys

from tests.test_datasets import make_cremad_tree

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, module="gdl_tpu_torch.main_dgl"):
    # a tiny model: more intra-op threads only spin, and under a parallel
    # test run they starve the other workers
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO_ROOT + ":" + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", module] + args
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=540)


def _fixture_tree(tmp_path):
    names = [(f"clip{i}", lbl) for i, lbl in enumerate(
        ["NEU", "HAP", "SAD", "FEA", "DIS", "ANG"] * 2)]
    audio, visual, data_root = make_cremad_tree(tmp_path, names)
    # CremadDataset reads ./dataset/data/CREMAD/*.csv relative to cwd
    os.makedirs(tmp_path / "dataset", exist_ok=True)
    os.symlink(data_root.rstrip("/"), tmp_path / "dataset" / "data")
    return audio, visual


def test_port_cli_train_then_eval(tmp_path):
    audio, visual = _fixture_tree(tmp_path)

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


INTERMEDIATE = "gdl_tpu_torch.main_intermediate"


def _intermediate_common(audio, visual):
    return ["--dataset", "CREMAD", "--modulation", "Normal", "--alpha", "2",
            "--audio_path", audio, "--visual_path", visual,
            "--batch_size", "4", "--num_workers", "2", "--encoder_width", "8",
            "--learning_rate", "0.002", "--eval_drop_last", "0"]


def test_port_intermediate_cli_mmformer_n(tmp_path):
    """Two epochs of mmformer_n (embed 512, 196 tokens: the model's own;
    stems at width 8): CSV rows, the best `.pth` after epoch 0, the
    `.pth` served to the same predictions as the model it was saved from,
    and its serving artifact (`--export_path`) to the same logits."""
    import torch

    from gdl_tpu_torch.config import Config
    from gdl_tpu_torch.data.datasets import make_dataset
    from gdl_tpu_torch.data.loader import Loader
    from gdl_tpu_torch.models.intermediate import (
        TripleLogits,
        build_intermediate,
    )
    from gdl_tpu_torch.serve import (
        load_exported,
        load_intermediate_from_checkpoint,
    )
    from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint

    audio, visual = _fixture_tree(tmp_path)
    common = _intermediate_common(audio, visual)

    # without --device cpu, a machine without CUDA raises and runs nothing
    out = _run(["--train", "--model", "mmformer_n", "--ckpt_path",
                str(tmp_path / "none"), "--epochs", "1"] + common, tmp_path,
               INTERMEDIATE)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "Epoch: 0" not in out.stdout
    assert not (tmp_path / "none").exists()

    out = _run(["--train", "--model", "mmformer_n", "--device", "cpu",
                "--ckpt_path", str(tmp_path / "ckpt"), "--epochs", "2"]
               + common, tmp_path, INTERMEDIATE)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Epoch: 1" in out.stdout and "Acc: " in out.stdout
    rows = (tmp_path / "ckpt" / "CREMAD_mmformer_n.csv").read_text() \
        .strip().splitlines()
    assert rows[0] == "1000,1000,1000" and len(rows) == 3
    accs = [float(r.split(",")[0]) for r in rows[1:]]
    assert all(0.0 <= a <= 1.0 for a in accs)

    cfg = Config(dataset="CREMAD", modulation="Normal", alpha=2.0, fps=1,
                 encoder_width=8, batch_size=4, audio_path=audio,
                 visual_path=visual, ckpt_path=str(tmp_path / "ckpt"),
                 device="cpu")
    pths = glob.glob(str(tmp_path / "ckpt" / "best_model_of_dataset_*.pth"))
    if accs[1] > 0:  # a best accuracy after epoch 0 is saved
        assert pths and "The best model has been saved" in out.stdout
    else:  # nothing to save: write one through the same writer
        model, _ = build_intermediate(
            "mmformer_n", cfg.n_classes, 8, share_streams=True,
            generator=torch.Generator().manual_seed(3))
        pths = [save_best_checkpoint(cfg, model, 1, 0.0)]

    # the .pth, served, against the module it holds
    served = load_intermediate_from_checkpoint(cfg, "mmformer_n", pths[0],
                                               "cpu", share_streams=True)
    model, kind = build_intermediate("mmformer_n", cfg.n_classes, 8)
    sd = torch.load(pths[0], weights_only=False)["model"]
    model.load_state_dict(sd, strict=True)
    direct = TripleLogits(model, kind).eval()
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the dataset reads ./dataset/data
    try:
        batch = next(iter(Loader(make_dataset(cfg, "test"), 4, shuffle=False,
                                 drop_last=False, num_workers=0)))
    finally:
        os.chdir(cwd)
    got = served.eval_batch(batch)
    from gdl_tpu_torch.data.preprocess import make_eval_preprocess

    with torch.no_grad():
        b = make_eval_preprocess(cfg, torch.device("cpu"))(batch)
        want = direct(b["audio"], b["visual"])
    for g, w in zip(got["logits"], want):
        assert tuple(g.shape) == (4, 6)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert torch.equal(got["pred"], want[0].argmax(-1))

    # --export_path writes the .pth's serving artifact and exits; it
    # replays the 7-tuple whose logits are the module's
    out = _run(["--model", "mmformer_n", "--device", "cpu", "--ckpt_path",
                pths[0], "--export_path", str(tmp_path / "artifact")]
               + common, tmp_path, INTERMEDIATE)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Serving artifact written to" in out.stdout
    art = load_exported(str(tmp_path / "artifact"), "cpu").call(
        b["audio"], b["visual"])
    assert len(art) == 7
    for g, w in zip((art[0], art[5], art[6]), want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_port_intermediate_cli_mmtm_and_sefusion(tmp_path):
    audio, visual = _fixture_tree(tmp_path)
    common = _intermediate_common(audio, visual)
    for name in ("mmtm", "sefusion"):
        out = _run(["--train", "--model", name, "--device", "cpu",
                    "--ckpt_path", str(tmp_path / name), "--epochs", "1"]
                   + common, tmp_path, INTERMEDIATE)
        assert out.returncode == 0, out.stderr[-3000:]
        rows = (tmp_path / name / f"CREMAD_{name}.csv").read_text() \
            .strip().splitlines()
        assert rows[0] == "1000,1000,1000" and len(rows) == 2
