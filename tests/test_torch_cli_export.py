"""The evaluation and serving-export entry points as subprocesses over the
CREMA-D fixture tree, as a user would run them on the CPU:
`python -m gdl_tpu_torch.valid --export_path`, `python -m
gdl_tpu_torch.main --export_path` (eval mode) and `python -m
gdl_tpu_torch.main_intermediate --export_path --export_poly_batch 1`.
Each evaluates or exports a `.pth` written here by the port's checkpoint
writer, and each artifact replays on the CPU the outputs of the module
the `.pth` holds (atol 1e-5: the same plain ops in the same order)."""

import os

import numpy as np
import torch

from tests.test_torch_cli import _fixture_tree, _run

TINY = ["--dataset", "CREMAD", "--modulation", "Normal",
        "--fusion_method", "concat", "--batch_size", "4", "--num_workers",
        "0", "--encoder_width", "8", "--encoder_stages", "1,1,1,1",
        "--eval_drop_last", "1"]


def _setup(tmp_path, **kw):
    from gdl_tpu_torch.config import Config
    from gdl_tpu_torch.data.datasets import make_dataset
    from gdl_tpu_torch.data.loader import Loader
    from gdl_tpu_torch.data.preprocess import make_eval_preprocess

    audio, visual = _fixture_tree(tmp_path)
    cfg = Config(dataset="CREMAD", modulation="Normal",
                 fusion_method="concat", encoder_width=8,
                 encoder_stages=[1, 1, 1, 1], batch_size=4,
                 eval_drop_last=True, audio_path=audio, visual_path=visual,
                 ckpt_path=str(tmp_path / "ckpt"), device="cpu", **kw)
    cwd = os.getcwd()
    os.chdir(tmp_path)  # CremadDataset reads ./dataset/data/CREMAD/*.csv
    try:
        batches = list(Loader(make_dataset(cfg, "test"), 4, shuffle=False,
                              drop_last=True, num_workers=0))
    finally:
        os.chdir(cwd)
    pre = make_eval_preprocess(cfg, torch.device("cpu"))
    return cfg, [audio, visual], batches, [pre(b) for b in batches]


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert g == w == 0


def test_valid_cli_evaluates_and_exports(tmp_path):
    """valid.py's flags and accounting: the accuracy of the `.pth` over
    the test split, then its artifact, whose predictions give that
    accuracy again."""
    from gdl_tpu_torch.serve import build_model, load_exported
    from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint
    from gdl_tpu_torch.utils.metrics import PerClassAccuracy

    cfg, paths, batches, pre = _setup(tmp_path)
    model = build_model(cfg, seed=8)
    pth = save_best_checkpoint(cfg, model, 1, 0.5)
    artifact = str(tmp_path / "valid.pt2")
    out = _run(["--ckpt_path", pth, "--device", "cpu", "--audio_path",
                paths[0], "--visual_path", paths[1], "--export_path",
                artifact] + TINY, tmp_path, "gdl_tpu_torch.valid")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Trained model loaded!" in out.stdout
    assert "Serving artifact written to" in out.stdout
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("Accuracy: ")][-1]
    acc = float(line.split(",")[0].split()[-1])

    exported = load_exported(artifact, "cpu")
    assert exported.devices == ("cpu", "cuda") and not exported.poly_batch
    counters = PerClassAccuracy(cfg.n_classes)
    model.eval()
    for batch, b in zip(batches, pre):
        got = exported.call(b["audio"], b["visual"])
        with torch.no_grad():
            _close(got, model(b["audio"], b["visual"]))
        counters.update(*(o.argmax(-1).numpy() for o in got),
                        np.asarray(batch["label"]))
    assert counters.results()[0] == acc


def test_main_cli_exports_the_joint_eval_forward(tmp_path):
    """main.py's eval mode with --export_path: a fixed-shape artifact of
    the joint classifier's 11-tuple, which refuses another batch."""
    import pytest

    from gdl_tpu_torch.serve import build_model, load_exported
    from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint

    cfg, paths, _, pre = _setup(tmp_path, alpha=0.3)
    model = build_model(cfg, seed=9, dgl=False)
    pth = save_best_checkpoint(cfg, model, 1, 0.5)
    artifact = str(tmp_path / "joint.pt2")
    out = _run(["--ckpt_path", pth, "--device", "cpu", "--alpha", "0.3",
                "--audio_path", paths[0], "--visual_path", paths[1],
                "--export_path", artifact] + TINY, tmp_path,
               "gdl_tpu_torch.main")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Serving artifact written to" in out.stdout
    exported = load_exported(artifact, "cpu")
    model.eval()
    for b in pre:
        with torch.no_grad():
            _close(exported.call(b["audio"], b["visual"]),
                   model(b["audio"], b["visual"]))
    with pytest.raises(Exception):
        exported.call(pre[0]["audio"][:3], pre[0]["visual"][:3])


def test_main_intermediate_cli_exports_any_batch(tmp_path):
    """main_intermediate.py --export_path --export_poly_batch 1 on a
    SE-fusion `.pth`: one artifact, the AV adapter inside, replays its
    single logits at batches 4 and 3."""
    from gdl_tpu_torch.models.intermediate import build_intermediate
    from gdl_tpu_torch.serve import load_exported
    from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint

    cfg, paths, _, pre = _setup(tmp_path, alpha=2.0, fps=1)
    model, kind = build_intermediate(
        "sefusion", cfg.n_classes, 8,
        generator=torch.Generator().manual_seed(10))
    pth = save_best_checkpoint(cfg, model, 1, 0.5)
    artifact = str(tmp_path / "sefusion.pt2")
    out = _run(["--model", "sefusion", "--ckpt_path", pth, "--device", "cpu",
                "--alpha", "2", "--audio_path", paths[0], "--visual_path",
                paths[1], "--export_path", artifact, "--export_poly_batch",
                "1"] + TINY, tmp_path, "gdl_tpu_torch.main_intermediate")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Serving artifact written to" in out.stdout
    exported = load_exported(artifact, "cpu")
    assert exported.poly_batch and kind == "single"
    model.eval()
    for rows in (4, 3):
        a, v = pre[0]["audio"][:rows], pre[0]["visual"][:rows]
        got = exported.call(a, v)
        with torch.no_grad():
            want = model(a, v, av_inputs=True)
        assert tuple(got.shape) == (rows, cfg.n_classes)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
