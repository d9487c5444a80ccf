"""`python -m gdl_tpu_torch.main --device cpu ...` (the joint / OGM-GE
lineage of main.py) as a subprocess over an on-disk CREMA-D fixture tree,
as a user would run it: live OGM-GE, a tiny dual ResNet-18, two epochs
(the best `.pth` is written only after epoch 0, main_dgl.py:349), the
accuracy CSV, the best `.pth` and a TensorBoard event file; then eval
mode from that `.pth` to the accuracy the run logged, the same `.pth`
served through `serve.load_from_checkpoint(dgl=False)` to the same
predictions, the serving artifact that eval mode writes with
`--export_path --export_poly_batch 1` to the model's 11-tuple, and the
refusal of CUDA without --device cpu."""

import glob
import os

import numpy as np

from tests.test_torch_cli import _fixture_tree, _run

MAIN = "gdl_tpu_torch.main"


def _common(audio, visual):
    return ["--dataset", "CREMAD", "--modulation", "OGM_GE",
            "--fusion_method", "concat", "--alpha", "0.3",
            "--audio_path", audio, "--visual_path", visual,
            "--batch_size", "4", "--num_workers", "2", "--encoder_width", "8",
            "--encoder_stages", "1,1,1,1", "--learning_rate", "0.002",
            "--eval_drop_last", "0"]


def test_port_joint_cli_train_eval_serve(tmp_path):
    import torch

    from gdl_tpu_torch.config import Config
    from gdl_tpu_torch.data.datasets import make_dataset
    from gdl_tpu_torch.data.loader import Loader
    from gdl_tpu_torch.data.preprocess import make_eval_preprocess
    from gdl_tpu_torch.serve import (
        build_model,
        load_exported,
        load_from_checkpoint,
    )
    from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint
    from gdl_tpu_torch.utils.metrics import PerClassAccuracy

    audio, visual = _fixture_tree(tmp_path)
    common = _common(audio, visual)

    # without --device cpu, a machine without CUDA raises and runs nothing
    if not torch.cuda.is_available():
        out = _run(["--train", "--ckpt_path", str(tmp_path / "none"),
                    "--epochs", "1"] + common, tmp_path, MAIN)
        assert out.returncode != 0
        assert "CUDA is not available" in out.stderr
        assert "Start training" not in out.stdout
        assert not (tmp_path / "none").exists()

    ckpt, tb = tmp_path / "ckpt", tmp_path / "tb"
    out = _run(["--train", "--device", "cpu", "--ckpt_path", str(ckpt),
                "--epochs", "2", "--use_tensorboard", "1",
                "--tensorboard_path", str(tb)] + common, tmp_path, MAIN)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Start training" in out.stdout
    rows = (ckpt / "CREMAD_full.csv").read_text().strip().splitlines()
    assert rows[0] == "1000,1000,1000" and len(rows) == 3
    accs = [float(r.split(",")[0]) for r in rows[1:]]
    # the joint lineage writes no per-step gradient CSV (a DGL artifact)
    assert not (tmp_path / "audio_visual_grad_vanilla.csv").exists()
    events = glob.glob(str(tb / "CREMAD" / "concat_OGM_GE" / "events.*"))
    assert events and os.path.getsize(events[0]) > 0

    cfg = Config(dataset="CREMAD", modulation="OGM_GE",
                 fusion_method="concat", alpha=0.3, encoder_width=8,
                 encoder_stages=[1, 1, 1, 1], batch_size=4, num_workers=2,
                 eval_drop_last=False, audio_path=audio, visual_path=visual,
                 learning_rate=0.002, ckpt_path=str(ckpt), device="cpu")
    pths = glob.glob(str(ckpt / "best_model_of_dataset_*.pth"))
    if accs[1] > 0:  # accuracy improved after epoch 0: saved by the loop
        assert len(pths) == 1
        assert "The best model has been saved" in out.stdout
        want_acc = accs[1]
    else:  # nothing to save: write one through the same writer
        pths = [save_best_checkpoint(
            cfg, build_model(cfg, seed=0, dgl=False), 1, 0.0)]
        want_acc = None

    # eval mode from the .pth: the accuracy the training run logged; with
    # --export_path the .pth's serving artifact (any batch size) as well
    artifact = str(tmp_path / "artifact")
    out = _run(["--ckpt_path", pths[0], "--device", "cpu", "--export_path",
                artifact, "--export_poly_batch", "1"] + common,
               tmp_path, MAIN)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Trained model loaded!" in out.stdout
    assert "Serving artifact written to" in out.stdout
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("Accuracy: ")][-1]
    acc = float(line.split(",")[0].split()[-1])
    if want_acc is not None:
        assert acc == want_acc

    # the .pth served: the same predictions, and that accuracy again
    cwd = os.getcwd()
    os.chdir(tmp_path)  # CremadDataset reads ./dataset/data/CREMAD/*.csv
    try:
        test_set = make_dataset(cfg, "test")
    finally:
        os.chdir(cwd)
    served = load_from_checkpoint(cfg, pths[0], "cpu", dgl=False)
    exported = load_exported(artifact, "cpu")
    model = build_model(cfg, seed=3, dgl=False)
    model.load_state_dict(torch.load(pths[0], weights_only=False)["model"])
    model.eval()
    preprocess = make_eval_preprocess(cfg, torch.device("cpu"))
    counters = PerClassAccuracy(cfg.n_classes)
    for batch in Loader(test_set, 4, shuffle=False, drop_last=False,
                        num_workers=2, seed=0):
        res = served.eval_batch(batch)
        assert torch.equal(res["pred"], res["pred_a"])
        with torch.no_grad():
            pre = preprocess(batch)
            out_model = model(pre["audio"], pre["visual"])
        np.testing.assert_array_equal(res["pred"].numpy(),
                                      out_model[2].argmax(-1).numpy())
        replayed = exported.call(pre["audio"], pre["visual"])
        assert len(replayed) == 11
        for g, w in zip(replayed, out_model):
            if isinstance(w, torch.Tensor):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
            else:  # the PE entries without --pe
                assert g == w == 0
        counters.update(res["pred"].numpy(), res["pred_a"].numpy(),
                        res["pred_v"].numpy(), np.asarray(batch["label"]))
    assert counters.results()[0] == acc


def test_profile_step_joint_takes_resnet_or_swin():
    """`python -m gdl_tpu_torch.profile_step --joint 1` profiles the joint
    step of the ResNet or Swin backbone; with mmformer it is refused at
    parse time, and without a card it raises before any work."""
    import pytest
    import torch

    from gdl_tpu_torch import profile_step

    with pytest.raises(SystemExit) as exc:
        profile_step.main(["--joint", "1", "--backbone", "mmformer"])
    assert exc.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            profile_step.main(["--joint", "1", "--backbone", "resnet"])
