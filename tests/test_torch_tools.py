"""The port's offline tools against gdl_tpu's, on the CPU:
`python -m gdl_tpu_torch.preprocess_dataset` against
`tools/preprocess_dataset.py` (the cache byte for byte, then read back by
the port's datasets to the live path's batches), and `python -m
gdl_tpu_torch.inspect_checkpoint` on a `.pth` against
`tools/inspect_checkpoint.py` on gdl_tpu's msgpack of the same weights
(bridged by `utils/interop`): the same numbers."""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.data.datasets import CremadDataset as JaxCremad
from gdl_tpu.models.classifier import AVClassifierDGL as JaxDGL
from gdl_tpu_torch import inspect_checkpoint, preprocess_dataset
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.data import native
from gdl_tpu_torch.data.datasets import CremadDataset
from gdl_tpu_torch.data.loader import Loader
from gdl_tpu_torch.models.classifier import AVClassifierDGL
from gdl_tpu_torch.utils.checkpoint import save_best_checkpoint
from gdl_tpu_torch.utils.interop import state_dict_from_flax
from tests.test_datasets import make_cremad_tree
from tools import inspect_checkpoint as jax_inspect
from tools.preprocess_dataset import preprocess as jax_preprocess

NAMES = [(f"clip{i}", lbl) for i, lbl in enumerate(
    ["NEU", "HAP", "SAD", "FEA", "DIS", "ANG"])]


def _files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_preprocess_dataset_writes_the_tools_cache(tmp_path, monkeypatch):
    """On the CREMA-D fixture tree: the port's CLI (make_dataset's train
    and test lists, cwd holding dataset/data) writes, byte for byte, the
    files gdl_tpu's tool writes for the same clips; a second run skips
    them all. Read under --preprocessed_path, the port's datasets give
    the live path's samples (two epochs) and Loader batches."""
    monkeypatch.setattr(native, "available", lambda: False)
    audio, visual, data_root = make_cremad_tree(tmp_path, NAMES)
    jcfg = JaxConfig(dataset="CREMAD", fps=1, audio_path=audio,
                     visual_path=visual)
    ref_root = str(tmp_path / "ref")
    n = jax_preprocess(jcfg, ref_root, workers=2, datasets=[
        JaxCremad(jcfg, mode, data_root=data_root)
        for mode in ("train", "test")])
    assert n == len(NAMES)

    os.makedirs(tmp_path / "dataset")
    os.symlink(data_root.rstrip("/"), tmp_path / "dataset" / "data")
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "port")
    args = ["--dataset", "CREMAD", "--audio_path", audio, "--visual_path",
            visual, "--out", out, "--workers", "2", "--use_video_frames",
            "3"]
    assert preprocess_dataset.main(args) == 0
    written = _files(out)
    assert written == _files(ref_root) and len(written) == 4 * len(NAMES)
    mtimes = {p: os.path.getmtime(os.path.join(out, p)) for p in written}
    assert preprocess_dataset.main(args) == 0  # idempotent: nothing rewritten
    assert mtimes == {p: os.path.getmtime(os.path.join(out, p))
                      for p in written}

    kw = dict(dataset="CREMAD", fps=1, audio_path=audio, visual_path=visual,
              device="cpu")
    live = CremadDataset(Config(**kw), "train", data_root=data_root)
    cached = CremadDataset(Config(**kw, preprocessed_path=out), "train",
                           data_root=data_root)
    for epoch in (0, 1):
        live.set_epoch(epoch)
        cached.set_epoch(epoch)
        for i in range(len(live)):
            for a, b in zip(live[i], cached[i]):
                np.testing.assert_array_equal(a, b)
    batches = [list(Loader(ds, 2, shuffle=True, drop_last=True,
                           num_workers=1, seed=3)) for ds in (live, cached)]
    assert len(batches[0]) == len(NAMES) // 2
    for bl, bc in zip(*batches):
        assert sorted(bl) == sorted(bc)
        for k in bl:
            np.testing.assert_array_equal(bl[k], bc[k])


def _numbers(lines, schema):
    """The printed numbers, keyed alike for both tools: gdl_tpu's dense
    `kernel` [I, O] is the port's `weight` [O, I]."""
    out = {}
    layer = None
    for line in lines:
        m = re.match(r"(\w+): (kernel|weight) \(([\d, ]+)\) \|w\|=([\d.]+)$",
                     line)
        if m:
            layer = m.group(1)
            shape = tuple(int(s) for s in m.group(3).split(","))
            out[layer, "shape"] = shape[::-1] if schema == "port" else shape
            out[layer, "|w|"] = float(m.group(4))
            continue
        m = re.match(r"  \|(audio|visual) half\| += ([\d.]+)$", line)
        if m:
            out[layer, m.group(1)] = float(m.group(2))
            continue
        m = re.match(r"(\w+): ([\d,]+) params$", line)
        if m:
            out[m.group(1), "params"] = int(m.group(2).replace(",", ""))
            continue
        m = re.match(r"saved_epoch: (\S+)  acc: (\S+)  fusion: (\S+)  "
                     r"alpha: (\S+)$", line)
        assert m, line
        out["meta", ""] = (int(m.group(1)), float(m.group(2)), m.group(3),
                       float(m.group(4)))
    return out


def test_inspect_checkpoint_prints_the_tools_numbers(tmp_path, capsys,
                                                     monkeypatch):
    """One set of weights (gdl_tpu's tiny concat DGL classifier) as
    gdl_tpu's msgpack and, through the weight bridge, as the port's .pth:
    the two inspectors print the same epoch, accuracy, fusion and alpha,
    the fusion layers' shapes (transposed), mean |w| and audio / visual
    halves (to the printed 5 decimals), and the same parameter count of
    every top-level module. Given the msgpack, the port's inspector
    refuses it by name."""
    jcfg = JaxConfig(dataset="CREMAD", fusion_method="concat", alpha=4.0,
                     modulation="Normal", encoder_width=8,
                     encoder_stages=[1, 1, 1, 1], fps=1)
    model = JaxDGL(config=jcfg)
    f, t = jcfg.spec_shape
    variables = jax.jit(lambda k: model.init(
        {"params": k}, jnp.zeros((2, f, t, 1)),
        jnp.zeros((2, 1, 64, 64, 3)), train=False))(jax.random.PRNGKey(4))
    params = jax.tree.map(np.asarray, jax.device_get(variables["params"]))
    stats = jax.tree.map(np.asarray,
                         jax.device_get(variables["batch_stats"]))
    msgpack = str(tmp_path / "best.msgpack")
    with open(msgpack, "wb") as fh:
        fh.write(serialization.msgpack_serialize({
            "saved_epoch": 7, "modulation": "Normal", "alpha": 4.0,
            "fusion": "concat", "acc": 0.625,
            "model": {"params": params, "batch_stats": stats}}))
    cfg = Config(dataset="CREMAD", fusion_method="concat", alpha=4.0,
                 modulation="Normal", encoder_width=8,
                 encoder_stages=[1, 1, 1, 1], fps=1, device="cpu",
                 ckpt_path=str(tmp_path))
    port_model = AVClassifierDGL(cfg)
    port_model.load_state_dict(state_dict_from_flax(params, stats),
                               strict=True)
    pth = save_best_checkpoint(cfg, port_model, 7, 0.625,
                               path=str(tmp_path / "best.pth"))
    dim = "64"  # ResNet-18 at width 8: 8 * 8 features a modality

    monkeypatch.setattr(sys, "argv", ["inspect_checkpoint.py", msgpack,
                                      "--encoder_dim", dim])
    jax_inspect.main()
    want = _numbers(capsys.readouterr().out.splitlines(), "gdl_tpu")
    assert inspect_checkpoint.main([pth, "--encoder_dim", dim]) == 0
    got = _numbers(capsys.readouterr().out.splitlines(), "port")
    assert set(got) == set(want)
    assert ("fc_out", "audio") in want and ("audio_net", "params") in want
    for key, v in want.items():
        if isinstance(v, float):
            assert got[key] == pytest.approx(v, abs=1e-5), key
        else:
            assert got[key] == v, key
    with pytest.raises(ValueError, match="msgpack"):
        inspect_checkpoint.inspect(msgpack)
