"""The port's host data layer (numpy-only copies under
`gdl_tpu_torch/data`) against `gdl_tpu.data` on the on-disk fixture tree
of tests/test_datasets.py: file lists, per-sample decode, loader order
per epoch, wav decode, the offline cache, the synthetic dataset, and the
device preprocess of a loader batch. Host code is the same arithmetic on
both sides, so arrays compare EXACTLY; the device preprocess compares
within 2e-4 (STFT and resize in f32)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.data import cache as jax_cache
from gdl_tpu.data import datasets as jax_datasets
from gdl_tpu.data import wav as jax_wav
from gdl_tpu.data.loader import Loader as JaxLoader
from gdl_tpu.data.preprocess import make_eval_preprocess as jax_eval_pre
from gdl_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.data import cache, datasets, native, wav
from gdl_tpu_torch.data.loader import Loader
from gdl_tpu_torch.data.preprocess import (
    make_eval_preprocess,
    make_train_preprocess,
)
from gdl_tpu_torch.data.synthetic import SyntheticDataset
from tests.test_datasets import make_cremad_tree, write_wav

LABELS = ["NEU", "HAP", "SAD", "FEA", "DIS", "ANG"]


@pytest.fixture
def tree(tmp_path):
    names = [(f"clip{i}", lbl) for i, lbl in enumerate(LABELS * 2)]
    audio, visual, data_root = make_cremad_tree(tmp_path, names,
                                                missing=("clip3",))
    kw = dict(dataset="CREMAD", fps=1, audio_path=audio, visual_path=visual,
              batch_size=4, num_workers=2)
    return kw, data_root, tmp_path


def _equal_samples(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        a, b = [a[k] for k in sorted(a)], [b[k] for k in sorted(b)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("strict", [False, True], ids=["default", "strict"])
def test_cremad_lists_and_samples_equal(tree, strict):
    """Same file list, labels and skip rule; the same per-sample arrays
    at train (per-(seed, epoch, index) draws) and test, also under
    --strict_compat (host-exact 224² frames, a dict sample with the
    'host_exact' marker)."""
    kw, data_root, _ = tree
    kw = dict(kw, strict_compat=strict)
    for mode in ("train", "test"):
        ref = jax_datasets.CremadDataset(JaxConfig(**kw), mode,
                                         data_root=data_root)
        ds = datasets.CremadDataset(Config(**kw), mode, data_root=data_root)
        assert len(ds) == len(ref) == 11  # clip3 skipped
        assert ds.label == ref.label
        for epoch in (1, 2):
            ref.set_epoch(epoch)
            ds.set_epoch(epoch)
            for idx in (0, 5, 10):
                _equal_samples(ds[idx], ref[idx])
    if strict:
        assert "host_exact" in ds[0] and ds[0]["frames"].shape[1] == 224


def test_loader_order_and_batches_equal_per_epoch(tree):
    """Shuffled, drop_last loader: the same batches in the same order in
    epochs 0, 1 and a resumed epoch 3 (set_epoch), the same after
    skip_next_batches, and the ragged last batch when drop_last is off."""
    kw, data_root, _ = tree
    ref_ds = jax_datasets.CremadDataset(JaxConfig(**kw), "train",
                                        data_root=data_root)
    ds = datasets.CremadDataset(Config(**kw), "train", data_root=data_root)
    ref = JaxLoader(ref_ds, 4, shuffle=True, drop_last=True, num_workers=2,
                    seed=3)
    mine = Loader(ds, 4, shuffle=True, drop_last=True, num_workers=2, seed=3)
    assert len(mine) == len(ref) == 2 and mine.local_batch == 4
    seen = []
    for epoch in (0, 1, 3):
        ref.set_epoch(epoch)
        mine.set_epoch(epoch)
        got, want = list(mine), list(ref)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == ["frame_sizes", "frames", "label", "wave"]
            _equal_samples(g, w)
        seen.append(np.concatenate([g["label"] for g in got]))
    assert not all(np.array_equal(seen[0], s) for s in seen[1:])
    mine.set_epoch(1)
    mine.skip_next_batches(1)
    ref.set_epoch(1)
    (only,), full = list(mine), list(ref)
    _equal_samples(only, full[1])

    tail = Loader(ds, 4, shuffle=False, drop_last=False, num_workers=2)
    sizes = [len(b["label"]) for b in tail]
    assert sizes == [4, 4, 3] and len(tail) == 3


def test_wav_and_native_paths_equal(tree, tmp_path):
    """read_wav / resample / load_wav equal gdl_tpu's; the native
    library (when it builds) and the pure-numpy fallback give the port
    what they give gdl_tpu."""
    kw, _, _ = tree
    path = os.path.join(kw["audio_path"], "clip0.wav")
    for sr in (22050, 16000):
        np.testing.assert_array_equal(wav.load_wav(path, sr),
                                      jax_wav.load_wav(path, sr))
    w, rate = wav.read_wav(path)
    w2, rate2 = jax_wav.read_wav(path)
    assert rate == rate2 == 22050
    np.testing.assert_array_equal(w, w2)
    stereo = tmp_path / "s.wav"
    write_wav(stereo, np.sin(np.linspace(0, 50, 4000)) * 0.3, rate=8000)
    np.testing.assert_array_equal(wav.load_wav(str(stereo), 16000),
                                  jax_wav.load_wav(str(stereo), 16000))
    from gdl_tpu.data import native as jax_native

    assert native.available() == jax_native.available()
    a = datasets._audio_fixed(path, "CREMAD", None)
    b = jax_datasets._audio_fixed(path, "CREMAD", None)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (22050 * 3,) and a.dtype == np.float32


def test_offline_cache_round_trip_equal(tree):
    """cache.write_audio / write_frames write the files gdl_tpu's cache
    writes (same names, same bytes), and a dataset reading the port's
    cache yields the samples of a dataset reading gdl_tpu's."""
    kw, data_root, tmp = tree
    roots = {"port": str(tmp / "pre_port"), "ref": str(tmp / "pre_ref")}
    for name, (mod, dmod, cfg_cls) in {
            "port": (cache, datasets, Config),
            "ref": (jax_cache, jax_datasets, JaxConfig)}.items():
        ds = dmod.CremadDataset(cfg_cls(**kw), "train", data_root=data_root)
        for a, v in zip(ds.audio, ds.image):
            mod.write_audio(a, "CREMAD",
                            dmod.preprocessed_audio_file(roots[name], a))
            mod.write_frames(v, dmod.preprocessed_frames_file(roots[name],
                                                              v))
    files = sorted(os.listdir(roots["ref"]))
    assert files and files == sorted(os.listdir(roots["port"]))
    for f in files:
        pa, pb = (os.path.join(roots[k], f) for k in ("port", "ref"))
        if os.path.isdir(pa):
            assert sorted(os.listdir(pa)) == sorted(os.listdir(pb))
            continue
        assert open(pa, "rb").read() == open(pb, "rb").read(), f
    ds = datasets.CremadDataset(
        Config(**dict(kw, preprocessed_path=roots["port"])), "train",
        data_root=data_root)
    ref = jax_datasets.CremadDataset(
        JaxConfig(**dict(kw, preprocessed_path=roots["ref"])), "train",
        data_root=data_root)
    for idx in (0, 7):
        _equal_samples(ds[idx], ref[idx])
    got = list(Loader(ds, 4, shuffle=True, drop_last=True, num_workers=2))
    want = list(JaxLoader(ref, 4, shuffle=True, drop_last=True,
                          num_workers=2))
    for g, w in zip(got, want):
        _equal_samples(g, w)


def test_synthetic_dataset_and_make_dataset(tree):
    """SyntheticDataset samples equal gdl_tpu's; make_dataset dispatches
    on cfg.dataset and refuses an unknown one."""
    cfg = Config(dataset="CREMAD", fps=2)
    ref = JaxSynthetic(JaxConfig(dataset="CREMAD", fps=2), size=5, seed=4)
    ds = SyntheticDataset(cfg, size=5, seed=4)
    assert len(ds) == 5
    _equal_samples(ds[3], ref[3])
    assert ds[3][1].shape == (2, 256, 256, 3)
    assert isinstance(datasets.make_dataset.__doc__, str)
    with pytest.raises(NotImplementedError):
        datasets.make_dataset(dataclasses.replace(cfg, dataset="nope"),
                              "train")


def test_device_preprocess_of_loader_batches(tree):
    """A loader batch through the port's eval preprocess equals gdl_tpu's
    (atol 2e-4); under --strict_compat the host-exact frames are only
    normalised, at train and at eval."""
    kw, data_root, _ = tree
    cfg = Config(**kw)
    ds = datasets.CremadDataset(cfg, "test", data_root=data_root)
    batch = next(iter(Loader(ds, 4, shuffle=False, drop_last=True,
                             num_workers=2)))
    got = make_eval_preprocess(cfg, "cpu")(batch)
    want = jax_eval_pre(JaxConfig(**kw))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert got["audio"].shape == (4, 257, 188, 1)
    assert got["visual"].shape == (4, 1, 224, 224, 3)
    for k in ("audio", "visual"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=2e-4)
    np.testing.assert_array_equal(got["label"].numpy(), batch["label"])

    scfg = Config(**dict(kw, strict_compat=True))
    sds = datasets.CremadDataset(scfg, "train", data_root=data_root)
    sbatch = next(iter(Loader(sds, 4, shuffle=False, drop_last=True,
                              num_workers=2)))
    assert "host_exact" in sbatch and sbatch["frames"].shape[2] == 224
    gen = torch.Generator().manual_seed(0)
    tr = make_train_preprocess(scfg, "cpu")(sbatch, gen)
    ev = make_eval_preprocess(scfg, "cpu")(sbatch)
    swant = jax_eval_pre(JaxConfig(**dict(kw, strict_compat=True)))(
        {k: jnp.asarray(v) for k, v in sbatch.items()})
    assert torch.equal(tr["visual"], ev["visual"])  # no device augmentation
    np.testing.assert_allclose(ev["visual"].numpy(),
                               np.asarray(swant["visual"]), rtol=0,
                               atol=1e-5)
