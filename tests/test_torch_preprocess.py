"""The port's eval preprocessing against gdl_tpu's: the log-STFT audio
frontend (with and without the Swin 224² flat resize) and the antialiased
256→224 eval image resize + normalize. Inputs come from numpy seeds and
go to both packages as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config
from gdl_tpu.data.preprocess import make_eval_preprocess as jax_preprocess
from gdl_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from gdl_tpu.ops.image_ops import eval_preprocess as jax_eval_preprocess
from gdl_tpu.ops.stft import spectrogram_for_dataset as jax_spectrogram
from gdl_tpu_torch.data.preprocess import make_eval_preprocess
from gdl_tpu_torch.data.synthetic import synthetic_batch
from gdl_tpu_torch.ops.image_ops import eval_preprocess, resize_images
from gdl_tpu_torch.ops.stft import spectrogram_for_dataset


@pytest.mark.parametrize("swin", [False, True], ids=["resnet", "swin"])
@pytest.mark.parametrize("dataset", ["CREMAD", "KineticSound"])
def test_spectrogram_matches_jax(dataset, swin):
    """[B, F, T, 1] log-spectrograms agree to rtol 1e-4 and atol 1e-4,
    the bar tests/test_ops.py holds gdl_tpu's log_stft to against
    torch.stft: the log of |S| + 1e-7 magnifies float32 FFT rounding
    near spectral zeros."""
    cfg = Config(dataset=dataset)
    wave = synthetic_batch(cfg, 2, seed=3)["wave"]
    want = np.asarray(jax_spectrogram(jnp.asarray(wave), dataset, swin=swin))
    got = spectrogram_for_dataset(torch.from_numpy(wave), dataset,
                                  swin=swin).numpy()
    assert got.shape == want.shape
    assert want.shape == ((2, 224, 224, 1) if swin else
                          (2,) + cfg.spec_shape + (1,))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_eval_image_preprocess_matches_jax():
    """u8 frames 256→224: bilinear with antialias (jax.image.resize
    antialiases when downsampling) + ImageNet normalize, atol 1e-4."""
    frames = np.random.default_rng(5).integers(
        0, 256, (2, 2, 256, 256, 3), dtype=np.uint8)
    want = np.asarray(jax_eval_preprocess(jnp.asarray(frames), 224))
    got = eval_preprocess(torch.from_numpy(frames), 224).numpy()
    assert got.shape == want.shape == (2, 2, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_resize_without_antialias_would_not_match():
    """The trap the parity test guards: an antialias=False bilinear
    resize is far from the reference's resize on the 0-255 scale, the
    antialiased one is not."""
    frames = np.random.default_rng(6).integers(
        0, 256, (1, 1, 256, 256, 3), dtype=np.uint8)
    want = np.asarray(jax.image.resize(
        jnp.asarray(frames, jnp.float32), (1, 1, 224, 224, 3), "bilinear"))
    x = torch.from_numpy(frames).float()[0].permute(0, 3, 1, 2)
    plain = torch.nn.functional.interpolate(
        x, size=(224, 224), mode="bilinear", align_corners=False,
        antialias=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - want[0]).max() > 10.0
    got = resize_images(torch.from_numpy(frames), 224).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_synthetic_batches_are_identical():
    """Same seed, same raw request bytes in both packages."""
    cfg = Config(dataset="CREMAD")
    a = synthetic_batch(cfg, 2, seed=11)
    b = jax_synthetic_batch(cfg, 2, seed=11)
    for k in ("wave", "frames", "label"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_make_eval_preprocess_matches_jax():
    """The whole raw-batch eval preprocessing for the Swin config."""
    cfg = Config(dataset="CREMAD", backbone="swin")
    batch = synthetic_batch(cfg, 2, seed=12)
    want = jax_preprocess(cfg)({k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_preprocess(cfg, "cpu")(batch)
    for k in ("audio", "visual"):
        assert tuple(got[k].shape) == tuple(want[k].shape)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["label"].numpy(),
                                  np.asarray(want["label"]))
