"""The port's train-time augmentation against gdl_tpu's.

The torch RNG is not JAX's, so the comparison hands the port the boxes
and flip bits that gdl_tpu's `_rrc_one` draws from its keys and holds
the port's deterministic `crop_resize_flip` to gdl_tpu's
`random_resized_crop_flip`. The port's own sampler is held to
torchvision's rules (valid boxes, the fallback crop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.ops import image_ops as jax_image_ops
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.data.preprocess import (
    make_eval_preprocess,
    make_train_preprocess,
)
from gdl_tpu_torch.data.synthetic import synthetic_batch
from gdl_tpu_torch.ops.image_ops import (
    crop_resize_flip,
    normalize_images,
    sample_rrc_box,
)


def _jax_draws(key, b, t, h, w, orig_sizes=None):
    """The boxes [B, T, 4] and flips [B, T] that gdl_tpu's
    random_resized_crop_flip draws from `key` (same key splits as
    gdl_tpu/ops/image_ops.py::_rrc_one)."""
    keys = jax.random.split(key, b * t)
    boxes, flips = [], []
    for i, k in enumerate(keys):
        k_box, k_flip = jax.random.split(k)
        if orig_sizes is None:
            hh, ww = h, w
        else:
            hh, ww = (max(float(s), 1.0) for s in orig_sizes.reshape(-1, 2)[i])
        boxes.append([float(v) for v in
                      jax_image_ops.sample_rrc_box(k_box, hh, ww)])
        flips.append(bool(jax.random.bernoulli(k_flip)))
    return (np.array(boxes, np.float32).reshape(b, t, 4),
            np.array(flips).reshape(b, t))


@pytest.mark.parametrize("orig", [False, True], ids=["canvas", "orig_sizes"])
def test_crop_resize_flip_matches_jax_rrc(orig):
    """2 clips x 2 frames of 256² uint8 canvases to 224²: with the boxes
    and flips gdl_tpu draws, the port's output equals gdl_tpu's within
    atol 1e-4 (normalized units), in canvas coordinates and with
    per-frame original sizes. At least one crop is larger than 224 on
    the canvas (above 240), so the antialiased (widened-kernel) resampling is
    exercised, and both flip values occur."""
    b, t, r, size = 2, 2, 256, 224
    rng = np.random.default_rng(9)
    # pixel noise of amplitude 64: gdl_tpu's own f32 sample positions
    # near 256 are off by up to ~1.5e-5 px, which moves a resampled
    # value by that times the contrast of neighbouring pixels; at full
    # 0-255 contrast that alone reaches 1.3e-4 normalized units
    frames = rng.integers(96, 160, (b, t, r, r, 3), dtype=np.uint8)
    sizes = np.array([[[360, 480], [240, 320]], [[300, 300], [480, 272]]],
                     np.int32) if orig else None
    key = jax.random.PRNGKey(7 if orig else 1)
    want = jax_image_ops.random_resized_crop_flip(
        jnp.asarray(frames), key, size=size,
        orig_sizes=None if sizes is None else jnp.asarray(sizes))
    boxes, flips = _jax_draws(key, b, t, r, r, sizes)
    got = crop_resize_flip(torch.from_numpy(frames), torch.from_numpy(boxes),
                           torch.from_numpy(flips), size,
                           None if sizes is None else torch.from_numpy(sizes))
    assert tuple(got.shape) == (b, t, size, size, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    scale = (np.ones((b, t, 2)) if sizes is None
             else r / sizes.astype(np.float64))
    canvas = boxes[..., 2:] * scale
    assert (canvas > 240).any(), canvas
    assert flips.any() and not flips.all()


def test_sampler_boxes_are_valid_and_fall_back():
    """Boxes from 2000 draws over mixed image sizes are integral and
    inside the image, with aspect in [3/4, 4/3] and area in
    [0.08, 1]·H·W up to the integer rounding; images no candidate fits
    get torchvision's ratio-clamped center crop."""
    gen = torch.Generator().manual_seed(0)
    hw = torch.tensor([[256, 256], [120, 500], [500, 120], [7, 9]] * 500,
                      dtype=torch.float32)
    h, w = hw[:, 0], hw[:, 1]
    y0, x0, ch, cw = sample_rrc_box(gen, h, w)
    for v in (y0, x0, ch, cw):
        assert torch.equal(v, v.round())
    assert bool(((y0 >= 0) & (x0 >= 0) & (ch >= 1) & (cw >= 1)
                 & (y0 + ch <= h) & (x0 + cw <= w)).all())
    big = h * w > 1000  # rounding distorts tiny crops
    ratio, area = (cw / ch)[big], (cw * ch / (h * w))[big]
    assert bool(((ratio > 0.7) & (ratio < 1.4)).all())
    assert bool(((area > 0.07) & (area < 1.05)).all())

    wide = torch.tensor([10.0, 1000.0]), torch.tensor([1000.0, 10.0])
    got = torch.stack(sample_rrc_box(gen, *wide), dim=1)
    # h=10, w=1000: no candidate fits → w clamped to round(10·4/3)=13,
    # centered; and the transpose
    assert got.tolist() == [[0.0, 493.0, 10.0, 13.0], [493.0, 0.0, 13.0, 10.0]]


def test_train_preprocess_on_a_raw_batch():
    """make_train_preprocess: the eval spectrograms, augmented 224² frames
    (finite, normalized range), equal for equal generator seeds and
    different otherwise; a strict_compat host-exact batch (224² frames
    cropped on the host, marked 'host_exact') is only normalized, and a
    marked batch of another size is refused."""
    cfg = Config(dataset="CREMAD", backbone="swin", fps=2)
    batch = synthetic_batch(cfg, 2, seed=1)
    pre = make_train_preprocess(cfg, "cpu")
    a = pre(batch, torch.Generator().manual_seed(3))
    b = pre(batch, torch.Generator().manual_seed(3))
    c = pre(batch, torch.Generator().manual_seed(4))
    ev = make_eval_preprocess(cfg, "cpu")(batch)
    assert torch.equal(a["audio"], ev["audio"])
    assert tuple(a["visual"].shape) == (2, 2, 224, 224, 3)
    assert bool(torch.isfinite(a["visual"]).all())
    assert float(a["visual"].abs().max()) < 3.0
    assert torch.equal(a["visual"], b["visual"])
    assert not torch.equal(a["visual"], c["visual"])
    assert torch.equal(a["label"], torch.as_tensor(batch["label"]))
    strict = make_train_preprocess(Config(dataset="CREMAD", backbone="swin",
                                          strict_compat=True), "cpu")
    with pytest.raises(AssertionError, match="host_exact"):
        strict(dict(batch, host_exact=True))  # 256² canvas frames
    exact = dict(batch, frames=batch["frames"][:, :, :224, :224],
                 host_exact=True)
    got = strict(exact, torch.Generator().manual_seed(3))
    assert torch.equal(got["visual"],
                       normalize_images(torch.from_numpy(exact["frames"])))
    # without the marker the same frames take the device augmentation
    del exact["host_exact"]
    aug = strict(exact, torch.Generator().manual_seed(3))
    assert not torch.equal(aug["visual"], got["visual"])
