"""The port's Swin encoder in training mode against gdl_tpu's training
branch, and the port's DropPath.

gdl_tpu trains Swin through its Pallas entry `window_attention_pallas_
qkv_fused` (interpret mode here, the backend gate patched as
tests/test_torch_swin.py does); the port's training mode runs the plain
versions of kernels #2 and #4 on the CPU. DropPath draws differ between
the two RNGs, so the comparison turns it off on both sides: the port's
rate is 0 and gdl_tpu's DropPath.__call__ is monkeypatched to the
identity (nothing in gdl_tpu is edited).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.models.swin import SwinTransformer as JaxSwin
from gdl_tpu_torch.models.swin import DropPath, SwinTransformer
from gdl_tpu_torch.utils.interop import state_dict_from_flax

SWIN_KW = dict(img_size=56, patch_size=4, embed_dim=128, depths=(2,),
               num_heads=(4,), window=7)


def test_swin_encoder_train_mode_matches_jax_training_branch(monkeypatch):
    """Embed 128, 4 heads, depths (2,), img 56 (a 14x14 map of four 7x7
    windows; the second block is shifted and masked), 2 frames: the
    feature map and the gradient of every parameter of sum(sin(map))
    against gdl_tpu's train=True branch (use_pallas_attn=True), rtol 5e-4
    and atol 5e-5 on the map, and on each gradient atol 5e-5 of its
    largest magnitude (the worst parameter measured 1.0e-6 of it)."""
    import gdl_tpu.models.swin as swin_mod

    monkeypatch.setattr(swin_mod, "is_tpu_backend", lambda: True)
    monkeypatch.setattr(swin_mod.DropPath, "__call__",
                        lambda self, x, train: x)
    jax_model = JaxSwin(modality="visual", use_pallas_attn=True,
                        fuse_qkv_gemm=True, window_resident=True, **SWIN_KW)
    x = np.random.default_rng(41).standard_normal(
        (1, 2, 56, 56, 3)).astype(np.float32)
    variables = jax_model.init({"params": jax.random.PRNGKey(17)},
                               jnp.asarray(x), train=False)

    def loss_fn(params):
        out = jax_model.apply({"params": params}, jnp.asarray(x), train=True,
                              rngs={"droppath": jax.random.PRNGKey(0)})
        return jnp.sum(jnp.sin(out)), out

    (_, want), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])

    model = SwinTransformer("visual", drop_path_rate=0.0, **SWIN_KW).train()
    model.load_state_dict(state_dict_from_flax(variables["params"], {}),
                          strict=True)
    got = model(torch.from_numpy(x))
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=5e-4, atol=5e-5)

    want_grads = state_dict_from_flax(jgrads, {})
    named = dict(model.named_parameters())
    assert sorted(want_grads) == sorted(named)
    for name, g in want_grads.items():
        g = g.numpy()
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=0,
                                   atol=5e-5 * float(np.abs(g).max()),
                                   err_msg=name)


def test_train_mode_without_droppath_equals_eval_mode():
    """At rate 0 the training path (train op, plain versions) gives the
    eval path's output bit for bit."""
    kw = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2,),
              num_heads=(2,), window=7)
    model = SwinTransformer("audio", drop_path_rate=0.0,
                            generator=torch.Generator().manual_seed(2), **kw)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 56, 56, 1)).astype(np.float32))
    train_out = model.train()(x)
    with torch.no_grad():
        eval_out = model.eval()(x)
    assert torch.equal(train_out.detach(), eval_out)


def test_droppath_rates_rise_linearly_over_the_blocks():
    """Rates are np.linspace(0, 0.1, sum(depths)) in block order, the
    same on both residual branches (Swin-B depths 2-2-18-2)."""
    model = SwinTransformer("visual", img_size=224, embed_dim=8,
                            depths=(2, 2, 18, 2), num_heads=(1, 1, 1, 1))
    rates = [(blk.drop_path1.rate, blk.drop_path2.rate)
             for layer in model.layers for blk in layer.blocks]
    want = np.linspace(0, 0.1, 24)
    np.testing.assert_array_equal([r[0] for r in rates], want)
    np.testing.assert_array_equal([r[1] for r in rates], want)
    assert not any("drop_path" in k for k in model.state_dict())


def test_droppath_statistics_and_determinism():
    """Per-sample Bernoulli(keep) masks: the keep rate is 1 - rate within
    5 standard deviations over 20000 samples, every element of a sample
    shares its draw, kept samples are exactly x / keep, dropped ones are
    0; the same generator seed gives the same masks, another seed other
    masks; eval mode is the identity."""
    rate, n = 0.25, 20000
    dp = DropPath(rate).train()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, 3, 4)).astype(np.float32))
    y = dp(x, torch.Generator().manual_seed(7))
    kept = (y != 0).all(dim=(1, 2))
    dropped = (y == 0).all(dim=(1, 2))
    assert bool((kept | dropped).all())  # one draw per sample
    frac = float(kept.float().mean())
    assert abs(frac - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / n)
    assert torch.equal(y[kept], x[kept] / (1 - rate))

    again = dp(x, torch.Generator().manual_seed(7))
    other = dp(x, torch.Generator().manual_seed(8))
    assert torch.equal(y, again) and not torch.equal(y, other)

    assert dp.eval()(x) is x
    assert DropPath(0.0).train()(x) is x
    bf = dp.train()(x.bfloat16(), torch.Generator().manual_seed(7))
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_droppath_is_deterministic_per_generator(seed):
    """A training-mode encoder forward with droppath on depends only on
    the generator's seed."""
    kw = dict(img_size=56, patch_size=4, embed_dim=16, depths=(2, 2),
              num_heads=(2, 2), window=7, drop_path_rate=0.5)
    model = SwinTransformer("audio", generator=torch.Generator()
                            .manual_seed(1), **kw).train()
    x = torch.ones(4, 56, 56, 1)
    with torch.no_grad():
        a = model(x, torch.Generator().manual_seed(seed))
        b = model(x, torch.Generator().manual_seed(seed))
        c = model(x, torch.Generator().manual_seed(seed + 10))
    assert torch.equal(a, b) and not torch.equal(a, c)
