"""The port's Swin model under its kernel flags against gdl_tpu's.

`fuse_qkv=False` (`--fuse_qkv_gemm 0`) runs the qkv projection as
nn.Linear and `window_attention_qkv`; `fuse_mlp=True` (`--fuse_mlp 1`)
runs each block's MLP as `mlp_fused`. On the CPU both run the plain
versions of their kernels. gdl_tpu takes the same flags to its Pallas
entries, which run in interpret mode here with its backend gate patched
(as tests/test_swin.py and tests/test_mlp_kernel.py do); its DropPath is
patched to the identity, because the two RNGs draw differently. Also
here: the flags leave the state dict alone, `Config`'s four kernel flags
reach the modules through `build_model`, and `--dp` / `--mp` above one
device raise.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.models.classifier import AVClassifierSwinDGL as JaxSwinDGL
from gdl_tpu.models.swin import SwinTransformer as JaxSwin
from gdl_tpu.train import dgl as jax_dgl
from gdl_tpu.train import optim as jax_optim
from gdl_tpu_torch import kernels
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models.classifier import AVClassifierSwinDGL
from gdl_tpu_torch.models.swin import Mlp, SwinTransformer, WindowAttention
from gdl_tpu_torch.serve import build_model
from gdl_tpu_torch.train.dgl import make_dgl_train_step
from gdl_tpu_torch.train.loop import check_supported
from gdl_tpu_torch.train.optim import make_optimizer
from gdl_tpu_torch.utils.interop import state_dict_from_flax

# embed 128 / 4 heads is the smallest width gdl_tpu's kernels take (a head
# group must fill 128 lanes); img 56 gives a 14x14 map of four 7x7 windows,
# so the second block is shifted and masked
SWIN_KW = dict(img_size=56, patch_size=4, embed_dim=128, depths=(2,),
               num_heads=(4,), window=7)
FLAGS = [dict(fuse_qkv=False, fuse_mlp=False),
         dict(fuse_qkv=True, fuse_mlp=True),
         dict(fuse_qkv=False, fuse_mlp=True)]
FLAG_IDS = ["qkv_outside", "mlp_fused", "both"]


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jax_kernel_branches(monkeypatch):
    """gdl_tpu's models take their Pallas branches off the TPU (the ops
    then run in interpret mode), without DropPath."""
    import gdl_tpu.models.swin as swin_mod

    monkeypatch.setattr(swin_mod, "is_tpu_backend", lambda: True)
    monkeypatch.setattr(swin_mod.DropPath, "__call__",
                        lambda self, x, train: x)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_swin_encoder_flag_paths_match_jax(jax_kernel_branches, flags):
    """2 frames of 56x56: the feature map within 2e-4 and the gradient of
    every parameter of sum(sin(map)) within 5e-5 of its largest value,
    against gdl_tpu's train=True branch under the same flags; the flax
    tree (mlp_fc1 / mlp_fc2 under fuse_mlp included) bridges as it is."""
    jax_model = JaxSwin(modality="visual", use_pallas_attn=True,
                        fuse_qkv_gemm=flags["fuse_qkv"],
                        fuse_mlp=flags["fuse_mlp"], window_resident=True,
                        **SWIN_KW)
    x = np.random.default_rng(43).standard_normal(
        (1, 2, 56, 56, 3)).astype(np.float32)
    variables = jax_model.init({"params": jax.random.PRNGKey(19)},
                               jnp.asarray(x), train=False)

    def loss_fn(params):
        out = jax_model.apply({"params": params}, jnp.asarray(x), train=True,
                              rngs={"droppath": jax.random.PRNGKey(0)})
        return jnp.sum(jnp.sin(out)), out

    (_, want), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])

    model = SwinTransformer("visual", drop_path_rate=0.0, **SWIN_KW,
                            **flags).train()
    model.load_state_dict(state_dict_from_flax(variables["params"], {}),
                          strict=True)
    before = dict(kernels.launch_counts)
    got = model(torch.from_numpy(x))
    torch.sin(got).sum().backward()
    assert kernels.launch_counts == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-4)
    want_grads = state_dict_from_flax(jgrads, {})
    named = dict(model.named_parameters())
    assert sorted(want_grads) == sorted(named)
    for name, g in want_grads.items():
        g = g.numpy()
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=0,
                                   atol=5e-5 * float(np.abs(g).max()),
                                   err_msg=name)


def test_flag_paths_equal_the_default_path_in_f32():
    """Every flag setting computes the same function: training-mode maps
    within 1e-5 of the default path's, eval-mode maps too (fuse_qkv=False
    takes the plain eval attention)."""
    kw = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2,),
              num_heads=(2,), window=7, drop_path_rate=0.0)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 56, 56, 1)).astype(np.float32))
    base = SwinTransformer("audio", generator=torch.Generator()
                           .manual_seed(2), **kw)
    with torch.no_grad():
        want_train, want_eval = base.train()(x), base.eval()(x)
    for flags in FLAGS + [dict(attn_eval_impl="plain"),
                          dict(attn_impl="plain", fuse_mlp=True)]:
        model = SwinTransformer("audio", **kw, **flags)
        model.load_state_dict(base.state_dict(), strict=True)
        with torch.no_grad():
            torch.testing.assert_close(model.train()(x), want_train,
                                       atol=1e-5, rtol=0)
            torch.testing.assert_close(model.eval()(x), want_eval,
                                       atol=1e-5, rtol=0)


def test_flags_change_no_parameter_name_shape_or_initial_value():
    """State-dict keys, shapes and seeded initial values are equal under
    every setting of the flags (gdl_tpu: tests/test_swin.py:444,
    tests/test_mlp_kernel.py:102)."""
    kw = dict(img_size=56, patch_size=4, embed_dim=16, depths=(1, 1),
              num_heads=(2, 2), window=7)

    def build(**flags):
        return SwinTransformer(
            "visual", generator=torch.Generator().manual_seed(5), **kw,
            **flags).state_dict()

    want = build()
    for fuse_qkv, fuse_mlp, impl in itertools.product(
            (True, False), (False, True), ("auto", "plain")):
        got = build(fuse_qkv=fuse_qkv, fuse_mlp=fuse_mlp, attn_impl=impl,
                    attn_eval_impl=impl)
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def _tiny_cfg(cls, **kw):
    base = dict(dataset="VGGSound", fusion_method="concat", alpha=3.0,
                log_grad_csv=True, learning_rate=0.05, lr_decay_step=[2],
                backbone="swin", swin_embed_dim=128, swin_depths=[1],
                swin_heads=[4], swin_window=7, swin_img_size=28, swin_patch=4)
    base.update(kw)
    return cls(**base)


METRICS = ("loss", "loss_f", "loss_a", "loss_v", "grad_norm",
           "audio_grad_sum", "visual_grad_sum", "abs_out_a", "abs_out_v")


def test_dgl_step_under_flags_matches_jax_step(jax_kernel_branches):
    """--fuse_qkv_gemm 0 --fuse_mlp 1 on both sides, one DGL step on a
    dual Swin of one 128-wide block (one 7x7 window), batch 8: every
    metric within rtol 1e-5 (atol 1e-6) and every parameter after the
    step within 1e-6, against gdl_tpu's jitted step."""
    flags = dict(fuse_qkv_gemm=False, fuse_mlp=True)
    jcfg = _tiny_cfg(JaxConfig, **flags)
    cfg = _tiny_cfg(Config, device="cpu", **flags)
    rng = np.random.default_rng(0)
    batch = {"audio": rng.standard_normal((8, 28, 28, 1)).astype(np.float32),
             "visual": rng.standard_normal((8, 1, 28, 28, 3)).astype(
                 np.float32),
             "label": rng.integers(0, 309, 8).astype(np.int32)}
    jmodel = JaxSwinDGL(config=jcfg)
    jopt = jax_optim.make_optimizer(
        jcfg, 2, clip_norm=40.0,
        wd_mask=jax_optim.dead_fusion_param_mask(jcfg, dgl=True))
    params = jax.jit(lambda k: jmodel.init(
        {"params": k}, batch["audio"], batch["visual"], train=False))(
        jax.random.PRNGKey(0))["params"]
    state = jax_dgl.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats={}, opt_state=jopt.init(params))
    jstep = jax.jit(jax_dgl.make_dgl_train_step(jmodel, jcfg, jopt,
                                                clip_norm=40.0))

    model = AVClassifierSwinDGL(cfg, drop_path_rate=0.0)
    model.load_state_dict(state_dict_from_flax(params, {}), strict=True)
    opt = make_optimizer(cfg, model.parameters(), 2, clip_norm=40.0)
    step = make_dgl_train_step(model, cfg, opt, clip_norm=40.0)

    state, jm = jstep(state, {n: jnp.asarray(v) for n, v in batch.items()})
    m = step({n: torch.from_numpy(v) for n, v in batch.items()})
    for name in METRICS:
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    want = state_dict_from_flax(jax.device_get(state.params), {})
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_config_flags_reach_the_modules():
    """build_model(cfg) hands the four kernel flags to every block of
    both encoders, as gdl_tpu/models/classifier.py does; an explicit
    attn_impl="plain" wins over the flags."""
    tiny = dict(backbone="swin", swin_embed_dim=16, swin_depths=[1, 1],
                swin_heads=[2, 4], swin_window=4, swin_img_size=32,
                swin_patch=4, device="cpu")

    def modes(cfg, **kw):
        model = build_model(cfg, seed=0, **kw)
        attn = [m for m in model.modules() if isinstance(m, WindowAttention)]
        mlps = [m for m in model.modules() if isinstance(m, Mlp)]
        assert len(attn) == len(mlps) == 4
        got = {(a.attn_impl, a.fuse_qkv, a.attn_eval_impl) for a in attn}
        got_mlp = {(m.fuse_mlp, m.impl) for m in mlps}
        assert len(got) == 1 and len(got_mlp) == 1
        return got.pop() + got_mlp.pop()

    assert modes(Config(**tiny)) == ("auto", True, "auto", False, "auto")
    assert modes(Config(**tiny, fuse_qkv_gemm=False, fuse_mlp=True)) == (
        "auto", False, "auto", True, "auto")
    assert modes(Config(**tiny, use_pallas_attn_eval=False)) == (
        "auto", True, "plain", False, "auto")
    assert modes(Config(**tiny, use_pallas_attn=False)) == (
        "plain", True, "plain", False, "plain")
    assert modes(Config(**tiny, fuse_mlp=True), attn_impl="plain") == (
        "plain", True, "auto", True, "plain")


def test_cli_flags_parse_into_the_config():
    """The four flags arrive from a command line as gdl_tpu's do."""
    import argparse

    from gdl_tpu_torch import config as port_config

    ap = argparse.ArgumentParser()
    port_config.add_arguments(ap)
    args = ap.parse_args(["--ckpt_path", "ck", "--fuse_qkv_gemm", "0",
                          "--fuse_mlp", "1", "--use_pallas_attn", "0",
                          "--use_pallas_attn_eval", "0"])
    cfg = port_config.from_args(args)
    assert (cfg.fuse_qkv_gemm, cfg.fuse_mlp, cfg.use_pallas_attn,
            cfg.use_pallas_attn_eval) == (False, True, False, False)
    cfg = port_config.from_args(ap.parse_args(["--ckpt_path", "ck"]))
    assert (cfg.fuse_qkv_gemm, cfg.fuse_mlp, cfg.use_pallas_attn,
            cfg.use_pallas_attn_eval) == (True, False, True, True)


@pytest.mark.parametrize("flag", ["dp", "mp"])
def test_more_than_one_device_raises_by_name(flag):
    """--dp 2 and --mp 2 raise NotImplementedError naming the flag until
    the multi-GPU slice; --dp -1 (all devices) and 1 mean the one device."""
    with pytest.raises(NotImplementedError, match=f"--{flag} 2"):
        check_supported(Config(device="cpu", **{flag: 2}))
    check_supported(Config(device="cpu", **{flag: 1}))
    check_supported(Config(device="cpu", dp=-1))
