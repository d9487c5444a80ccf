"""The port's Swin encoder and dual-Swin DGL classifier against gdl_tpu's,
at small sizes on the CPU. Weights are made by the JAX model's init and
bridged with `state_dict_from_flax` (strict load); inputs are
numpy-seeded."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gdl_tpu.config import Config
from gdl_tpu.models.classifier import AVClassifierSwinDGL as JaxSwinDGL
from gdl_tpu.models.swin import SwinTransformer as JaxSwin
from gdl_tpu_torch.models.classifier import AVClassifierSwinDGL
from gdl_tpu_torch.models.swin import SwinTransformer
from gdl_tpu_torch.utils.interop import state_dict_from_flax

TINY_SWIN = dict(encoder_width=8, encoder_stages=[1, 1, 1, 1], batch_size=2,
                 fps=1, dataset="CREMAD", fusion_method="concat",
                 modality="full", log_grad_csv=False, backbone="swin",
                 swin_embed_dim=16, swin_depths=[1, 1], swin_heads=[2, 4],
                 swin_window=7, swin_img_size=56, swin_patch=4)


def test_swin_encoder_matches_jax_eval_kernel_branch(monkeypatch):
    """Embed 128, 4 heads (the Pallas eval kernel's smallest aligned
    config), img 56 → a 14x14 map of four 7x7 windows, depths (2,): the
    second block is shifted and masked. gdl_tpu runs its eval branch
    through window_attention_pallas_qkv_fused_eval (interpret mode, the
    backend gate patched as tests/test_swin.py does); the port runs the
    plain version. rtol 1e-4, atol 1e-5."""
    import gdl_tpu.models.swin as swin_mod

    monkeypatch.setattr(swin_mod, "is_tpu_backend", lambda: True)
    kw = dict(img_size=56, patch_size=4, embed_dim=128, depths=(2,),
              num_heads=(4,), window=7)
    jax_model = JaxSwin(modality="visual", drop_path_rate=0.0,
                        use_pallas_attn=True, fuse_qkv_gemm=True,
                        pallas_attn_eval=True, window_resident=True, **kw)
    x = np.random.default_rng(31).standard_normal(
        (1, 2, 56, 56, 3)).astype(np.float32)
    variables = jax_model.init({"params": jax.random.PRNGKey(13)},
                               jnp.asarray(x), train=False)
    want = jax_model.apply(variables, jnp.asarray(x), train=False)

    model = SwinTransformer("visual", **kw).eval()
    model.load_state_dict(state_dict_from_flax(variables["params"], {}),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 14, 14, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_tiny_swin_dgl_classifier_matches_jax():
    """Embed 16, depths [1,1], heads [2,4], window 7, img 56 (the tiny
    swin config of tests/test_serve.py): (out, out_a, out_v) of the port
    against model.apply(train=False), atol 2e-4."""
    cfg = Config(**TINY_SWIN)
    jax_model = JaxSwinDGL(config=cfg)
    rng = np.random.default_rng(37)
    audio = rng.standard_normal((2, 56, 56, 1)).astype(np.float32)
    visual = rng.standard_normal((2, 1, 56, 56, 3)).astype(np.float32)
    variables = jax_model.init({"params": jax.random.PRNGKey(3)},
                               jnp.asarray(audio), jnp.asarray(visual),
                               train=False)
    want = jax_model.apply(variables, jnp.asarray(audio),
                           jnp.asarray(visual), train=False)

    model = AVClassifierSwinDGL(cfg).eval()
    model.load_state_dict(state_dict_from_flax(variables["params"], {}),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(visual))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, cfg.n_classes)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4)


def test_seeded_init_is_deterministic_and_shaped_like_jax():
    """The port's own init is reproducible from a torch.Generator seed,
    and its state dict has exactly the bridged JAX model's keys and
    shapes."""
    cfg = Config(**TINY_SWIN)
    a = AVClassifierSwinDGL(cfg, generator=torch.Generator().manual_seed(5))
    b = AVClassifierSwinDGL(cfg, generator=torch.Generator().manual_seed(5))
    c = AVClassifierSwinDGL(cfg, generator=torch.Generator().manual_seed(6))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    key = "audio_net.layers.0.blocks.0.attn.qkv.weight"
    assert torch.equal(sa[key], sb[key]) and not torch.equal(sa[key], sc[key])
    assert all(torch.equal(sa[k], sb[k]) for k in sa)

    variables = JaxSwinDGL(config=cfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 56, 56, 1)),
        jnp.zeros((1, 1, 56, 56, 3)), train=False)
    bridged = state_dict_from_flax(variables["params"], {})
    assert sorted(bridged) == sorted(sa)
    for k, v in bridged.items():
        assert tuple(v.shape) == tuple(sa[k].shape), k
