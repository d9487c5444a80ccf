"""bfloat16: the port under torch autocast against gdl_tpu built with
dtype=jnp.bfloat16.

The port's bf16 path is `torch.autocast` over float32 parameters (the
window attention and MLP ops cast their own operands); gdl_tpu's models
cast parameters and activations to their `dtype`. The two round at
different places, so they can agree only to bf16 noise. The yardstick is
measured in each test: the distance between the port's own bf16 and f32
outputs on the same weights and inputs. The two packages' bf16 outputs
must lie within twice that distance of each other; measured at these
sizes they are closer than it: ResNet logits 0.0 against 9.3e-3, Swin
logits 2.0e-3 against 2.5e-3, mmformer_n fused logits 1.6e-2 against
2.1e-2. Each test also holds the f32 outputs of the two packages to each
other at 1e-5 of the output's scale (so the weights did arrive), and
the bf16 path to a real change of the output that stays under 5% of its
scale.

Tiny sizes, equal weights (gdl_tpu's init through `state_dict_from_flax`,
strict), numpy-seeded inputs, DropPath off on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.models import intermediate as jax_inter
from gdl_tpu.models.classifier import AVClassifierDGL as JaxDGL
from gdl_tpu.models.classifier import AVClassifierSwinDGL as JaxSwinDGL
from gdl_tpu.train import dgl as jax_dgl
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models import intermediate as port_inter
from gdl_tpu_torch.models.classifier import (
    AVClassifierDGL,
    AVClassifierSwinDGL,
)
from gdl_tpu_torch.train.dgl import dgl_loss_fn
from gdl_tpu_torch.utils.interop import state_dict_from_flax

RESNET_TINY = dict(dataset="CREMAD", fusion_method="concat", encoder_width=8,
                   encoder_stages=[1, 1, 1, 1], fps=2)
SWIN_TINY = dict(dataset="VGGSound", fusion_method="concat", alpha=3.0,
                 backbone="swin", swin_embed_dim=16, swin_depths=[1, 1],
                 swin_heads=[2, 4], swin_window=4, swin_img_size=32,
                 swin_patch=4)
MMF = dict(num_classes=6, embed_dim=128, width=8, seq_len=16)


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_eval(jmodel, variables, inputs):
    """Eval-mode outputs, jitted (eager flax is slow on the CPU)."""
    return jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        variables, *inputs)


def _port_outputs(model, inputs, bf16, **kw):
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                         enabled=bf16):
        out = model(*(torch.from_numpy(a) for a in inputs), **kw)
    return [o.float().numpy() for o in out]


def _hold(names, j32, j16, p32, p16):
    """Per output: f32 agreement of the packages, a real and bounded bf16
    effect, and the packages' bf16 outputs within twice that effect."""
    for name, a32, a16, b32, b16 in zip(names, j32, j16, p32, p16):
        a32, a16 = np.asarray(a32, np.float32), np.asarray(a16, np.float32)
        scale = float(np.abs(a32).max())
        assert np.abs(a32 - b32).max() <= 1e-5 * scale, name
        effect = float(np.abs(b16 - b32).max())
        assert 0.0 < effect <= 5e-2 * scale, (name, effect, scale)
        between = float(np.abs(a16 - b16).max())
        assert between <= 2.0 * effect, (name, between, effect)


def test_resnet_dgl_eval_logits_bf16():
    """Dual ResNet-18 of width 8, one block a stage, batch 4, with
    running statistics from one training forward."""
    rng = np.random.default_rng(0)
    inputs = (rng.standard_normal((4, 65, 47, 1)).astype(np.float32),
              rng.standard_normal((4, 2, 64, 64, 3)).astype(np.float32))
    j32 = JaxDGL(config=JaxConfig(**RESNET_TINY))
    j16 = JaxDGL(config=JaxConfig(**RESNET_TINY), dtype=jnp.bfloat16)
    variables = jax.jit(lambda k: j32.init(
        {"params": k}, *inputs, train=False))(jax.random.PRNGKey(0))
    _, mutated = jax.jit(lambda v: j32.apply(
        v, *inputs, train=True, mutable=["batch_stats"]))(variables)
    variables = {"params": variables["params"],
                 "batch_stats": mutated["batch_stats"]}
    model = AVClassifierDGL(Config(**RESNET_TINY)).eval()
    model.load_state_dict(state_dict_from_flax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    want16 = _jax_eval(j16, variables, inputs)
    assert all(w.dtype == jnp.bfloat16 for w in want16)
    _hold(("out", "out_a", "out_v"), _jax_eval(j32, variables, inputs),
          want16,
          _port_outputs(model, inputs, False),
          _port_outputs(model, inputs, True))


def _swin_pair():
    rng = np.random.default_rng(1)
    batch = {"audio": rng.standard_normal((8, 32, 32, 1)).astype(np.float32),
             "visual": rng.standard_normal((8, 2, 32, 32, 3)).astype(
                 np.float32),
             "label": rng.integers(0, 309, 8).astype(np.int32)}
    j32 = JaxSwinDGL(config=JaxConfig(**SWIN_TINY))
    j16 = JaxSwinDGL(config=JaxConfig(**SWIN_TINY), dtype=jnp.bfloat16)
    params = jax.jit(lambda k: j32.init(
        {"params": k}, batch["audio"], batch["visual"], train=False))(
        jax.random.PRNGKey(0))["params"]
    model = AVClassifierSwinDGL(Config(**SWIN_TINY), drop_path_rate=0.0)
    model.load_state_dict(state_dict_from_flax(params, {}), strict=True)
    return batch, j32, j16, params, model


def test_swin_dgl_eval_logits_bf16():
    """Dual Swin of two stages (embed 16, heads 2 and 4, window 4, 32x32
    inputs), batch 8: the eval path, whose window attention runs the
    plain version of kernel #1 in bf16."""
    batch, j32, j16, params, model = _swin_pair()
    inputs = (batch["audio"], batch["visual"])
    model.eval()
    _hold(("out", "out_a", "out_v"),
          _jax_eval(j32, {"params": params}, inputs),
          _jax_eval(j16, {"params": params}, inputs),
          _port_outputs(model, inputs, False),
          _port_outputs(model, inputs, True))


def test_swin_dgl_step_losses_bf16(monkeypatch):
    """The losses of one DGL training step of the same model (training
    path: the plain versions of kernels #2 and #4 in bf16): loss, loss_f,
    loss_a and loss_v of the two packages in bf16 within 2e-4 relative,
    twice the largest f32-vs-bf16 distance measured here (7.8e-5; the
    packages were 3e-5 apart); in f32 within 1e-6."""
    import gdl_tpu.models.swin as swin_mod

    monkeypatch.setattr(swin_mod.DropPath, "__call__",
                        lambda self, x, train: x)
    batch, j32, j16, params, model = _swin_pair()
    keys = ("loss_f", "loss_a", "loss_v")

    def jax_losses(jmodel):
        loss, (_, m) = jax.jit(lambda p, b: jax_dgl.dgl_loss_fn(
            jmodel, p, {}, b, JaxConfig(**SWIN_TINY), train=True,
            rng=jax.random.PRNGKey(0)))(
            params, {n: jnp.asarray(v) for n, v in batch.items()})
        return [float(loss)] + [float(m[k]) for k in keys]

    def port_losses(bf16):
        model.train()
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                             enabled=bf16):
            loss, m = dgl_loss_fn(model, {n: torch.from_numpy(v) for n, v in
                                          batch.items()}, Config(**SWIN_TINY))
        return [float(loss)] + [float(m[k]) for k in keys]

    np.testing.assert_allclose(port_losses(False), jax_losses(j32),
                               rtol=1e-6)
    p16 = port_losses(True)
    assert p16 != port_losses(False)  # autocast did change the arithmetic
    np.testing.assert_allclose(p16, jax_losses(j16), rtol=2e-4)


def test_mmformer_n_eval_outputs_bf16():
    """mmformer_n (the AUXI model) with shared streams at embed 128,
    width 8, 16 tokens, batch 3: the reference 7-tuple at eval (the
    fused self-attention's plain version in bf16)."""
    rng = np.random.default_rng(2)
    inputs = (rng.standard_normal((3, 64, 64, 3)).astype(np.float32),
              rng.standard_normal((3, 64, 64, 3)).astype(np.float32))
    j32 = jax_inter.MMFormerN(share_streams=True, **MMF)
    j16 = jax_inter.MMFormerN(share_streams=True, dtype=jnp.bfloat16, **MMF)
    k = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: j32.init(
        {"params": k, "drop": k, "dropout": k, "pe": k}, *inputs,
        train=False, av_inputs=False))(k)

    def run(jmodel):
        return jax.jit(lambda v, a, b: jmodel.apply(
            v, a, b, train=False, av_inputs=False))(variables, *inputs)

    model = port_inter.MMFormerN(share_streams=True, **MMF).eval()
    model.load_state_dict(state_dict_from_flax(
        _np_tree(variables["params"]),
        _np_tree(variables.get("batch_stats", {}))), strict=True)
    _hold(("x_f", "mu_rgb", "std_rgb", "mu_depth", "std_depth", "x_r",
           "x_i"), run(j32), run(j16),
          _port_outputs(model, inputs, False, av_inputs=False),
          _port_outputs(model, inputs, True, av_inputs=False))
