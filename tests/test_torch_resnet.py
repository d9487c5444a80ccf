"""The port's ResNet-18 encoders and AVClassifierDGL against gdl_tpu's,
from the same weights (gdl_tpu's init, bridged with
`state_dict_from_flax`, loaded strict=True) and the same numpy-seeded
inputs, in f32 on the CPU.

Tolerances: 2e-5 on maps, logits and running statistics at the tiny size
(f32 convolutions summed in another order; gdl_tpu's BN takes one-pass
E[x²]−E[x]² statistics, torch two-pass ones), 5e-4 at full width, the
bar of gdl_tpu's own full-width parity test against torch."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.models.classifier import AVClassifierDGL as JaxDGL
from gdl_tpu.models.resnet import resnet18 as jax_resnet18
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models.classifier import AVClassifierDGL
from gdl_tpu_torch.models.layers import batch_norm, conv, xavier_linear
from gdl_tpu_torch.models.resnet import resnet18
from gdl_tpu_torch.utils.interop import state_dict_from_flax

TINY = dict(dataset="CREMAD", fusion_method="concat", encoder_width=8,
            encoder_stages=[1, 1, 1, 1], fps=2)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The models here are tiny: more intra-op threads only spin, and
    under a parallel test run they starve the other workers. Restored
    after each test."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b=4, f=65, t=47, frames=2, size=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, f, t, 1)).astype(np.float32),
            rng.standard_normal((b, frames, size, size, 3)).astype(
                np.float32))


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_classifier(kw, audio, visual, seed=0):
    """gdl_tpu's classifier with its init, after ONE training-mode
    forward so the running statistics are not the trivial 0 and 1."""
    jmodel = JaxDGL(config=JaxConfig(**kw))
    variables = jax.jit(lambda k: jmodel.init(
        {"params": k}, audio, visual, train=False))(jax.random.PRNGKey(seed))
    out, mutated = jax.jit(lambda v: jmodel.apply(
        v, audio, visual, train=True, mutable=["batch_stats"]))(variables)
    return jmodel, variables, out, mutated["batch_stats"]


def _port_classifier(kw, variables):
    model = AVClassifierDGL(Config(**kw))
    model.load_state_dict(state_dict_from_flax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    return model


def _assert_stats(model, stats, atol):
    want = state_dict_from_flax({}, _np_tree(stats))
    got = model.state_dict()
    n = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=name)
        n += 1
    return n


@pytest.mark.parametrize("modality", ["full", "audio", "visual"])
def test_classifier_train_and_eval_match_jax(modality):
    """(out, out_a, out_v) in training mode, the BN running statistics
    after that one forward (torch's unbiased running variance), and the
    eval-mode logits from those statistics, atol 2e-5, for the dual
    classifier and the two single-modality ones."""
    kw = dict(TINY, modality=modality)
    audio, visual = _inputs()
    jmodel, variables, jout, jstats = _jax_classifier(kw, audio, visual)
    model = _port_classifier(kw, variables).train()
    with torch.no_grad():
        out = model(torch.from_numpy(audio), torch.from_numpy(visual))
    for g, w in zip(out, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5)
    n = _assert_stats(model, jstats, atol=2e-5)
    # 12 BatchNorms per encoder, a mean and a variance each
    assert n == (48 if modality == "full" else 24)
    bn = [m for m in model.modules()
          if isinstance(m, torch.nn.BatchNorm2d)]
    assert all(int(m.num_batches_tracked) == 1 for m in bn)

    audio2, visual2 = _inputs(seed=1)
    jeval = jmodel.apply({"params": variables["params"],
                          "batch_stats": jstats}, audio2, visual2,
                         train=False)
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(audio2), torch.from_numpy(visual2))
    for g, w in zip(out, jeval):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5)
    if modality != "full":
        assert out[0] is out[1] is out[2]


@pytest.mark.parametrize("modality", ["audio", "visual"])
def test_encoder_maps_and_grads_match_jax(modality):
    """One encoder alone, odd spectrogram sizes: the layer-4 map
    (channel-last, [N, H/32, W/32, 8w]) in training mode within 1e-4
    (entries of a few units; the last BNs normalise over only tens of
    values, which amplifies the rounding before them), and
    the gradient of Σ map² with respect to the stem conv (it passes
    through the max-pool backward and every BN) within 1e-4 relative to
    its largest entry."""
    audio, visual = _inputs(f=129, t=94)
    x = audio if modality == "audio" else visual
    jnet = jax_resnet18(modality, width=8, stage_sizes=(1, 1, 1, 1))
    variables = jax.jit(lambda k: jnet.init({"params": k}, x, train=False))(
        jax.random.PRNGKey(2))

    def jloss(params):
        y, _ = jnet.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, x,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(jnp.square(y)), y

    (_, jmap), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])

    net = resnet18(modality, width=8, stage_sizes=(1, 1, 1, 1))
    net.load_state_dict(state_dict_from_flax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    net.train()
    y = net(torch.from_numpy(x))
    assert y.shape == jmap.shape and y.shape[-1] == 64
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jmap), rtol=0,
                               atol=1e-4)
    y.square().sum().backward()
    want = state_dict_from_flax(_np_tree(jgrads), {})
    for name in ("conv1.weight", "layer4.0.downsample.0.weight",
                 "bn1.weight"):
        w = want[name].numpy()
        np.testing.assert_allclose(
            net.get_parameter(name).grad.numpy(), w, rtol=0,
            atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_full_width_forward_matches_jax():
    """Width 64, stages [2,2,2,2], batch 2, the CREMA-D input sizes
    (spectrogram 257×188, one 224² frame): eval-mode logits within
    5e-4."""
    kw = dict(dataset="CREMAD", fusion_method="concat", fps=1)
    audio, visual = _inputs(b=2, f=257, t=188, frames=1, size=224, seed=3)
    t0 = time.time()
    jmodel = JaxDGL(config=JaxConfig(**kw))
    variables = jax.jit(lambda k: jmodel.init(
        {"params": k}, audio, visual, train=False))(jax.random.PRNGKey(4))
    jout = jax.jit(lambda v: jmodel.apply(v, audio, visual, train=False))(
        variables)
    model = _port_classifier(kw, variables).eval()
    assert sum(p.numel() for p in model.parameters()) > 22e6
    with torch.no_grad():
        out = model(torch.from_numpy(audio), torch.from_numpy(visual))
    for g, w in zip(out, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=5e-4)
    assert time.time() - t0 < 120


def test_init_distributions_and_unported_options():
    """kaiming-normal fan_out convs (std = sqrt(2 / fan_out)),
    xavier-normal linears with zero bias, BN at torch defaults; per-
    replica BN and an unknown modality raise."""
    g = torch.Generator().manual_seed(0)
    c = conv(16, 64, 3, 1, g)
    assert c.bias is None and c.padding == (1, 1)
    assert float(c.weight.std()) == pytest.approx((2 / (64 * 9)) ** 0.5,
                                                  rel=0.05)
    lin = xavier_linear(300, 100, g)
    assert float(lin.weight.std()) == pytest.approx((2 / 400) ** 0.5,
                                                    rel=0.05)
    assert float(lin.bias.abs().max()) == 0.0
    bn = batch_norm(8)
    assert bn.eps == 1e-5 and bn.momentum == 0.1
    with pytest.raises(ValueError, match="per-replica"):
        batch_norm(8, groups=2)  # without a process group of 2 ranks
    with pytest.raises(NotImplementedError, match="modality"):
        resnet18("text")
    # the same generator state gives the same weights
    a = AVClassifierDGL(Config(**TINY),
                        generator=torch.Generator().manual_seed(5))
    b = AVClassifierDGL(Config(**TINY),
                        generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
