"""The port's intermediate-fusion family (`gdl_tpu_torch/models/
{se_resnet,intermediate}.py`, `PEHead`) against gdl_tpu's flax modules.

Both sides get gdl_tpu's init, bridged with `state_dict_from_flax`
(strict=True, so every module and parameter name is held), and the same
numpy-seeded inputs at a small size: width 8, embed 128 (8 heads of 16,
a head configuration the fused attention op supports), 16 tokens.
Tolerance: atol 2e-4 + rtol 1e-4 on f32 outputs (one-pass against
two-pass BatchNorm statistics, and sums taken in another order; the
relative part is for the PE heads' std = exp(logvar / 2), which reaches
10^3 with the perturbed statistics used here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.models import classifier as jax_classifier
from gdl_tpu.models import intermediate as jax_inter
from gdl_tpu.models import se_resnet as jax_se
from gdl_tpu_torch.models import classifier as port_classifier
from gdl_tpu_torch.models import intermediate as port_inter
from gdl_tpu_torch.models import se_resnet as port_se
from gdl_tpu_torch.utils.interop import state_dict_from_flax

ATOL = 2e-4
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _init(jmodel, *inputs, **kw):
    k = jax.random.PRNGKey(0)
    return jmodel.init({"params": k, "drop": k, "dropout": k, "pe": k},
                       *inputs, **kw)


def _load(model, variables):
    """Load gdl_tpu's variables into the port's module, strict."""
    model.load_state_dict(state_dict_from_flax(
        _np_tree(variables["params"]),
        _np_tree(variables.get("batch_stats", {}))), strict=True)
    return model


def _perturb(variables, seed=3):
    """Non-trivial running statistics, biases and positional embeddings
    (gdl_tpu initialises them to 0 / 1, which would hide a swapped or
    dropped tensor)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if "var" in name:
            return x + rng.uniform(0.0, 0.5, x.shape).astype(x.dtype)
        if ("mean" in name or "bias" in name
                or "position_embeddings" in name):
            return x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def test_leaky_relu_has_jax_gradient_at_zero():
    """jax.nn.leaky_relu's slope at exactly 0 is 1 (F.leaky_relu's is the
    negative slope); MMFormerN's zero-input streams sit there at init."""
    x = np.array([-2.0, -0.0, 0.0, 3.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jax.nn.leaky_relu(v, 0.01)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port_inter.leaky_relu(xt, 0.01)
    y.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jax.nn.leaky_relu(jnp.asarray(x), 0.01)))


def test_av_adapt_matches_jax_resize():
    """The spectrogram shrinks along one axis (257 → 224, antialiased by
    jax.image.resize) and stretches along the other (188 → 224): atol
    1e-4."""
    rng = np.random.default_rng(0)
    spec = rng.standard_normal((2, 257, 188, 1)).astype(np.float32)
    frames = rng.standard_normal((2, 1, 32, 32, 3)).astype(np.float32)
    want_rgb, want_depth = jax_inter.av_adapt(jnp.asarray(spec),
                                              jnp.asarray(frames))
    rgb, depth = port_inter.av_adapt(torch.from_numpy(spec),
                                     torch.from_numpy(frames))
    assert tuple(rgb.shape) == (2, 224, 224, 3)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(depth.numpy(), np.asarray(want_depth))


@pytest.mark.parametrize("use_se,use_avg", [(True, False), (False, True)],
                         ids=["se", "avg"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_se_stem_matches_jax(use_se, use_avg, train):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    jmodel = jax_se.SEStem(use_se=use_se, use_avg=use_avg, width=8)
    variables = _perturb(_init(jmodel, jnp.asarray(x), train=False))
    want, mutated = jmodel.apply(variables, jnp.asarray(x), train=train,
                                 mutable=["batch_stats"])
    model = _load(port_se.SEStem(use_se=use_se, use_avg=use_avg, width=8),
                  variables).train(train)
    got = model(torch.from_numpy(x))
    side = 4 if use_avg else 8
    assert tuple(got.shape) == (4, side, side, 16)
    _close(got, want)
    if train:  # the running statistics moved as gdl_tpu's
        want_sd = state_dict_from_flax(_np_tree(variables["params"]),
                                       _np_tree(mutated["batch_stats"]))
        for name in ("bn1.running_mean", "layer2.0.bn2.running_var"):
            _close(model.state_dict()[name], want_sd[name].numpy(), name)


def test_se_trunk_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 8, 8, 32)).astype(np.float32)
    jmodel = jax_se.SETrunk(num_classes=6, width=8)
    variables = _perturb(_init(jmodel, jnp.asarray(x), train=False))
    want = jmodel.apply(variables, jnp.asarray(x), train=False,
                        return_maps=True)
    model = _load(port_se.SETrunk(6, 8, in_channels=32), variables).eval()
    got = model(torch.from_numpy(x), return_maps=True)
    for g, w, name in zip(got, want, ("logits", "layer3", "layer4")):
        _close(g, w, name)
    _close(model(torch.from_numpy(x)), want[0])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pe_head_matches_jax(train, monkeypatch):
    """mu, std and the sampled map; in training mode both sides are fed
    the same standard-normal draw."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 5, 5, 16)).astype(np.float32)
    noise = rng.standard_normal((4, 5, 5, 16)).astype(np.float32)
    jmodel = jax_classifier.PEHead(16)
    variables = _perturb(_init(jmodel, jnp.asarray(x), train=False))
    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal",
                  lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
        want, _ = jmodel.apply(variables, jnp.asarray(x), train=train,
                               rngs={"pe": jax.random.PRNGKey(1)},
                               mutable=["batch_stats"])
    monkeypatch.setattr(port_classifier, "pe_noise",
                        lambda shape, gen, dev: torch.from_numpy(noise))
    model = _load(port_classifier.PEHead(16), variables).train(train)
    got = model(torch.from_numpy(x))
    for g, w, name in zip(got, want, ("out", "mu", "std")):
        _close(g, w, name)
    if not train:
        assert torch.equal(got[0], got[1])


def test_pe_head_noise_comes_from_the_generator():
    model = port_classifier.PEHead(8).train()
    x = torch.randn(2, 3, 3, 8)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    outs = []
    for seed in (5, 5, 6):
        model.load_state_dict(state)
        outs.append(model(x, torch.Generator().manual_seed(seed))[0])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


MMF = dict(num_classes=6, embed_dim=128, width=8, seq_len=16)


def _mmformer_n_inputs(seed=5, batch=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 64, 64, 3)).astype(np.float32),
            rng.standard_normal((batch, 64, 64, 3)).astype(np.float32))


@pytest.mark.parametrize("share,batched", [(False, False), (True, False),
                                           (True, True), (False, True)],
                         ids=["strict", "share", "share_batched", "batched"])
def test_mmformer_n_eval_matches_jax(share, batched):
    """The reference 7-tuple at eval, share_streams on and off,
    batched_inter on and off: the port's SelfAttention takes the fused
    op's plain version here, gdl_tpu its XLA path."""
    rgb, ir = _mmformer_n_inputs()
    jmodel = jax_inter.MMFormerN(share_streams=share, batched_inter=batched,
                                 **MMF)
    variables = _perturb(_init(jmodel, jnp.asarray(rgb), jnp.asarray(ir),
                               train=False, av_inputs=False))
    want = jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False, av_inputs=False))(
            variables, jnp.asarray(rgb), jnp.asarray(ir))
    model = _load(port_inter.MMFormerN(share_streams=share,
                                       batched_inter=batched, **MMF),
                  variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(rgb), torch.from_numpy(ir),
                    av_inputs=False)
    assert len(got) == 7
    for g, w, name in zip(got, want, ("x_f", "mu_rgb", "std_rgb", "mu_depth",
                                      "std_depth", "x_r", "x_i")):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, name)


def test_mmformer_n_eval_is_the_same_in_every_mode():
    """share_streams and batched_inter do not change eval outputs."""
    rgb, ir = (torch.from_numpy(a) for a in _mmformer_n_inputs(7))
    base = port_inter.MMFormerN(generator=torch.Generator().manual_seed(1),
                                **MMF).eval()
    with torch.no_grad():
        want = base(rgb, ir, av_inputs=False)
        for share, batched in ((True, False), (True, True)):
            other = port_inter.MMFormerN(share_streams=share,
                                         batched_inter=batched, **MMF).eval()
            other.load_state_dict(base.state_dict())
            for g, w in zip(other(rgb, ir, av_inputs=False), want):
                torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_mmformer_n_av_adapter_path():
    """av_inputs=True: a [B, F, T, 1] spectrogram and [B, 1, 224, 224, 3]
    frames give 14 x 14 = 196 tokens per modality."""
    rng = np.random.default_rng(8)
    spec = torch.from_numpy(rng.standard_normal((1, 33, 20, 1)).astype(
        np.float32))
    frames = torch.from_numpy(rng.standard_normal((1, 1, 224, 224, 3)).astype(
        np.float32))
    model = port_inter.MMFormerN(6, embed_dim=128, width=8, seq_len=196,
                                 share_streams=True,
                                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model.eval()(spec, frames)
    assert tuple(out[0].shape) == (1, 6) and tuple(out[1].shape) == (
        1, 14, 14, 16)
    assert all(bool(torch.isfinite(o).all()) for o in out)


def test_mmtm_net_eval_matches_jax():
    rng = np.random.default_rng(9)
    rgb = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    depth = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    jmodel = jax_inter.MMTMNet(num_classes=6, width=8)
    variables = _perturb(_init(jmodel, jnp.asarray(rgb), jnp.asarray(depth),
                               train=False, av_inputs=False))
    want = jmodel.apply(variables, jnp.asarray(rgb), jnp.asarray(depth),
                        train=False, av_inputs=False)
    model = _load(port_inter.MMTMNet(6, 8), variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(rgb), torch.from_numpy(depth),
                    av_inputs=False)
    for g, w, name in zip(got, want, ("out", "out_rgb", "out_depth")):
        _close(g, w, name)


def test_sefusion_net_eval_matches_jax():
    rng = np.random.default_rng(10)
    rgb = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    depth = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    jmodel = jax_inter.SEFusionNet(num_classes=6, width=8)
    variables = _perturb(_init(jmodel, jnp.asarray(rgb), jnp.asarray(depth),
                               train=False))
    want = jmodel.apply(variables, jnp.asarray(rgb), jnp.asarray(depth),
                        train=False)
    model = _load(port_inter.SEFusionNet(6, 8), variables).eval()
    with torch.no_grad():
        _close(model(torch.from_numpy(rgb), torch.from_numpy(depth)), want)


def test_mmformer_eval_matches_jax():
    """The 3-modality SURF_Fomer: (logits, layer3, layer4) at eval."""
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
          for _ in range(3)]
    jmodel = jax_inter.MMFormer(**MMF)
    variables = _perturb(_init(jmodel, *map(jnp.asarray, xs), train=False))
    want = jax.jit(lambda v, a, b, c: jmodel.apply(v, a, b, c, train=False))(
        variables, *map(jnp.asarray, xs))
    model = _load(port_inter.MMFormer(**MMF), variables).eval()
    with torch.no_grad():
        got = model(*map(torch.from_numpy, xs))
    for g, w, name in zip(got, want, ("logits", "layer3", "layer4")):
        _close(g, w, name)


@pytest.mark.parametrize("mode", ["average", "unbalance"])
def test_mmformer_train_draws_its_modality_mask_from_the_generator(mode):
    xs = [torch.randn(7, 64, 64, 3) for _ in range(3)]
    model = port_inter.MMFormer(drop_mode=mode,
                                generator=torch.Generator().manual_seed(2),
                                **MMF).train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    outs = []
    for seed in (3, 3, 4):
        model.load_state_dict(state)
        with torch.no_grad():
            outs.append(model(*xs, torch.Generator().manual_seed(seed),
                              epoch=3)[0])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("name,kind", [("mmtm", "triple"),
                                       ("sefusion", "single"),
                                       ("mmformer_n", "seven")])
def test_build_intermediate_kinds_and_triple_logits(name, kind):
    model, got = port_inter.build_intermediate(
        name, 6, width=8, generator=torch.Generator().manual_seed(0),
        **({"embed_dim": 128} if name == "mmformer_n" else {}))
    assert got == kind
    jmodel, jkind = jax_inter.build_intermediate(name, 6, width=8)
    assert jkind == kind
    rng = np.random.default_rng(12)
    spec = torch.from_numpy(rng.standard_normal((2, 33, 20, 1)).astype(
        np.float32))
    frames = torch.from_numpy(rng.standard_normal((2, 1, 224, 224, 3)).astype(
        np.float32))
    with torch.no_grad():
        out = port_inter.TripleLogits(model, kind).eval()(spec, frames)
    assert len(out) == 3 and all(tuple(o.shape) == (2, 6) for o in out)
    with pytest.raises(NotImplementedError, match="unknown intermediate"):
        port_inter.build_intermediate("nope", 6)
