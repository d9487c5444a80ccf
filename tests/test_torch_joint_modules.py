"""The joint / OGM-GE lineage's modules in the port against gdl_tpu's:
the baseline fusion heads and ConcatFusionDGLUnimodal, AVClassifier's
and AVClassifierSwin's 11-tuples (with and without the PE heads, with
the modality drop on fed combinations), feature_diversity, feature_diff,
regurize, ogm_coefficients and apply_ogm.

Both sides start from gdl_tpu's init, bridged with
`state_dict_from_flax` (strict), and take the same numpy-seeded inputs
at a small size (ResNet width 8, stages [1,1,1,1]; Swin embed 16, two
blocks, 32² inputs). The random draws are fed alike: the PE noise and
the modality-drop combinations go to gdl_tpu by patching
`jax.random.normal` / `jax.random.randint` while the apply is traced,
and to the port by patching `models.classifier.pe_noise` /
`modality_combo`; the OGM-GE noise is tied to the parameters through the
bridge's path-to-name mapping, never by shape. gdl_tpu's DropPath is
the identity and the port's rate 0.

Tolerances, measured then fixed: outputs and running statistics atol
2e-5 (f32 forward through BatchNorm in one pass against torch's two),
with rtol 2e-5 beside it on the training forward (the PE heads' std is
exp(logvar / 2), up to 2.3 here); scalars rtol 1e-5; modulated
gradients atol 1e-5 (jnp.std and torch.std of 18,432 elements differ by
1.6e-6 relative, times noise draws up to 4)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.models import classifier as jax_classifier
from gdl_tpu.models import fusion as jax_fusion
from gdl_tpu.models import swin as jax_swin
from gdl_tpu.train import joint as jax_joint
from gdl_tpu.train import optim as jax_optim
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models import classifier as port_classifier
from gdl_tpu_torch.models import fusion as port_fusion
from gdl_tpu_torch.train import auxi as port_auxi
from gdl_tpu_torch.train import joint as port_joint
from gdl_tpu_torch.train import optim as port_optim
from gdl_tpu_torch.utils.interop import state_dict_from_flax

TINY = dict(dataset="CREMAD", encoder_width=8, encoder_stages=[1, 1, 1, 1],
            fps=2, fusion_method="concat", alpha=0.5)
SWIN_TINY = dict(dataset="CREMAD", fusion_method="concat", swin_embed_dim=16,
                 swin_depths=[1, 1], swin_heads=[2, 4], swin_window=4,
                 swin_img_size=32, swin_patch=4, backbone="swin", fps=2,
                 alpha=0.5)
B = 4


@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _batch(swin=False, seed=0):
    rng = np.random.default_rng(seed)
    audio = (B, 32, 32, 1) if swin else (B, 65, 47, 1)
    visual = (B, 2, 32, 32, 3) if swin else (B, 2, 64, 64, 3)
    return {"audio": rng.standard_normal(audio).astype(np.float32),
            "visual": rng.standard_normal(visual).astype(np.float32),
            "label": rng.integers(0, 6, B).astype(np.int32)}


def _close(got, want, atol, msg="", rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# --- fusion heads ----------------------------------------------------------

HEADS = {
    "sum": (jax_fusion.SumFusion, port_fusion.SumFusion, 16),
    "concat": (jax_fusion.ConcatFusion, port_fusion.ConcatFusion, 32),
    "concat_swin": (jax_fusion.ConcatFusionSwin,
                    port_fusion.ConcatFusionSwin, 32),
    "film": (jax_fusion.FiLM, port_fusion.FiLM, 16),
    "gated": (jax_fusion.GatedFusion, port_fusion.GatedFusion, 16),
    "gated_y": (jax_fusion.GatedFusion, port_fusion.GatedFusion, 16),
    "concat_dgl_unimodal": (jax_fusion.ConcatFusionDGLUnimodal,
                            port_fusion.ConcatFusionDGLUnimodal, 32),
}


@pytest.mark.parametrize("name", list(HEADS))
def test_fusion_head_matches_jax(name):
    """Each head's 3-tuple (and the DGL head's unimodal / fused streams)
    from gdl_tpu's weights, atol 2e-5; the parameter names and shapes are
    gdl_tpu's."""
    jcls, pcls, in_dim = HEADS[name]
    feat = in_dim // 2 if in_dim == 32 else in_dim
    kw = dict(input_dim=in_dim, output_dim=6)
    if name == "gated_y":
        kw["x_gate"] = False
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, feat)).astype(np.float32)
    y = rng.standard_normal((B, feat)).astype(np.float32)
    jhead = jcls(**kw)
    params = jhead.init(jax.random.PRNGKey(0), x, y)["params"]
    head = pcls(**kw)
    head.load_state_dict(state_dict_from_flax(_np_tree(params), {}),
                         strict=True)
    want = jhead.apply({"params": params}, x, y)
    got = head(torch.from_numpy(x), torch.from_numpy(y))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.detach(), w, 2e-5, f"{name} output {i}")
    if name == "concat_dgl_unimodal":
        want = jhead.apply({"params": params}, x, y,
                           method="unimodal")
        got = head.unimodal(torch.from_numpy(x), torch.from_numpy(y))
        for g, w in zip(got, want):
            _close(g.detach(), w, 2e-5, "unimodal")
        _close(head.fuse(torch.from_numpy(x), torch.from_numpy(y)).detach(),
               jhead.apply({"params": params}, x, y, method="fuse"),
               2e-5, "fuse")


@pytest.mark.parametrize("method", ["sum", "concat", "film", "gated"])
@pytest.mark.parametrize("dgl,shared", [(False, True), (True, True),
                                        (True, False)],
                         ids=["joint", "dgl", "dgl_separate_auxi"])
def test_make_fusion_picks_gdl_tpu_heads(method, dgl, shared):
    """make_fusion returns the head of gdl_tpu's name with gdl_tpu's
    parameter names and shapes (dgl=False no longer raises)."""
    jhead = jax_fusion.make_fusion(method, 6, dgl=dgl, input_dim=8,
                                   shared_auxi=shared)
    head = port_fusion.make_fusion(method, 6, dgl=dgl, input_dim=8,
                                   shared_auxi=shared)
    assert type(head).__name__ == type(jhead).__name__
    x = np.zeros((2, 8), np.float32)
    params = jhead.init(jax.random.PRNGKey(0), x, x)["params"]
    want = {k: tuple(v.shape) for k, v in
            state_dict_from_flax(_np_tree(params), {}).items()}
    assert {k: tuple(v.shape) for k, v in head.state_dict().items()} == want


# --- classifiers -----------------------------------------------------------


def _feed_draws(monkeypatch, pe_shapes, combos):
    """Patch both packages' draws: PE noise (audio, then visual) and the
    modality-drop combinations. Returns the noise arrays."""
    rng = np.random.default_rng(7)
    noise = [rng.standard_normal(s).astype(np.float32) for s in pe_shapes]
    jax_draws, port_draws = itertools.cycle(noise), itertools.cycle(noise)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(
                            next(jax_draws), dtype))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(combos))
    monkeypatch.setattr(port_classifier, "pe_noise",
                        lambda shape, gen, dev: torch.from_numpy(
                            next(port_draws)))
    monkeypatch.setattr(port_classifier, "modality_combo",
                        lambda b, gen, dev: torch.from_numpy(combos).long())
    monkeypatch.setattr(jax_swin.DropPath, "__call__",
                        lambda self, x, train: x)
    return noise


_INITS = {}


def _models(kw, swin):
    """(gdl_tpu model, its params and stats, the port's model on them);
    the init of one architecture is made once per module."""
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    if swin:
        jmodel = jax_classifier.AVClassifierSwin(config=jcfg)
        model = port_classifier.AVClassifierSwin(cfg, drop_path_rate=0.0)
    else:
        jmodel = jax_classifier.AVClassifier(config=jcfg)
        model = port_classifier.AVClassifier(cfg)
    key = (swin, kw.get("pe", 0), kw["fusion_method"])
    if key not in _INITS:
        b = _batch(swin)
        variables = jax.jit(lambda k: jmodel.init(
            {"params": k}, b["audio"], b["visual"], train=False))(
            jax.random.PRNGKey(0))
        _INITS[key] = (_np_tree(variables["params"]),
                       _np_tree(variables.get("batch_stats", {})))
    params, stats = _INITS[key]
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return jmodel, params, stats, model


@pytest.mark.parametrize("swin", [False, True], ids=["resnet", "swin"])
@pytest.mark.parametrize("pe,drop", [(0, 0), (1, 1)],
                         ids=["plain", "pe_drop"])
def test_joint_classifier_matches_jax(swin, pe, drop, monkeypatch):
    """The 11-tuple in training mode (BatchNorm on the batch, fed PE noise
    and modality-drop combinations) and in eval mode, and the running
    statistics after the training forward; mu / std are the int 0
    without pe, and out_a / out_v the head on the other modality zeroed."""
    kw = dict(SWIN_TINY if swin else TINY, pe=pe, drop=drop)
    jmodel, params, stats, model = _models(kw, swin)
    if swin:
        pe_shapes = [(B, 4, 4, 32), (2 * B, 4, 4, 32)]
    else:
        pe_shapes = [(B, 3, 2, 64), (2 * B, 2, 2, 64)]
    combos = np.array([0, 1, 2, 1], np.int32)
    _feed_draws(monkeypatch, pe_shapes, combos)
    b = _batch(swin, seed=3)
    k = jax.random.PRNGKey(1)
    want, mutated = jax.jit(lambda p, s, a, v: jmodel.apply(
        {"params": p, "batch_stats": s}, a, v, train=True,
        rngs={"pe": k, "drop": k, "droppath": k, "dropout": k},
        mutable=["batch_stats"]))(params, stats, b["audio"], b["visual"])
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(b["audio"]),
                    torch.from_numpy(b["visual"]))
    assert len(got) == 11
    for i, (g, w) in enumerate(zip(got, want)):
        if not pe and i in (5, 6, 7, 8):
            assert isinstance(g, int) and g == 0 == w
            continue
        assert tuple(g.shape) == tuple(w.shape), i
        _close(g, w, 2e-5, f"train output {i}", rtol=2e-5)
    if drop:  # combination 0 keeps audio only, 1 visual only
        assert float(got[1][0].abs().max()) == 0.0
        assert float(got[0][1].abs().max()) == 0.0
        assert float(got[0][0].abs().max()) > 0.0
    if not swin or pe:
        sd = state_dict_from_flax(params, _np_tree(mutated["batch_stats"]))
        for name, w in sd.items():
            if "running" in name:
                _close(model.state_dict()[name], w, 2e-5, name)

    model.eval()  # on the statistics the training forward left
    want = jax.jit(lambda p, s, a, v: jmodel.apply(
        {"params": p, "batch_stats": s}, a, v, train=False))(
        params, mutated.get("batch_stats", stats), b["audio"], b["visual"])
    with torch.no_grad():
        got = model(torch.from_numpy(b["audio"]),
                    torch.from_numpy(b["visual"]))
    for i in (0, 1, 2, 9, 10):
        _close(got[i], want[i], 2e-5, f"eval output {i}")
    preds = port_joint.make_joint_eval_step(model)(
        {n: torch.from_numpy(v) for n, v in b.items()})
    for key in ("pred", "pred_a", "pred_v"):
        np.testing.assert_array_equal(preds[key].numpy(),
                                      np.argmax(np.asarray(want[2]), -1))


# --- diagnostics and the regularizer ---------------------------------------


@pytest.mark.parametrize("shape", [(3, 4, 5, 6), (2, 7, 7, 16),
                                   (2, 3, 2, 8)])
def test_feature_diversity_matches_jax(shape):
    feat = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = jax_joint.feature_diversity(jnp.asarray(feat))
    got = port_joint.feature_diversity(torch.from_numpy(feat))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("shape1,shape2", [
    ((2, 7, 7, 8), (2, 7, 7, 8)),
    ((2, 12, 10, 8), (2, 7, 7, 8)),     # shrinks: antialiased
    ((2, 3, 2, 8), (2, 17, 9, 8)),      # the audio map of a narrow ResNet
], ids=["7x7", "shrink", "grow_and_shrink"])
def test_feature_diff_matches_jax(shape1, shape2):
    rng = np.random.default_rng(4)
    x1 = rng.standard_normal(shape1).astype(np.float32)
    x2 = rng.standard_normal(shape2).astype(np.float32)
    want = jax_joint.feature_diff(jnp.asarray(x1), jnp.asarray(x2))
    got = port_joint.feature_diff(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_regurize_is_the_port_auxi_one_and_matches_jax():
    rng = np.random.default_rng(5)
    mu = rng.standard_normal((3, 2, 2, 8)).astype(np.float32)
    std = np.exp(0.3 * rng.standard_normal((3, 2, 2, 8))).astype(np.float32)
    assert port_joint.regurize is port_auxi.regurize
    want = jax_joint.regurize(jnp.asarray(mu), jnp.asarray(std))
    got = port_joint.regurize(torch.from_numpy(mu), torch.from_numpy(std))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# --- OGM / OGM-GE ----------------------------------------------------------


@pytest.mark.parametrize("v_big", [True, False], ids=["v_big", "a_big"])
def test_ogm_coefficients_match_jax(v_big):
    """Both branches of the score ratio, from logits made so that one
    modality's labels score higher, in f32 from bf16 logits too."""
    rng = np.random.default_rng(6)
    labels = rng.integers(0, 6, 8).astype(np.int32)
    strong = rng.standard_normal((8, 6)).astype(np.float32)
    strong[np.arange(8), labels] += 3.0
    weak = rng.standard_normal((8, 6)).astype(np.float32)
    out_a, out_v = (weak, strong) if v_big else (strong, weak)
    want = jax_optim.ogm_coefficients(jnp.asarray(out_a), jnp.asarray(out_v),
                                      jnp.asarray(labels), 0.3)
    got = port_optim.ogm_coefficients(torch.from_numpy(out_a),
                                      torch.from_numpy(out_v),
                                      torch.from_numpy(labels), 0.3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    assert (float(got[0]) == 1.0) == v_big
    assert (float(got[1]) == 1.0) != v_big
    bf = port_optim.ogm_coefficients(
        torch.from_numpy(out_a).bfloat16(), torch.from_numpy(out_v).bfloat16(),
        torch.from_numpy(labels), 0.3)
    assert all(c.dtype == torch.float32 for c in bf)


def ogm_noise_tree(params, seed=11):
    """Standard-normal noise (flax's HWIO layout) for every leaf that
    gdl_tpu's apply_ogm modulates (4-D, under a top-level name holding
    "audio" or "visual"), in a tree of `params`' paths."""
    rng = np.random.default_rng(seed)

    def walk(tree, top):
        out = {}
        for k in sorted(tree):
            v, t = tree[k], top or k
            if hasattr(v, "items"):
                sub = walk(v, t)
                if sub:
                    out[k] = sub
            elif ("audio" in t or "visual" in t) and np.ndim(v) == 4:
                out[k] = rng.standard_normal(np.shape(v)).astype(np.float32)
        return out

    return walk(params, None)


def jax_apply_ogm_fed(noise_tree):
    """gdl_tpu's apply_ogm with its per-leaf jax.random.normal draws taken
    from `noise_tree`, leaf by leaf in the order it flattens the
    gradients."""
    real = jax_optim.apply_ogm

    def fed(grads, coeff_a, coeff_v, rng, mode, active):
        flat = jax.tree_util.tree_flatten_with_path(grads)[0]
        leaves = {jax.tree_util.keystr(p): x for p, x in
                  jax.tree_util.tree_flatten_with_path(noise_tree)[0]}
        draws = iter([leaves[jax.tree_util.keystr(p)] for p, _ in flat
                      if jax.tree_util.keystr(p) in leaves])
        normal = jax.random.normal
        jax.random.normal = lambda key, shape, dtype=jnp.float32: (
            jnp.asarray(next(draws), dtype))
        try:
            return real(grads, coeff_a, coeff_v, rng, mode, active)
        finally:
            jax.random.normal = normal

    return fed


@pytest.mark.parametrize("mode", ["OGM", "OGM_GE"])
def test_apply_ogm_matches_jax(mode):
    """On a gradient tree of the PE-headed AVClassifier: the encoders' and
    PE heads' conv kernels scaled by their modality's coefficient (plus
    the fed noise times the population std under OGM_GE), every other
    gradient untouched; outside the epoch window gdl_tpu leaves all
    gradients alone and `ogm_active` is false."""
    kw = dict(TINY, pe=1, modulation=mode, modulation_starts=1,
              modulation_ends=2)
    _, params, _, model = _models(kw, swin=False)
    rng = np.random.default_rng(8)
    grads = jax.tree.map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32),
        params)
    noise = ogm_noise_tree(params)
    port_noise = state_dict_from_flax(noise, {})
    named = dict(model.named_parameters())
    targets = port_optim.ogm_targets(model.named_parameters())
    assert {n for n, _, _ in targets} == set(port_noise)
    assert any("audio_pe" in n for n in port_noise)
    cfg = Config(**kw)
    coeff_a, coeff_v = np.float32(0.25), np.float32(0.75)
    for step, active in ((2, False), (3, True), (8, True), (9, False)):
        assert port_optim.ogm_active(cfg, step, 3) == active
        want = jax_apply_ogm_fed(noise)(
            jax.tree.map(jnp.asarray, grads), coeff_a, coeff_v,
            jax.random.PRNGKey(0), mode, jnp.asarray(active))
        for name, g in state_dict_from_flax(grads, {}).items():
            named[name].grad = g.clone()
        if port_optim.ogm_active(cfg, step, 3):
            port_optim.apply_ogm(targets, torch.tensor(coeff_a),
                                 torch.tensor(coeff_v), mode,
                                 noise=lambda n, s: port_noise[n])
        for name, w in state_dict_from_flax(_np_tree(want), {}).items():
            _close(named[name].grad, w, 1e-5, f"{step} {name}")
    assert not port_optim.ogm_active(
        Config(**dict(kw, strict_compat=True)), 3, 3)
    assert not port_optim.ogm_active(
        Config(**dict(kw, modulation="Normal")), 3, 3)
