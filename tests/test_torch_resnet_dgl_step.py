"""The port's DGL train step on the dual ResNet-18 (BatchNorm, the stem
max-pool's hand-written backward) against gdl_tpu's jitted step.

Both packages start from the same weights and running statistics
(gdl_tpu's init, bridged with `state_dict_from_flax`) and take the same
numpy-seeded batches at a tiny size (width 8, stages [1,1,1,1], batch 8).

Tolerances, measured then fixed: metrics rtol 2e-4 (through 24 BatchNorms
whose statistics gdl_tpu takes in one pass and torch in two, a tiny
batch, and gradient norms that sum every parameter); parameters and
running statistics 2e-5 after one step and 5e-4 after four. The Swin
step's tighter tolerances (tests/test_torch_dgl_step.py) are untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.models.classifier import AVClassifierDGL as JaxDGL
from gdl_tpu.train import dgl as jax_dgl
from gdl_tpu.train import optim as jax_optim
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models.classifier import AVClassifierDGL
from gdl_tpu_torch.train.dgl import make_dgl_train_step, make_eval_step
from gdl_tpu_torch.train.optim import make_optimizer
from gdl_tpu_torch.utils.interop import state_dict_from_flax

METRICS = ("loss", "loss_f", "loss_a", "loss_v", "grad_norm",
           "audio_grad_sum", "visual_grad_sum", "abs_out_a", "abs_out_v")
BASE = dict(dataset="CREMAD", alpha=3.0, log_grad_csv=True,
            learning_rate=0.05, lr_decay_step=[2], encoder_width=8,
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


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"audio": rng.standard_normal((8, 65, 47, 1)).astype(np.float32),
             "visual": rng.standard_normal((8, 2, 64, 64, 3)).astype(
                 np.float32),
             "label": rng.integers(0, 6, 8).astype(np.int32)}
            for _ in range(n)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _setup(kw, clip):
    """(jax step, jax state, port model, port optimizer, port step)."""
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    jmodel = JaxDGL(config=jcfg)
    jopt = jax_optim.make_optimizer(
        jcfg, 2, clip_norm=clip,
        wd_mask=jax_optim.dead_fusion_param_mask(jcfg, dgl=True))
    b = _batches(1)[0]
    variables = jax.jit(lambda k: jmodel.init(
        {"params": k}, b["audio"], b["visual"], train=False))(
        jax.random.PRNGKey(0))
    state = jax_dgl.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=jopt.init(variables["params"]))
    jstep = jax.jit(jax_dgl.make_dgl_train_step(jmodel, jcfg, jopt,
                                                clip_norm=clip))
    model = AVClassifierDGL(cfg)
    model.load_state_dict(state_dict_from_flax(
        _np_tree(state.params), _np_tree(state.batch_stats)), strict=True)
    opt = make_optimizer(cfg, model.parameters(), 2, clip_norm=clip)
    step = make_dgl_train_step(model, cfg, opt, clip_norm=clip)
    return jmodel, jstep, state, model, opt, step


def _assert_state(model, state, atol, msg):
    want = state_dict_from_flax(_np_tree(state.params),
                                _np_tree(state.batch_stats))
    got = model.state_dict()
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=f"{msg} {name}")


@pytest.mark.parametrize("clip", [40.0, 0.05], ids=["clip40", "clip_acts"])
def test_resnet_dgl_step_matches_jax_step(clip):
    """Four steps (2 per epoch, LR decay at epoch 2), clip 40 and a clip
    that scales every step: every metric per step, parameters and BN
    running statistics after steps 1 and 4, the dead fc_auxi equal to
    its init, and the eval step's predictions afterwards."""
    kw = dict(BASE, fusion_method="concat")
    jmodel, jstep, state, model, opt, step = _setup(kw, clip)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    for k, batch in enumerate(_batches(4)):
        state, jm = jstep(state, {n: jnp.asarray(v) for n, v in
                                  batch.items()})
        m = step({n: torch.from_numpy(v) for n, v in batch.items()})
        assert model.training
        for name in METRICS:
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=2e-4, atol=1e-6,
                                       err_msg=f"step {k} {name}")
        if clip < 1:
            assert float(m["grad_norm"]) > clip  # the clip acted
        if k in (0, 3):
            _assert_state(model, state, 2e-5 if k == 0 else 5e-4,
                          f"step {k}")
    for name in ("fusion_module.fc_auxi.weight",
                 "fusion_module.fc_auxi.bias"):
        assert torch.equal(model.state_dict()[name], init[name])
        assert model.get_parameter(name).grad is None
    # BN: one statistics update per step, none reaching the optimizer
    bns = [mod for mod in model.modules()
           if isinstance(mod, torch.nn.BatchNorm2d)]
    assert len(bns) == 24
    assert all(int(b.num_batches_tracked) == 4 for b in bns)
    n_params = sum(1 for _ in model.parameters())
    assert sum(len(g["params"]) for g in opt.param_groups) == n_params
    assert not any("running" in n for n, _ in model.named_parameters())

    # eval step: running statistics, the same predictions as gdl_tpu
    batch = _batches(1, seed=9)[0]
    want = jax.jit(jax_dgl.make_eval_step(jmodel, None))(
        state, {n: jnp.asarray(v) for n, v in batch.items()})
    got = make_eval_step(model)({n: torch.from_numpy(v)
                                 for n, v in batch.items()})
    assert not model.training
    assert all(int(b.num_batches_tracked) == 4 for b in bns)
    for name in ("pred", "pred_a", "pred_v", "label"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("fusion", ["sum", "film", "gated"])
def test_other_fusion_heads_one_step_matches_jax(fusion):
    """One step with each of the other DGL heads: the stop-gradient
    points sit where gdl_tpu's `fuse` and `unimodal` put them, so the
    metrics (rtol 2e-4) and every parameter (atol 2e-5) agree; the gated
    head's fc_x / fc_y get no gradient and keep their initial values."""
    kw = dict(BASE, fusion_method=fusion)
    _, jstep, state, model, _, step = _setup(kw, 40.0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batches(1, seed=5)[0]
    state, jm = jstep(state, {n: jnp.asarray(v) for n, v in batch.items()})
    m = step({n: torch.from_numpy(v) for n, v in batch.items()})
    for name in METRICS:
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=2e-4, atol=1e-6, err_msg=name)
    _assert_state(model, state, 2e-5, fusion)
    moved = [n for n, v in model.state_dict().items()
             if n.startswith("fusion_module.") and not torch.equal(v, init[n])]
    frozen = ({"fusion_module.fc_x.weight", "fusion_module.fc_x.bias",
               "fusion_module.fc_y.weight", "fusion_module.fc_y.bias"}
              if fusion == "gated" else set())
    fusion_names = {n for n in init if n.startswith("fusion_module.")}
    assert set(moved) == fusion_names - frozen
    for n in frozen:
        assert model.get_parameter(n).grad is None


@pytest.mark.parametrize("modality", ["audio", "visual"])
def test_single_modality_step_matches_jax(modality):
    """--modality audio|visual: one encoder, a plain classifier, the loss
    (2α+1)·CE; one step's metrics and parameters against gdl_tpu's."""
    kw = dict(BASE, fusion_method="concat", modality=modality)
    _, jstep, state, model, _, step = _setup(kw, 40.0)
    batch = _batches(1, seed=6)[0]
    state, jm = jstep(state, {n: jnp.asarray(v) for n, v in batch.items()})
    m = step({n: torch.from_numpy(v) for n, v in batch.items()})
    for name in METRICS:
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=2e-4, atol=1e-6, err_msg=name)
    other = "visual_grad_sum" if modality == "audio" else "audio_grad_sum"
    assert float(m[other]) == 0.0
    np.testing.assert_allclose(float(m["loss"]), 7.0 * float(m["loss_f"]),
                               rtol=1e-6)
    _assert_state(model, state, 2e-5, modality)
