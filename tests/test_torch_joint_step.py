"""The port's joint step (`gdl_tpu_torch/train/joint.py`) and the
AdaGrad / AdamW updates against gdl_tpu's jitted steps.

Both packages start from gdl_tpu's init, bridged with
`state_dict_from_flax` (strict), and take the same numpy-seeded batches
at a tiny size (ResNet width 8, stages [1,1,1,1], batch 8; Swin embed
16, two blocks, 32² inputs). The random draws are fed alike: the PE
noise and modality-drop combinations by patching `jax.random.normal` /
`randint` while gdl_tpu's step is traced and the port's `pe_noise` /
`modality_combo`; the OGM-GE noise (flax's HWIO layout) by wrapping
gdl_tpu's `apply_ogm` so that its per-leaf draws come from a noise tree,
which the weight bridge maps to the port's names and OIHW layout for the
port's `ogm_noise` hook; gdl_tpu's DropPath is the identity and the
port's rate 0. Being traced once, gdl_tpu's step takes the same draws
every step; so does the port's.

Tolerances, as for the DGL steps (tests/test_torch_resnet_dgl_step.py):
metrics rtol 2e-4; parameters and BatchNorm running statistics atol
2e-5 after one step; after four, where the gradients of 24 BatchNorms
compound, 5e-4."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.models import classifier as jax_classifier
from gdl_tpu.models import swin as jax_swin
from gdl_tpu.train import dgl as jax_dgl
from gdl_tpu.train import joint as jax_joint
from gdl_tpu.train import optim as jax_optim
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models import classifier as port_classifier
from gdl_tpu_torch.train.dgl import make_dgl_train_step
from gdl_tpu_torch.train.joint import make_joint_train_step
from gdl_tpu_torch.train.optim import (
    ClippedAdaGrad,
    ClippedAdamW,
    make_optimizer,
)
from gdl_tpu_torch.utils.interop import state_dict_from_flax
from tests.test_torch_joint_modules import jax_apply_ogm_fed, ogm_noise_tree

METRICS = ("loss", "loss_f", "loss_a", "loss_v", "a_diversity",
           "v_diversity", "a_re", "v_re")
BASE = dict(dataset="CREMAD", alpha=0.5, learning_rate=0.05,
            lr_decay_step=[2], encoder_width=8, encoder_stages=[1, 1, 1, 1],
            fps=2, log_grad_csv=False)
SWIN_TINY = dict(swin_embed_dim=16, swin_depths=[1, 1], swin_heads=[2, 4],
                 swin_window=4, swin_img_size=32, swin_patch=4,
                 backbone="swin")
BATCH = 8
STEPS_PER_EPOCH = 2


@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _batches(n, swin=False, seed=0):
    rng = np.random.default_rng(seed)
    audio = (BATCH, 32, 32, 1) if swin else (BATCH, 65, 47, 1)
    visual = (BATCH, 2, 32, 32, 3) if swin else (BATCH, 2, 64, 64, 3)
    return [{"audio": rng.standard_normal(audio).astype(np.float32),
             "visual": rng.standard_normal(visual).astype(np.float32),
             "label": rng.integers(0, 6, BATCH).astype(np.int32)}
            for _ in range(n)]


def _init(jmodel, swin):
    b = _batches(1, swin)[0]
    variables = jax.jit(lambda k: jmodel.init(
        {"params": k}, b["audio"], b["visual"], train=False))(
        jax.random.PRNGKey(0))
    return variables["params"], variables.get("batch_stats", {})


def _feed(monkeypatch, params, swin):
    """Patch the draws of both packages (see the module docstring) →
    the port's OGM-GE noise hook."""
    res = 4 if swin else None
    shapes = ([(BATCH, res, res, 32), (2 * BATCH, res, res, 32)] if swin
              else [(BATCH, 3, 2, 64), (2 * BATCH, 2, 2, 64)])
    rng = np.random.default_rng(7)
    pe = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    combos = rng.integers(0, 3, BATCH).astype(np.int32)
    jax_pe, port_pe = itertools.cycle(pe), itertools.cycle(pe)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(
                            next(jax_pe), dtype))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(combos))
    monkeypatch.setattr(jax_swin.DropPath, "__call__",
                        lambda self, x, train: x)
    monkeypatch.setattr(port_classifier, "pe_noise",
                        lambda shape, gen, dev: torch.from_numpy(
                            next(port_pe)))
    monkeypatch.setattr(port_classifier, "modality_combo",
                        lambda b, gen, dev: torch.from_numpy(combos).long())
    noise = ogm_noise_tree(_np_tree(params))
    monkeypatch.setattr(jax_joint, "apply_ogm", jax_apply_ogm_fed(noise))
    port_noise = state_dict_from_flax(noise, {})
    return lambda name, shape: port_noise[name]


def _assert_state(model, params, stats, atol, msg, adaptive_lr=None):
    """Parameters and running statistics against gdl_tpu's at `atol`.
    After one AdaGrad / AdamW step (adaptive_lr, its learning rate), an
    element whose gradient is below 1e-4 of its tensor's largest lies
    within the two packages' rounding of zero: the adaptive step scales
    it by up to lr / sqrt(eps) and may turn its sign, so it is held to
    2·lr (the most two such steps differ); such elements (0.11-0.14% of
    the parameters here) must stay under 0.5%."""
    want = state_dict_from_flax(_np_tree(params), _np_tree(stats))
    got = model.state_dict()
    named = dict(model.named_parameters())
    near_zero = total = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = (got[name] - w).abs()
        grad = named[name].grad if name in named else None
        if adaptive_lr is not None and grad is not None:
            small = grad.abs() < 1e-4 * grad.abs().max()
            near_zero += int(small.sum())
            total += grad.numel()
            if small.any():
                assert float(diff[small].max()) <= 2 * adaptive_lr, name
            diff = diff[~small]
        if diff.numel():
            assert float(diff.max()) <= atol, (
                f"{msg} {name}: max |diff| {float(diff.max())}")
    assert near_zero <= 5e-3 * max(total, 1), (near_zero, total)


CASES = {
    # steps 1-2 modulated (epoch 0), 3-4 not (epoch 1 > modulation_ends)
    "concat_ogm_ge_4steps": dict(fusion_method="concat",
                                 modulation="OGM_GE", modulation_ends=0,
                                 steps=4),
    "sum_ogm_adagrad": dict(fusion_method="sum", modulation="OGM",
                            optimizer="AdaGrad", learning_rate=2e-3,
                            steps=1),
    "film_normal_adamw_drop": dict(fusion_method="film", modulation="Normal",
                                   optimizer="Adam", learning_rate=2e-3,
                                   drop=1, steps=1),
    "gated_pe_ogm_ge": dict(fusion_method="gated", modulation="OGM_GE",
                            pe=1, beta=0.05, steps=1),
    "swin_pe_ogm_ge": dict(SWIN_TINY, fusion_method="concat",
                           modulation="OGM_GE", pe=1, beta=0.05, steps=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_joint_step_matches_jax_step(case, monkeypatch):
    """One (four) joint steps: every metric of each step, the parameters
    and the running statistics after steps 1 and 4, against gdl_tpu's
    jitted make_joint_train_step with its optimizer chain without a clip
    (make_optimizer(clip_norm=None)). The encoders run once a step: each
    BatchNorm counts one update per step."""
    kw = dict(BASE, **CASES[case])
    steps = kw.pop("steps")
    swin = kw.get("backbone") == "swin"
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    if swin:
        jmodel = jax_classifier.AVClassifierSwin(config=jcfg)
        model = port_classifier.AVClassifierSwin(cfg, drop_path_rate=0.0)
    else:
        jmodel = jax_classifier.AVClassifier(config=jcfg)
        model = port_classifier.AVClassifier(cfg)
    params, stats = _init(jmodel, swin)
    jopt = jax_optim.make_optimizer(jcfg, STEPS_PER_EPOCH, clip_norm=None)
    state = jax_dgl.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats,
                               opt_state=jopt.init(params))
    model.load_state_dict(state_dict_from_flax(_np_tree(params),
                                               _np_tree(stats)), strict=True)
    noise = _feed(monkeypatch, params, swin)
    jstep = jax.jit(jax_joint.make_joint_train_step(
        jmodel, jcfg, jopt, STEPS_PER_EPOCH,
        base_rng=jax.random.PRNGKey(3)))
    opt = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH,
                         clip_norm=None)
    assert opt.clip_norm is None
    step = make_joint_train_step(model, cfg, opt, STEPS_PER_EPOCH,
                                 ogm_noise=noise)
    for k, batch in enumerate(_batches(steps, swin)):
        state, jm = jstep(state, {n: jnp.asarray(v) for n, v in
                                  batch.items()})
        m = step({n: torch.from_numpy(v) for n, v in batch.items()})
        assert model.training
        for name in METRICS:
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=2e-4, atol=1e-6,
                                       err_msg=f"step {k} {name}")
        assert float(m["loss_a"]) == float(m["loss_f"])
        if k in (0, 3):
            _assert_state(model, state.params, state.batch_stats,
                          2e-5 if k == 0 else 5e-4, f"step {k}",
                          adaptive_lr=(None if cfg.optimizer == "sgd"
                                       else cfg.learning_rate))
    bns = [mod for mod in model.modules()
           if isinstance(mod, torch.nn.BatchNorm2d)]
    assert bns and all(int(b.num_batches_tracked) == steps for b in bns)
    assert opt.steps == steps


@pytest.mark.parametrize("optimizer,fusion", [("AdaGrad", "concat"),
                                              ("Adam", "gated")])
def test_dgl_step_with_adagrad_and_adamw_matches_jax(optimizer, fusion):
    """One DGL step with AdaGrad / AdamW behind the clip at 40, as
    gdl_tpu's chain has it: metrics rtol 2e-4, parameters and running
    statistics atol 2e-5; the heads' dead parameters (concat's fc_auxi,
    gated's fc_x / fc_y) keep their initial values on both sides."""
    kw = dict(BASE, optimizer=optimizer, fusion_method=fusion,
              learning_rate=2e-3, log_grad_csv=True)
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    jmodel = jax_classifier.AVClassifierDGL(config=jcfg)
    params, stats = _init(jmodel, False)
    jopt = jax_optim.make_optimizer(
        jcfg, STEPS_PER_EPOCH, clip_norm=40.0,
        wd_mask=jax_optim.dead_fusion_param_mask(jcfg, dgl=True))
    state = jax_dgl.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats,
                               opt_state=jopt.init(params))
    jstep = jax.jit(jax_dgl.make_dgl_train_step(jmodel, jcfg, jopt,
                                                clip_norm=40.0))
    model = port_classifier.AVClassifierDGL(cfg)
    model.load_state_dict(state_dict_from_flax(_np_tree(params),
                                               _np_tree(stats)), strict=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    assert isinstance(opt, ClippedAdaGrad if optimizer == "AdaGrad"
                      else ClippedAdamW)
    assert opt.clip_norm == 40.0
    step = make_dgl_train_step(model, cfg, opt, clip_norm=40.0)
    batch = _batches(1, seed=5)[0]
    state, jm = jstep(state, {n: jnp.asarray(v) for n, v in batch.items()})
    m = step({n: torch.from_numpy(v) for n, v in batch.items()})
    for name in ("loss", "loss_f", "loss_a", "loss_v", "grad_norm",
                 "audio_grad_sum", "visual_grad_sum"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=2e-4, atol=1e-6, err_msg=name)
    _assert_state(model, state.params, state.batch_stats, 2e-5, optimizer,
                  adaptive_lr=cfg.learning_rate)
    dead = ({"fc_auxi"} if fusion == "concat" else {"fc_x", "fc_y"})
    for name, v in model.state_dict().items():
        if name.split(".")[:2][-1] in dead:
            assert torch.equal(v, init[name]), name


@pytest.mark.parametrize("clip", [40.0, None], ids=["clip40", "no_clip"])
@pytest.mark.parametrize("optimizer", ["AdaGrad", "Adam"])
def test_adagrad_and_adamw_updates_match_optax(optimizer, clip):
    """The port's AdaGrad and AdamW against gdl_tpu's optax chains on the
    same gradients, three steps (one whose norm is above 40, one with
    exact zeros and values near sqrt(eps)), with and without the clip:
    parameters atol 1e-7, rtol 1e-6."""
    cfg = JaxConfig(**dict(BASE, optimizer=optimizer, learning_rate=2e-3))
    rng = np.random.default_rng(12)
    shapes = {"a": (5, 7), "b": (3, 4, 2, 2), "c": (6,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = []
    for scale in (30.0, 1.0, 1e-5):
        g = {k: (scale * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
        g["c"][:3] = 0.0
        grads.append(g)
    jopt = jax_optim.make_optimizer(cfg, STEPS_PER_EPOCH, clip_norm=clip)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = make_optimizer(Config(**dict(BASE, optimizer=optimizer,
                                       learning_rate=2e-3)),
                         list(tparams.values()), STEPS_PER_EPOCH,
                         clip_norm=clip)
    for g in grads:
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in
                                       g.items()}, jstate, jparams)
        jparams = {k: jparams[k] + updates[k] for k in jparams}
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
