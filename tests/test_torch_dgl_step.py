"""The port's DGL train step, optimizer and LR schedule against gdl_tpu's.

Both packages start from the same weights (gdl_tpu's init, bridged with
`state_dict_from_flax`) and take the same numpy-seeded batches, on the
tiny dual Swin of tests/test_swin_dgl.py. DropPath is off on both sides
(the port's rate is 0; gdl_tpu's DropPath.__call__ is monkeypatched to
the identity), because the two RNGs draw differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config
from gdl_tpu.models.classifier import AVClassifierSwinDGL as JaxSwinDGL
from gdl_tpu.train import dgl as jax_dgl
from gdl_tpu.train import optim as jax_optim
from gdl_tpu_torch.models.classifier import AVClassifierSwinDGL
from gdl_tpu_torch.train.dgl import (
    cross_entropy,
    dgl_loss_fn,
    make_dgl_train_step,
)
from gdl_tpu_torch.train.optim import (
    lr_for_epoch,
    make_lr_schedule,
    make_optimizer,
)
from gdl_tpu_torch.utils.interop import state_dict_from_flax

SWIN_TINY = dict(swin_embed_dim=16, swin_depths=[1, 1], swin_heads=[2, 4],
                 swin_window=4, swin_img_size=32, swin_patch=4,
                 backbone="swin")
METRICS = ("loss", "loss_f", "loss_a", "loss_v", "grad_norm",
           "audio_grad_sum", "visual_grad_sum", "abs_out_a", "abs_out_v")


def _cfg(**kw):
    base = dict(dataset="VGGSound", fusion_method="concat", alpha=3.0,
                log_grad_csv=True, learning_rate=0.05, lr_decay_step=[2],
                **SWIN_TINY)
    base.update(kw)
    return Config(**base)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"audio": rng.standard_normal((8, 32, 32, 1)).astype(np.float32),
             "visual": rng.standard_normal((8, 2, 32, 32, 3)).astype(
                 np.float32),
             "label": rng.integers(0, 309, 8).astype(np.int32)}
            for _ in range(n)]


def _port_model(cfg, params):
    model = AVClassifierSwinDGL(cfg, drop_path_rate=0.0)
    model.load_state_dict(state_dict_from_flax(params, {}), strict=True)
    return model


def _jax_init(jmodel, key):
    """gdl_tpu's params for a batch shaped like _batches' (jitted: eager
    flax init is slow on the CPU)."""
    b = _batches(1)[0]
    return jax.jit(lambda k: jmodel.init({"params": k}, b["audio"],
                                         b["visual"], train=False))(
        key)["params"]


@pytest.fixture
def no_jax_droppath(monkeypatch):
    import gdl_tpu.models.swin as swin_mod

    monkeypatch.setattr(swin_mod.DropPath, "__call__",
                        lambda self, x, train: x)


@pytest.mark.parametrize("clip", [40.0, 0.05], ids=["clip40", "clip_acts"])
def test_dgl_step_matches_jax_step(no_jax_droppath, clip):
    """Four steps (2 steps per epoch, LR decay at epoch 2, so steps 3-4
    run at a tenth of the LR), clip 40 and a clip that scales every step
    (‖g‖ ≈ 15): every metric per step within rtol 1e-5 (atol 1e-6),
    params within 1e-6 after one step and within 2e-4 after four, and
    the dead fc_auxi equal to its init on both sides."""
    cfg = _cfg()
    jmodel = JaxSwinDGL(config=cfg)
    jopt = jax_optim.make_optimizer(
        cfg, 2, clip_norm=clip,
        wd_mask=jax_optim.dead_fusion_param_mask(cfg, dgl=True))
    params = _jax_init(jmodel, jax.random.PRNGKey(0))
    state = jax_dgl.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats={}, opt_state=jopt.init(params))
    jstep = jax.jit(jax_dgl.make_dgl_train_step(jmodel, cfg, jopt,
                                                clip_norm=clip))

    model = _port_model(cfg, state.params)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(cfg, model.parameters(), 2, clip_norm=clip)
    step = make_dgl_train_step(model, cfg, opt, clip_norm=clip)

    for k, batch in enumerate(_batches(4)):
        state, jm = jstep(state, {n: jnp.asarray(v) for n, v in
                                  batch.items()})
        m = step({n: torch.from_numpy(v) for n, v in batch.items()})
        for name in METRICS:
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {k} {name}")
        if clip < 1:
            assert float(m["grad_norm"]) > clip  # the clip acted
        if k in (0, 3):
            want = state_dict_from_flax(jax.device_get(state.params), {})
            got = model.state_dict()
            for name, w in want.items():
                np.testing.assert_allclose(
                    got[name].numpy(), w.numpy(), rtol=0,
                    atol=1e-6 if k == 0 else 2e-4,
                    err_msg=f"step {k} {name}")
    for name in ("fusion_module.fc_auxi.weight",
                 "fusion_module.fc_auxi.bias"):
        assert torch.equal(model.state_dict()[name], init[name])
        assert model.get_parameter(name).grad is None
    assert opt.steps == 4 and opt.param_groups[0]["lr"] == pytest.approx(
        0.005)


def test_dgl_gradient_topology():
    """tests/test_swin_dgl.py's topology on the port: the fused loss
    reaches the fusion head only (every encoder gradient absent or
    zero), the unimodal loss reaches the encoders only."""
    cfg = _cfg()
    model = AVClassifierSwinDGL(cfg, drop_path_rate=0.0,
                                generator=torch.Generator().manual_seed(0))
    b = {n: torch.from_numpy(v) for n, v in _batches(1)[0].items()}

    def grads(loss_of):
        model.zero_grad(set_to_none=True)
        a, v = model.encode(b["audio"], b["visual"])
        loss_of(a, v).backward()
        enc = [p.grad for n, p in model.named_parameters()
               if "fusion" not in n]
        fus = [p.grad for n, p in model.named_parameters() if "fusion" in n]
        return enc, fus

    def max_abs(gs):
        return max((float(g.abs().max()) for g in gs if g is not None),
                   default=0.0)

    enc, fus = grads(lambda a, v: cross_entropy(model.fused_logits(a, v),
                                                b["label"]))
    assert max_abs(enc) == 0.0 and max_abs(fus) > 0.0
    enc, fus = grads(lambda a, v: sum(
        cross_entropy(o, b["label"]) for o in model.unimodal_logits(a, v)))
    assert max_abs(fus) == 0.0 and max_abs(enc) > 0.0


def test_unimodal_modality_loss_matches_jax(no_jax_droppath):
    """modality='audio': the loss is (2α+1)·CE of the model's first
    logits, as gdl_tpu's dgl_loss_fn computes it, rtol 1e-5."""
    cfg = _cfg(modality="audio")
    jmodel = JaxSwinDGL(config=cfg)
    batch = _batches(1, seed=3)[0]
    params = _jax_init(jmodel, jax.random.PRNGKey(1))
    jloss, (_, jm) = jax.jit(lambda p, b: jax_dgl.dgl_loss_fn(
        jmodel, p, {}, b, cfg, train=True, rng=jax.random.PRNGKey(0)))(
        params, {n: jnp.asarray(v) for n, v in batch.items()})
    model = _port_model(cfg, params).train()
    with torch.no_grad():
        loss, m = dgl_loss_fn(model, {n: torch.from_numpy(v) for n, v in
                                      batch.items()}, cfg)
    loss = float(loss)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(loss, 7.0 * float(m["loss_f"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["loss_a"]), float(jm["loss_a"]),
                               rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(lr_decay_step=[3, 5], lr_decay_ratio=0.1),
    dict(lr_decay_step=[], learning_rate=0.01),
    dict(warmup=True, total_epoch=3, lr_decay_step=[2, 4]),
    dict(optimizer="AdaGrad"),
], ids=["milestones", "no_decay", "warmup", "adagrad"])
def test_lr_schedule_matches_jax(kw):
    """lr_for_epoch over epochs 0-9 and the per-step schedule over 30
    steps at 3 steps per epoch equal gdl_tpu's (the decay at the top of
    the epoch, the warmup), rtol 1e-6."""
    cfg = _cfg(**kw)
    for e in range(10):
        assert lr_for_epoch(cfg, e) == pytest.approx(
            jax_optim.lr_for_epoch(cfg, e), rel=1e-12)
    mine, theirs = make_lr_schedule(cfg, 3), jax_optim.make_lr_schedule(cfg,
                                                                        3)
    for s in range(30):
        assert mine(s) == pytest.approx(float(theirs(jnp.asarray(s))),
                                        rel=1e-6)


def test_optimizers_not_ported_yet_raise():
    """AdaGrad and Adam are ported (held to gdl_tpu's optax chains in
    tests/test_torch_joint_step.py); an optimizer gdl_tpu lacks still
    raises."""
    model = torch.nn.Linear(2, 2)
    for name in ("AdaGrad", "Adam"):
        opt = make_optimizer(_cfg(optimizer=name), model.parameters(), 1)
        assert opt.clip_norm == 40.0
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(_cfg(optimizer="RMSprop"), model.parameters(), 1)
