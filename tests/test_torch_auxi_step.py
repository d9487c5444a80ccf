"""The port's AUXI train step (`gdl_tpu_torch/train/auxi.py`) on the
intermediate-fusion family against gdl_tpu's jitted step.

Both packages start from gdl_tpu's init (bridged with
`state_dict_from_flax`, strict) and take the same numpy-seeded batches
at a small size (width 8, embed 128, 16 tokens, batch 4). The random
sites are fed alike: gdl_tpu's dropout sites are patched to the identity
and the port's rates set to 0 (the two generators' bits differ), and the
PE heads of both get the same standard-normal draws from numpy.

Tolerances, as for the ResNet step (tests/test_torch_resnet_dgl_step.py):
metrics rtol 2e-4; parameters and BatchNorm running statistics 2e-5
after one step and 5e-4 after four."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.models import intermediate as jax_inter
from gdl_tpu.models import transformer as jax_tr
from gdl_tpu.train import auxi as jax_auxi
from gdl_tpu.train import dgl as jax_dgl
from gdl_tpu.train import joint as jax_joint
from gdl_tpu.train import optim as jax_optim
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models import classifier as port_classifier
from gdl_tpu_torch.models import intermediate as port_inter
from gdl_tpu_torch.models import transformer as port_tr
from gdl_tpu_torch.train import auxi as port_auxi
from gdl_tpu_torch.train.optim import make_optimizer
from gdl_tpu_torch.utils.interop import state_dict_from_flax

METRICS = ("loss", "loss_f", "loss_a", "loss_v")
KW = dict(dataset="CREMAD", alpha=2.0, beta=0.05, learning_rate=0.05,
          lr_decay_step=[2], encoder_width=8, fps=1, log_grad_csv=False)
BATCH = 4


@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"audio": rng.standard_normal((BATCH, 64, 64, 3)).astype(
                 np.float32),
             "visual": rng.standard_normal((BATCH, 64, 64, 3)).astype(
                 np.float32),
             "label": rng.integers(0, 6, BATCH).astype(np.int32)}
            for _ in range(n)]


def _setup(name, monkeypatch, **model_kw):
    """(jax step, jax state, port model, port step); both sides without
    dropout and with the PE noise of `noise`, in call order."""
    jcfg, cfg = JaxConfig(**KW), Config(**KW)
    extra = dict(embed_dim=128, seq_len=16) if name == "mmformer_n" else {}
    jmodel, kind = jax_inter.build_intermediate(name, 6, width=8, **model_kw,
                                                **extra)
    jopt = jax_optim.make_optimizer(jcfg, 2, clip_norm=40.0)
    b = _batches(1)[0]
    k = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: jmodel.init(
        {"params": k, "drop": k, "dropout": k, "pe": k}, b["audio"],
        b["visual"], train=False, av_inputs=False))(k)
    state = jax_dgl.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=jopt.init(variables["params"]))

    rng = np.random.default_rng(99)
    noise = [rng.standard_normal((BATCH, 4, 4, 16)).astype(np.float32)
             for _ in range(2)]  # rgb_p, then depth_p
    monkeypatch.setattr(jax_tr.Drop, "__call__",
                        lambda self, x, deterministic: x)
    jax_draws = itertools.cycle(noise)
    port_draws = itertools.cycle(noise)
    with monkeypatch.context() as m:
        # patched while the step is traced: the draws become constants
        m.setattr(jax.random, "normal",
                  lambda key, shape, dtype=jnp.float32: jnp.asarray(
                      next(jax_draws)))
        jstep = jax.jit(jax_auxi.make_auxi_train_step(
            jmodel, jcfg, jopt, seven_tuple=kind == "seven", base_rng=k,
            av_inputs=False))
        batch0 = {n: jnp.asarray(v) for n, v in b.items()}
        jstep.lower(state, batch0)  # trace now, under the patch
        jstep = jstep  # the trace is cached for these shapes
        state1, _ = jstep(state, batch0)
    del state1
    monkeypatch.setattr(port_classifier, "pe_noise",
                        lambda shape, gen, dev: torch.from_numpy(
                            next(port_draws)))

    model, pkind = port_inter.build_intermediate(name, 6, width=8, **model_kw,
                                                 **extra)
    assert pkind == kind
    model.load_state_dict(state_dict_from_flax(
        _np_tree(state.params), _np_tree(state.batch_stats)), strict=True)
    for mod in model.modules():
        if isinstance(mod, port_tr.Drop):
            mod.rate = 0.0
        if isinstance(mod, port_tr.SelfAttention):
            mod.dropout_rate = 0.0
    opt = make_optimizer(cfg, model.parameters(), 2, clip_norm=40.0)
    step = port_auxi.make_auxi_train_step(
        model, cfg, opt, seven_tuple=kind == "seven", av_inputs=False)
    return jstep, state, model, step


def _assert_state(model, state, atol, msg):
    want = state_dict_from_flax(_np_tree(state.params),
                                _np_tree(state.batch_stats))
    got = model.state_dict()
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=f"{msg} {name}")


@pytest.mark.parametrize("name,model_kw,bn_updates", [
    ("mmformer_n", dict(share_streams=True), 2),
    ("mmformer_n", dict(share_streams=False), 3),
    ("mmformer_n", dict(share_streams=True, batched_inter=True), 2),
    ("mmtm", {}, None)],
    ids=["mmformer_n_share", "mmformer_n_strict", "mmformer_n_batched",
         "mmtm"])
def test_auxi_step_matches_jax_step(name, model_kw, bn_updates, monkeypatch):
    """Four steps (2 per epoch, LR decay at epoch 2): every metric per
    step, parameters and BN running statistics after steps 1 and 4. The
    token-projection BatchNorms of MMFormerN are updated twice a step
    with share_streams and three times without, in gdl_tpu's order."""
    jstep, state, model, step = _setup(name, monkeypatch, **model_kw)
    for k, batch in enumerate(_batches(4, seed=1)):
        state, jm = jstep(state, {n: jnp.asarray(v) for n, v in
                                  batch.items()})
        m = step({n: torch.from_numpy(v) for n, v in batch.items()})
        assert model.training
        for key in METRICS:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=2e-4, atol=1e-6,
                                       err_msg=f"step {k} {key}")
        assert np.isfinite(float(m["grad_norm"]))
        if k in (0, 3):
            _assert_state(model, state, 2e-5 if k == 0 else 5e-4,
                          f"step {k}")
    if bn_updates is not None:
        assert int(model.project0.bn.num_batches_tracked) == 4 * bn_updates
        assert int(model.project1.bn.num_batches_tracked) == 4 * bn_updates
        assert int(model.stem_rgb.bn1.num_batches_tracked) == 4
        assert int(model.rgb_p.mu_bn.num_batches_tracked) == 4


def test_regurize_matches_jax():
    rng = np.random.default_rng(3)
    mu = rng.standard_normal((5, 3, 3, 8)).astype(np.float32)
    std = np.exp(0.3 * rng.standard_normal((5, 3, 3, 8))).astype(np.float32)
    want = jax_joint.regurize(jnp.asarray(mu), jnp.asarray(std))
    got = port_auxi.regurize(torch.from_numpy(mu), torch.from_numpy(std))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_sefusion_step_is_plain_cross_entropy():
    """One step of the single-logits model: loss = loss_f = loss_a =
    loss_v = CE, parameters move, BatchNorm statistics update once."""
    cfg = Config(**KW)
    model, kind = port_inter.build_intermediate(
        "sefusion", 6, width=8, generator=torch.Generator().manual_seed(0))
    assert kind == "single"
    opt = make_optimizer(cfg, model.parameters(), 2, clip_norm=40.0)
    step = port_auxi.make_sefusion_step(model, cfg, opt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {n: torch.from_numpy(v) for n, v in _batches(1, seed=4)[0].items()}
    m = step(batch)
    assert float(m["loss"]) == float(m["loss_f"]) == float(m["loss_a"])
    after = {k: v.clone() for k, v in model.state_dict().items()}
    assert not torch.equal(before["trunk.fc.weight"], after["trunk.fc.weight"])
    assert int(after["stem_rgb.bn1.num_batches_tracked"]) == 1
    with torch.no_grad():
        model.load_state_dict(before)
        model.train()
        out = model(batch["audio"], batch["visual"])
    want = torch.nn.functional.cross_entropy(out, batch["label"].long())
    np.testing.assert_allclose(float(m["loss"]), float(want), rtol=1e-5)


def test_auxi_step_with_dropout_on_is_reproducible_from_the_generator():
    """Dropout, PE noise and the step as a whole draw from the one
    explicit generator: equal seeds give equal steps, other seeds do
    not."""
    cfg = Config(**KW)
    losses = []
    for seed in (5, 5, 6):
        model, _ = port_inter.build_intermediate(
            "mmformer_n", 6, width=8, embed_dim=128, seq_len=16,
            share_streams=True, generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(cfg, model.parameters(), 2, clip_norm=40.0)
        step = port_auxi.make_auxi_train_step(
            model, cfg, opt, seven_tuple=True,
            generator=torch.Generator().manual_seed(seed), av_inputs=False)
        batch = {n: torch.from_numpy(v)
                 for n, v in _batches(1, seed=7)[0].items()}
        losses.append([float(step(batch)["loss"]) for _ in range(2)])
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]
    assert losses[0][0] != losses[0][1]
