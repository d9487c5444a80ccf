"""The port's transformer primitives (`gdl_tpu_torch/models/
transformer.py`) against gdl_tpu's flax modules, with gdl_tpu's init
bridged by `state_dict_from_flax` (strict=True) and numpy-seeded inputs:
eval outputs atol 2e-4; training-mode outputs and gradients with
gdl_tpu's dropout sites patched to the identity (its generator's bits
cannot be reproduced) and the port's rates set to 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.models import transformer as jax_tr
from gdl_tpu_torch.models import transformer as port_tr
from gdl_tpu_torch.utils.interop import state_dict_from_flax

ATOL = 2e-4


@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _x(b, n, c, seed=0):
    return np.random.default_rng(seed).standard_normal((b, n, c)).astype(
        np.float32)


def _bridge(jmodel, model, x, seed=1):
    """gdl_tpu's init with non-zero biases and LayerNorm offsets, loaded
    strictly into the port's module."""
    k = jax.random.PRNGKey(0)
    variables = jmodel.init({"params": k, "dropout": k}, jnp.asarray(x))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                      .astype(np.float32))
        if "bias" in jax.tree_util.keystr(p) else np.asarray(a),
        jax.device_get(variables["params"]))
    model.load_state_dict(state_dict_from_flax(params, {}), strict=True)
    return {"params": params}


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, port_tr.Drop):
            m.rate = 0.0
        if isinstance(m, port_tr.SelfAttention):
            m.dropout_rate = 0.0
    return model


def test_gelu_tanh_matches_jax():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(port_tr.gelu_tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_tr.gelu_tanh(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("dim,heads", [(128, 8), (64, 8)],
                         ids=["fused", "unfused"])
def test_self_attention_eval_matches_jax(dim, heads):
    """dim 128 with 8 heads takes the fused op (its plain version here);
    dim 64 with 8 heads is a head configuration the fused kernels do not
    take, so both packages run the unfused path."""
    x = _x(2, 16, dim)
    jmodel = jax_tr.SelfAttention(dim, heads, 0.1)
    model = port_tr.SelfAttention(dim, heads, 0.1).eval()
    variables = _bridge(jmodel, model, x)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_feed_forward_matches_jax():
    x = _x(2, 16, 64, seed=2)
    jmodel = jax_tr.FeedForward(64, 256, 0.1)
    model = port_tr.FeedForward(64, 256, 0.1).eval()
    variables = _bridge(jmodel, model, x)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_transformer_block_matches_jax(train, monkeypatch):
    """One pre-norm block (LayerNorm eps 1e-5): outputs, and in training
    mode (dropout off on both sides) the gradients of every parameter."""
    x = _x(2, 16, 128, seed=3)
    cot = _x(2, 16, 128, seed=4)
    jmodel = jax_tr.TransformerBlock(128, 8, 256)
    model = port_tr.TransformerBlock(128, 8, 256).train(train)
    variables = _bridge(jmodel, model, x)
    monkeypatch.setattr(jax_tr.Drop, "__call__",
                        lambda self, x, deterministic: x)
    _no_dropout(model)

    def loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(x), train=train,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    if train:
        got.backward(torch.from_numpy(cot))
        want_grads = state_dict_from_flax(_np_tree(grads), {})
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(),
                                       want_grads[name].numpy(), rtol=1e-3,
                                       atol=2e-3, err_msg=name)


def test_transformer_model_returns_every_intermediate():
    x = _x(2, 16, 128, seed=5)
    jmodel = jax_tr.TransformerModel(128, 2, 8, 256)
    model = port_tr.TransformerModel(128, 2, 8, 256).eval()
    variables = _bridge(jmodel, model, x)
    want, want_all = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got, got_all = model(torch.from_numpy(x))
    assert len(got_all) == 2 and torch.equal(got, got_all[-1])
    for g, w in zip(got_all, want_all):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def test_mm_transformer_model_matches_jax():
    x = _x(2, 32, 128, seed=6)
    jmodel = jax_tr.MMTransformerModel(modal_num=2, dim=128, depth=2,
                                       mlp_dim=256)
    model = port_tr.MMTransformerModel(2, 128, depth=2, mlp_dim=256).eval()
    variables = _bridge(jmodel, model, x)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_positional_encodings_match_jax():
    np.testing.assert_array_equal(port_tr.fixed_positional_encoding(20, 16),
                                  jax_tr.fixed_positional_encoding(20, 16))
    x = _x(2, 6, 8, seed=7)
    pe = np.random.default_rng(8).standard_normal((1, 6, 8)).astype(
        np.float32)
    want = jax_tr.LearnedPositionalEncoding(6, 8).apply(
        {"params": {"position_embeddings": jnp.asarray(pe)}}, jnp.asarray(x))
    model = port_tr.LearnedPositionalEncoding(6, 8)
    assert float(model.position_embeddings.detach().abs().max()) == 0.0  # zero init
    model.load_state_dict(state_dict_from_flax(
        {"position_embeddings": pe}, {}), strict=True)
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=0, atol=1e-6)


def test_dense_init_is_flaxs_lecun_normal():
    gen = torch.Generator().manual_seed(0)
    layer = port_tr.dense(256, 1024, generator=gen)
    std = float(layer.weight.std())
    assert abs(std - (1 / 256) ** 0.5) < 0.02 * (1 / 256) ** 0.5
    assert float(layer.weight.abs().max()) <= 2 * (1 / 256) ** 0.5 / 0.8796 + 1e-6
    assert float(layer.bias.abs().max()) == 0.0
    assert port_tr.dense(8, 8, bias=False).bias is None


def test_training_mode_dropout_comes_from_the_generator():
    """All five dropout sites of a block draw from the explicit
    generator: the same seed gives the same output, another seed another
    one, eval mode draws nothing, and the attention dropout is live."""
    x = torch.from_numpy(_x(2, 16, 128, seed=9))
    model = port_tr.TransformerBlock(
        128, 8, 256, generator=torch.Generator().manual_seed(0)).train()
    outs = [model(x, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    with torch.no_grad():
        ev = model.eval()(x, gen)
    assert torch.equal(gen.get_state(), state)
    # only the attention-probability dropout on: still stochastic
    model.train()
    for m in model.modules():
        if isinstance(m, port_tr.Drop):
            m.rate = 0.0
    a = model(x, torch.Generator().manual_seed(4))
    assert not torch.equal(a.detach(), ev)
    model.attn.dropout_rate = 0.0
    torch.testing.assert_close(model(x).detach(), ev, atol=1e-6, rtol=0)


def test_eval_mode_with_autograd_takes_the_training_op():
    """Gradients in eval mode (no dropout) flow through the op that has a
    backward; under no_grad the forward-only op gives the same values."""
    x = torch.from_numpy(_x(2, 16, 128, seed=10)).requires_grad_(True)
    model = port_tr.SelfAttention(
        128, 8, 0.1, generator=torch.Generator().manual_seed(0)).eval()
    out = model(x)
    out.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    with torch.no_grad():
        assert torch.equal(model(x), out.detach())


def test_modality_drop_matches_jax_rules():
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal((28, 2, 3)).astype(np.float32)
          for _ in range(3)]
    txs = [torch.from_numpy(a) for a in xs]
    combos = {tuple(r) for r in jax_tr.MODALITY_COMBINATIONS.tolist()}
    out, mask = port_tr.modality_drop(txs, torch.Generator().manual_seed(0))
    assert tuple(mask.shape) == (28, 3)
    assert {tuple(r) for r in mask.tolist()} <= combos
    assert len({tuple(r) for r in mask.tolist()}) > 3
    for i in range(3):
        np.testing.assert_array_equal(
            out[i].numpy(), xs[i] * mask[:, i].numpy()[:, None, None])
    # a fixed combination applies batch-wide, as in gdl_tpu
    want, wmask = jax_tr.modality_drop([jnp.asarray(a) for a in xs],
                                       jax.random.PRNGKey(0), p=[1, 0, 1])
    got, gmask = port_tr.modality_drop(txs, None, p=[1, 0, 1])
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("epoch", [0, 14, 17, 30])
def test_unbalance_modality_drop_has_gdl_tpus_counts(epoch):
    """The curriculum's per-combination counts equal gdl_tpu's (the row
    order is a permutation drawn from each package's own generator)."""
    xs = [np.ones((64, 2), np.float32) for _ in range(3)]
    _, wmask = jax_tr.unbalance_modality_drop(
        [jnp.asarray(a) for a in xs], jax.random.PRNGKey(0), epoch)
    _, gmask = port_tr.unbalance_modality_drop(
        [torch.from_numpy(a) for a in xs], torch.Generator().manual_seed(0),
        epoch)
    assert sorted(map(tuple, gmask.tolist())) == sorted(
        map(tuple, np.asarray(wmask).tolist()))
    _, again = port_tr.unbalance_modality_drop(
        [torch.from_numpy(a) for a in xs], torch.Generator().manual_seed(1),
        epoch)
    assert not torch.equal(gmask, again)
