"""The port's `self_attention_qkv` (kernel #12 forward, #11 backward; their
plain versions on the CPU) and the `SA_FUSED_QKV = False` path of the
mmformer transformer against gdl_tpu's.

- The op against `gdl_tpu.ops.self_attention.self_attention_qkv` (Pallas
  in interpret mode) at test_torch_self_attention.py's CASES: forward
  2e-5, `jax.grad` 3e-4, with no dropout and on gdl_tpu's own replayed
  'hbm' mask.
- The plain version is `self_attention_fused`'s past the projection, to
  the bit in f32, so the two ops differ only in where the projection
  runs; 'kernel' mode draws equal masks in both for equal seed words.
- `SelfAttention` under the switch against gdl_tpu's module, which takes
  its `self_attention_qkv` kernel branch only on a TPU: the transformer
  module's `jax.default_backend` is made to answer "tpu" (the Pallas call
  itself still runs in interpret mode), the switch is set on both
  packages and the jit caches cleared.
- One AUXI step of a small mmformer_n under the switch against gdl_tpu's
  jitted step, at the bars of tests/test_torch_auxi_step.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_auxi_step as auxi_case
from gdl_tpu.models import transformer as jax_tr
from gdl_tpu.ops import self_attention as jax_sa
from gdl_tpu_torch import kernels
from gdl_tpu_torch.models import transformer as port_tr
from gdl_tpu_torch.ops import self_attention as port_sa
from gdl_tpu_torch.ops.dropout import fold_seed_words
from gdl_tpu_torch.utils.interop import state_dict_from_flax
from test_torch_self_attention import CASES, IDS, _replay_mask


@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _qkv(b, n, c, seed, **_):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3, c)).astype(np.float32)
    cot = rng.standard_normal((b, n, c)).astype(np.float32)
    return qkv, cot


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_qkv_op_forward_matches_pallas(case):
    qkv, _ = _qkv(seed=20, **case)
    want = jax.jit(jax_sa.self_attention_qkv, static_argnums=1)(
        jnp.asarray(qkv), case["heads"])
    before = dict(kernels.launch_counts)
    got = port_sa.self_attention_qkv(torch.from_numpy(qkv), case["heads"])
    assert kernels.launch_counts == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _grads_match(case, qkv, cot, jkw, tkw):
    heads = case["heads"]

    @jax.jit
    def run(q):
        def loss(q):
            out = jax_sa.self_attention_qkv(q, heads, **jkw)
            return jnp.sum(out * jnp.asarray(cot)), out
        return jax.value_and_grad(loss, has_aux=True)(q)

    (_, want), gq = run(jnp.asarray(qkv))
    leaf = torch.from_numpy(qkv).requires_grad_(True)
    got = port_sa.self_attention_qkv(leaf, heads, **tkw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gq), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_qkv_op_gradients_match_pallas(case):
    """jax.grad through the Pallas forward and backward kernels against
    the port's autograd Function on the [B, N, 3, C] view."""
    qkv, cot = _qkv(seed=21, **case)
    _grads_match(case, qkv, cot, {}, {})


@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_qkv_op_on_the_replayed_hbm_mask_matches_pallas(case):
    """Dropout 0.3 in 'hbm' mode: gdl_tpu's own mask draw is replayed and
    handed to the port; forward and gradients agree mask and all."""
    b, n, heads, c = (case[k] for k in ("b", "n", "heads", "c"))
    rate, rng = 0.3, jax.random.PRNGKey(11)
    qkv, cot = _qkv(seed=22, **case)
    mask = _replay_mask(rng, rate, b, n, heads, c)
    assert 0.1 < float((mask == 0).mean()) < 0.5
    _grads_match(case, qkv, cot,
                 dict(dropout_rate=rate, dropout_rng=rng, train=True,
                      dropout_impl="hbm"),
                 dict(dropout_rate=rate, train=True, dropout_impl="hbm",
                      mask=torch.from_numpy(np.array(mask))))


@pytest.mark.parametrize("mode", ["none", "hbm", "kernel"])
def test_plain_version_is_the_fused_ops_past_the_projection(mode):
    """In f32 the plain forward on x·Wᵀ gives self_attention_fused's out
    and p to the bit, and the whole ops give equal outputs and the same
    dqkv chain: the fused op's dx = dqkv·W with dqkv from the qkv op. In
    'kernel' mode both draw the same mask from the same seed words."""
    x, kernel, cot = (np.random.default_rng(23).standard_normal(s).astype(
        np.float32) for s in ((2, 20, 128), (128, 384), (2, 20, 128)))
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(np.ascontiguousarray(kernel.T)) * 128 ** -0.5
    words = fold_seed_words(torch.Generator().manual_seed(4), "cpu")
    drop = port_sa.make_dropout(xt, 4, 0.3, mode != "none",
                                "kernel" if mode == "none" else mode,
                                seed_words=words)
    out, qkv, p = port_sa.self_attention_fused_train_ref(xt, wt, 4,
                                                         drop=drop)
    out2, p2 = port_sa.self_attention_qkv_train_ref(qkv, 4, drop=drop)
    assert torch.equal(out, out2) and torch.equal(p, p2)

    kw = dict(dropout_rate=0.3, seed_words=words, train=mode != "none",
              dropout_impl="kernel" if mode == "none" else mode,
              mask=drop.mask)
    xl = xt.clone().requires_grad_(True)
    fused = port_sa.self_attention_fused(xl, wt, 4, **kw)
    fused.backward(torch.from_numpy(cot))
    ql = qkv.clone().requires_grad_(True)
    split = port_sa.self_attention_qkv(ql, 4, **kw)
    split.backward(torch.from_numpy(cot))
    assert torch.equal(fused.detach(), split.detach())
    assert torch.equal(xl.grad, ql.grad @ wt)


def test_plain_op_passes_gradcheck_in_float64():
    """The qkv op's backward is the derivative of its forward, with a
    'kernel'-mode mask the backward draws again."""
    gen = torch.Generator().manual_seed(3)
    words = fold_seed_words(gen, "cpu")
    qkv = torch.randn(2, 5, 48, dtype=torch.float64, generator=gen,
                      requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q: port_sa.self_attention_qkv(
            q, 2, dropout_rate=0.3, seed_words=words, train=True), (qkv,))
    with pytest.raises(ValueError, match=r"\[B, N, 3, C\]"):
        port_sa.self_attention_qkv(torch.zeros(2, 5, 2, 16), 2)


def _tpu_branch(monkeypatch, fused_qkv):
    """gdl_tpu's transformer module takes its kernel branches (its
    `jax.default_backend()` answers "tpu"; the ops still interpret), with
    SA_FUSED_QKV set on both packages."""
    proxy = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                     if not k.startswith("__")})
    proxy.default_backend = lambda: "tpu"
    monkeypatch.setattr(jax_tr, "jax", proxy)
    monkeypatch.setattr(jax_tr, "SA_FUSED_QKV", fused_qkv)
    monkeypatch.setattr(port_tr, "SA_FUSED_QKV", fused_qkv)
    jax.clear_caches()


def test_self_attention_module_under_the_switch_matches_gdl_tpu(monkeypatch):
    """SelfAttention(128, 8) in training mode, no dropout: gdl_tpu's
    `jnp.dot` + `self_attention_qkv` branch against the port's
    `self.qkv` + `self_attention_qkv`: output 2e-4, every parameter's
    gradient within test_torch_transformer.py's bars; the port's op is
    called and its fused op is not."""
    _tpu_branch(monkeypatch, False)
    calls = []
    for name in ("self_attention_qkv", "self_attention_fused"):
        fn = getattr(port_tr, name)
        monkeypatch.setattr(port_tr, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    cot = rng.standard_normal((2, 16, 128)).astype(np.float32)
    jmodel = jax_tr.SelfAttention(128, 8, 0.0)
    model = port_tr.SelfAttention(128, 8, 0.0).train()
    k = jax.random.PRNGKey(0)
    variables = jax.jit(lambda x: jmodel.init({"params": k}, x))(
        jnp.asarray(x))
    params = jax.device_get(variables["params"])
    params["proj"]["bias"] = np.asarray(params["proj"]["bias"]) + 0.1
    model.load_state_dict(state_dict_from_flax(params, {}), strict=True)

    @jax.jit
    def run(params):
        def loss(params):
            out = jmodel.apply({"params": params}, jnp.asarray(x),
                               train=True)
            return jnp.sum(out * jnp.asarray(cot)), out
        return jax.value_and_grad(loss, has_aux=True)(params)

    (_, want), grads = run(params)
    got = model(torch.from_numpy(x))
    assert calls == ["self_attention_qkv"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-4)
    got.backward(torch.from_numpy(cot))
    want_grads = state_dict_from_flax(jax.tree.map(np.asarray, grads), {})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=1e-3, atol=2e-3, err_msg=name)
    # eval does not read the switch: the forward-only fused op
    calls.clear()
    with torch.no_grad():
        model.eval()(torch.from_numpy(x))
    assert calls == []


def test_auxi_step_under_the_switch_matches_jax_step(monkeypatch):
    """One AUXI step of mmformer_n (width 8, embed 128, 16 tokens, batch
    4, shared streams) with SA_FUSED_QKV = False on both packages and
    gdl_tpu in its kernel branch: metrics rtol 2e-4, parameters and BN
    statistics 2e-5 (tests/test_torch_auxi_step.py's bars). The attention
    dropout of gdl_tpu's op is set to 0, as the port's rates are."""
    _tpu_branch(monkeypatch, False)
    sa_qkv = jax_sa.self_attention_qkv
    monkeypatch.setattr(jax_sa, "self_attention_qkv",
                        lambda qkv, heads, **kw: sa_qkv(
                            qkv, heads, **dict(kw, dropout_rate=0.0,
                                               dropout_rng=None)))
    used = []
    fn = port_tr.self_attention_qkv
    monkeypatch.setattr(port_tr, "self_attention_qkv",
                        lambda *a, **k: used.append(1) or fn(*a, **k))
    jstep, state, model, step = auxi_case._setup(
        "mmformer_n", monkeypatch, share_streams=True)
    batch = auxi_case._batches(1, seed=1)[0]
    state, jm = jstep(state, {n: jnp.asarray(v) for n, v in batch.items()})
    m = step({n: torch.from_numpy(v) for n, v in batch.items()})
    assert len(used) == 7  # 4 intra-modal blocks, 3 fused ones
    for key in auxi_case.METRICS:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-4,
                                   atol=1e-6, err_msg=key)
    auxi_case._assert_state(model, state, 2e-5, "step 0")
