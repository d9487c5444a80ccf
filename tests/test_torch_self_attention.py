"""The port's fused self-attention op (`gdl_tpu_torch/ops/
self_attention.py`, its plain PyTorch version on the CPU) against
gdl_tpu's Pallas kernels in interpret mode: `self_attention_fused`
(forward and gradients, with and without attention-probability dropout
fed the same mask) and `self_attention_fused_eval`.

Tolerances are those of gdl_tpu's own tests/test_self_attention_kernel.py:
forward rtol = atol = 2e-5, gradients 3e-4 (f32 on the CPU, sums in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.ops import self_attention as jax_sa
from gdl_tpu_torch.ops import self_attention as port_sa
from gdl_tpu_torch.ops.dropout import fold_seed_words, philox_keep_mask

# gdl_tpu's CASES (tests/test_self_attention_kernel.py:20-25): head dims
# 32, 64 (the mmformer shape at 8 heads, C = 512) and 128, an odd N
CASES = [
    dict(b=4, n=20, heads=4, c=128),
    dict(b=2, n=52, heads=8, c=512),
    dict(b=3, n=9, heads=2, c=256),
    dict(b=2, n=16, heads=4, c=128),
]
IDS = ["d32", "mmformer", "oddN_d128", "n16"]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b, n, c, seed=0, **_):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    kernel = (rng.standard_normal((c, 3 * c)) * c ** -0.5).astype(np.float32)
    cot = rng.standard_normal((b, n, c)).astype(np.float32)
    return x, kernel, cot


def _port_args(x, kernel, grad=False):
    xt = torch.from_numpy(x).requires_grad_(grad)
    wt = torch.from_numpy(np.ascontiguousarray(kernel.T)).requires_grad_(grad)
    return xt, wt


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_pallas(case):
    x, kernel, _ = _inputs(**case)
    want = jax_sa.self_attention_fused(jnp.asarray(x), jnp.asarray(kernel),
                                       case["heads"])
    xt, wt = _port_args(x, kernel)
    got = port_sa.self_attention_fused(xt, wt, case["heads"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_eval_op_matches_pallas(case):
    x, kernel, _ = _inputs(seed=1, **case)
    want = jax_sa.self_attention_fused_eval(
        jnp.asarray(x), jnp.asarray(kernel), case["heads"])
    xt, wt = _port_args(x, kernel)
    with torch.no_grad():
        got = port_sa.self_attention_fused_eval(xt, wt, case["heads"])
        same = port_sa.self_attention_fused(xt, wt, case["heads"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert torch.equal(got, same)  # the training forward without dropout


@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_gradients_match_pallas(case):
    """jax.grad through the Pallas forward and backward kernels against
    the port's autograd Function (plain backward, then dx and dW)."""
    x, kernel, cot = _inputs(seed=2, **case)

    def loss(xj, kj):
        return jnp.sum(jax_sa.self_attention_fused(xj, kj, case["heads"])
                       * jnp.asarray(cot))

    gx, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                            jnp.asarray(kernel))
    xt, wt = _port_args(x, kernel, grad=True)
    port_sa.self_attention_fused(xt, wt, case["heads"]).backward(
        torch.from_numpy(cot))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(gk), rtol=3e-4,
                               atol=3e-4)


def _replay_mask(rng, rate, b, n, heads, c):
    """gdl_tpu's 'hbm' mask draw (`_dropout_setup`), unpacked from the
    packed [hg, B, g*Np, Np] layout to [B, H, N, N] as
    tests/test_self_attention_kernel.py::_mask_bhnn does."""
    d = c // heads
    g = jax_sa._pick_g(heads, d)
    hg = heads // g
    n_pad = jax_sa._round_up(n, 8)
    keep = jax.random.bernoulli(rng, 1.0 - rate, (hg, b, g * n_pad, n_pad))
    maskp = keep.astype(jnp.float32) * jnp.asarray(1.0 / (1.0 - rate),
                                                   jnp.float32)
    m = maskp.reshape(hg, b, g, n_pad, n_pad).transpose(1, 0, 2, 3, 4)
    return np.asarray(m.reshape(b, heads, n_pad, n_pad)[:, :, :n, :n])


@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_dropout_forward_and_gradients_match_pallas_on_the_same_mask(case):
    """Dropout 0.3 in 'hbm' mode: gdl_tpu's own mask draw is replayed and
    handed to the port, so forward and gradients must agree mask and all."""
    b, n, heads, c = (case[k] for k in ("b", "n", "heads", "c"))
    rate = 0.3
    x, kernel, cot = _inputs(seed=3, **case)
    rng = jax.random.PRNGKey(7)
    mask = _replay_mask(rng, rate, b, n, heads, c)
    assert 0.1 < float((mask == 0).mean()) < 0.5  # it really drops
    kw = dict(dropout_rate=rate, dropout_rng=rng, train=True,
              dropout_impl="hbm")

    def loss(xj, kj):
        return jnp.sum(jax_sa.self_attention_fused(xj, kj, heads, **kw)
                       * jnp.asarray(cot))

    want = jax_sa.self_attention_fused(jnp.asarray(x), jnp.asarray(kernel),
                                       heads, **kw)
    gx, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                            jnp.asarray(kernel))
    xt, wt = _port_args(x, kernel, grad=True)
    got = port_sa.self_attention_fused(
        xt, wt, heads, dropout_rate=rate, train=True, dropout_impl="hbm",
        mask=torch.from_numpy(np.array(mask)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(gk), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("dropout_impl", ["kernel", "hbm"])
def test_plain_op_passes_gradcheck_in_float64(dropout_impl):
    """The hand-written backward (attention backward, dx, dW) is the
    derivative of the forward, with a dropout mask that the backward
    draws again from the same seed words."""
    gen = torch.Generator().manual_seed(0)
    words = fold_seed_words(gen, "cpu")
    x = torch.randn(2, 5, 16, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = (torch.randn(48, 16, dtype=torch.float64, generator=gen)
         * 0.4).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: port_sa.self_attention_fused(
            a, b, 2, dropout_rate=0.3, seed_words=words, train=True,
            dropout_impl=dropout_impl), (x, w))


def test_kernel_mode_dropout_redraws_the_forward_mask_in_the_backward():
    """'kernel' mode keeps no mask: the backward derives it again from
    the seed words. Its gradients equal those of 'hbm' mode given that
    mask explicitly; other seed words give another mask."""
    gen = torch.Generator().manual_seed(1)
    words = fold_seed_words(gen, "cpu")
    x, kernel, cot = _inputs(2, 20, 128, seed=4)
    rate = 0.3
    keep = philox_keep_mask(words, (2, 4, 20, 20), rate)
    mask = keep.float() * torch.tensor(1.0 / (1.0 - rate))
    grads = []
    for kw in (dict(dropout_impl="kernel", seed_words=words),
               dict(dropout_impl="hbm", mask=mask)):
        xt, wt = _port_args(x, kernel, grad=True)
        out = port_sa.self_attention_fused(xt, wt, 4, dropout_rate=rate,
                                           train=True, **kw)
        out.backward(torch.from_numpy(cot))
        grads.append((out.detach(), xt.grad, wt.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    xt, wt = _port_args(x, kernel)
    other = port_sa.self_attention_fused(
        xt, wt, 4, dropout_rate=rate, train=True,
        seed_words=fold_seed_words(gen, "cpu"))
    assert not torch.equal(other, grads[0][0])
    # train=False or rate 0: no dropout, no seed words needed
    plain = port_sa.self_attention_fused(xt, wt, 4, dropout_rate=rate)
    assert torch.equal(plain, port_sa.self_attention_fused(xt, wt, 4,
                                                           train=True))
    with pytest.raises(ValueError, match="needs seed_words"):
        port_sa.self_attention_fused(xt, wt, 4, dropout_rate=rate, train=True)


def test_eval_op_refuses_autograd():
    x, kernel, _ = _inputs(2, 9, 64)
    xt, wt = _port_args(x, kernel, grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        port_sa.self_attention_fused_eval(xt, wt, 4)
    with torch.no_grad():
        port_sa.self_attention_fused_eval(xt, wt, 4)


def test_impl_argument():
    x, kernel, _ = _inputs(2, 9, 64)
    xt, wt = _port_args(x, kernel)
    with pytest.raises(ValueError, match="impl must be"):
        port_sa.self_attention_fused(xt, wt, 4, impl="fast")
    with pytest.raises(ValueError, match="needs CUDA"):
        port_sa.self_attention_fused(xt, wt, 4, impl="kernel")
    assert torch.equal(port_sa.self_attention_fused(xt, wt, 4, impl="plain"),
                       port_sa.self_attention_fused(xt, wt, 4))


def test_bfloat16_rounding_points():
    """In bf16 the plain version rounds where the kernels round: qkv and
    p are stored in bf16, the scores and the softmax run in f32 on the
    rounded q·scale and k, p·m is rounded before p·v."""
    x, kernel, _ = _inputs(2, 20, 128, seed=5)
    xt, wt = (t.to(torch.bfloat16) for t in _port_args(x, kernel))
    heads, d = 4, 32
    gen = torch.Generator().manual_seed(2)
    drop = port_sa.make_dropout(xt, heads, 0.3, True, "kernel",
                                fold_seed_words(gen, "cpu"))
    out, qkv, p = port_sa.self_attention_fused_train_ref(xt, wt, heads,
                                                         drop=drop)
    assert out.dtype == qkv.dtype == p.dtype == torch.bfloat16
    want_qkv = (xt.float() @ wt.float().t()).to(torch.bfloat16)
    assert torch.equal(qkv, want_qkv)
    q5 = qkv.reshape(2, 20, 3, heads, d)
    scale_t = torch.tensor(d ** -0.5, dtype=torch.bfloat16)
    q = (q5[:, :, 0] * scale_t).float()
    s = torch.einsum("bnhd,bmhd->bhnm", q, q5[:, :, 1].float())
    pf = torch.softmax(s, dim=-1)
    assert torch.equal(p, pf.to(torch.bfloat16))
    m = drop.multiplier(pf.shape, torch.float32)
    pd = (pf * m).to(torch.bfloat16).float()
    want = torch.einsum("bhnm,bmhd->bnhd", pd, q5[:, :, 2].float())
    assert torch.equal(out, want.to(torch.bfloat16).reshape(2, 20, 128))
    # the backward reads the rounded p and rounds ds before its products
    dout = torch.randn(2, 20, 128, generator=gen).to(torch.bfloat16)
    dqkv = port_sa.self_attention_fused_bwd_ref(qkv, p, dout, heads,
                                                drop=drop)
    assert dqkv.dtype == torch.bfloat16 and bool(torch.isfinite(dqkv).all())


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 6, 8, 12, 16])
def test_sa_kernel_supported_equals_gdl_tpu(heads):
    for dim in (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024):
        assert (port_sa.sa_kernel_supported(dim, heads)
                == jax_sa.sa_kernel_supported(dim, heads)), (dim, heads)
    assert port_sa.sa_kernel_supported(512, 8)
    assert not port_sa.sa_kernel_supported(64, 8)
    assert not port_sa.sa_kernel_supported(512, 0)
