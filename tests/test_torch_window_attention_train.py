"""The port's training window attention op against gdl_tpu's.

`window_attention_qkv_fused` (a torch.autograd.Function) on CPU tensors
runs the plain versions of kernels #2 and #4 in its forward and
backward. Here it is held to `window_attention_pallas_qkv_fused` with
its default gates (save-p forward, phase-1 split backward), which runs
its Pallas kernels in interpret mode on the CPU, through
`jax.value_and_grad`; to autograd's numerical gradient in float64; and
in bfloat16 to its own float32 result. The CUDA kernels themselves are
held to the plain versions on the card (tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.models.swin import relative_position_index, shift_attn_mask
from gdl_tpu.ops.window_attention import window_attention_pallas_qkv_fused
from gdl_tpu_torch import kernels
from gdl_tpu_torch.ops.window_attention import (
    window_attention_qkv_fused,
    window_attention_qkv_fused_bwd,
    window_attention_qkv_fused_bwd_ref,
    window_attention_qkv_fused_fwd,
    window_attention_qkv_fused_train_ref,
)


def _inputs(bw, c, heads, window=7, shifted=False, seed=0):
    """x [Bw, N, C], flax kernel [C, 3C], bias vec [3C], rel-pos bias
    [H, N, N], mask [4, N, N] or None."""
    rng = np.random.default_rng(seed)
    n = window * window
    x = rng.standard_normal((bw, n, c)).astype(np.float32)
    kernel = (rng.standard_normal((c, 3 * c)) * c ** -0.5).astype(np.float32)
    bvec = (rng.standard_normal(3 * c) * 0.1).astype(np.float32)
    table = (rng.standard_normal(((2 * window - 1) ** 2, heads))
             * 0.5).astype(np.float32)
    idx = relative_position_index(window)
    bias = table[idx.reshape(-1)].reshape(n, n, heads).transpose(2, 0, 1)
    mask = shift_attn_mask(2 * window, 2 * window, window,
                           window // 2) if shifted else None
    return x, kernel, bvec, np.ascontiguousarray(bias), mask


def _port_value_and_grads(x, kernel, bvec, bias, mask, heads, dtype=None,
                          impl="auto"):
    """sum(sin(out)) and the grads of x, w (nn.Linear layout), b, bias."""
    dt = dtype or torch.float32
    leaves = [torch.from_numpy(a).to(dt).requires_grad_(True) for a in
              (x, np.ascontiguousarray(kernel.T), bvec)]
    bias_t = torch.from_numpy(bias).requires_grad_(True)
    mask_t = None if mask is None else torch.from_numpy(mask)
    out = window_attention_qkv_fused(*leaves, bias_t, mask_t, heads,
                                     impl=impl)
    loss = torch.sin(out.float()).sum()
    loss.backward()
    return out, loss, [t.grad for t in leaves + [bias_t]]


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_train_op_matches_pallas_entry(shifted):
    """C=128, H=4 (Swin-B stage 0 heads), Bw=8, with and without the nW=4
    shift mask: out, dx, dW, db and dbias of the port's op against
    jax.value_and_grad of the Pallas entry (interpret mode, default
    gates), rtol 5e-4 and atol 5e-5, the bar tests/test_swin.py holds
    that entry to against the XLA composition."""
    c, heads, bw, n = 128, 4, 8, 49
    x, kernel, bvec, bias, mask = _inputs(bw, c, heads, shifted=shifted,
                                          seed=11)
    n_pad = 56  # the Pallas entry takes tokens pre-padded to a multiple of 8
    xp = np.pad(x, ((0, 0), (0, n_pad - n), (0, 0)))
    jmask = None if mask is None else jnp.asarray(mask)

    def f(xp, w, bv, bias):
        o = window_attention_pallas_qkv_fused(xp, w, bv, bias, jmask, heads,
                                              n_valid=n)
        return jnp.sum(jnp.sin(o)), o

    (jloss, jout), jg = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        jnp.asarray(xp), jnp.asarray(kernel), jnp.asarray(bvec),
        jnp.asarray(bias))
    out, loss, (dx, dw, db, dbias) = _port_value_and_grads(
        x, kernel, bvec, bias, mask, heads)

    tol = dict(rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jg[0])[:, :n], **tol)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jg[1]).T, **tol)
    np.testing.assert_allclose(db.numpy(), np.asarray(jg[2]), **tol)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(jg[3]), **tol)


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_plain_backward_passes_gradcheck_in_float64(shifted):
    """The plain backward formula (attention backward from the saved p,
    then dx = dqkv·W, dW = dqkvᵀ·x, db = Σ dqkv) against autograd's
    finite differences of the plain forward, float64, Bw=4, window 2
    (N=4), C=4, H=2, with and without a 2-window shift-style mask."""
    rng = np.random.default_rng(5)
    bw, n, c, heads = 4, 4, 4, 2
    args = [torch.from_numpy(a).requires_grad_(True) for a in (
        rng.standard_normal((bw, n, c)), rng.standard_normal((3 * c, c)) * .5,
        rng.standard_normal(3 * c) * .1, rng.standard_normal((heads, n, n)))]
    mask = None
    if shifted:
        m = np.zeros((2, n, n))
        m[1, :2, 2:] = m[1, 2:, :2] = -100.0
        mask = torch.from_numpy(m)

    def f(x, w, b, bias):
        return window_attention_qkv_fused(x, w, b, bias, mask, heads)

    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-7, rtol=1e-5)


def test_bf16_rounding_points_track_f32():
    """bf16 forward and backward plain versions keep the kernels'
    rounding points (qkv, p, out and dqkv in bf16; dbias in f32) and
    agree with the f32 versions to bf16 precision: forward atol 6e-2 (out,
    qkv) and 1e-2 (p, values in [0, 1]); backward within 4e-2 of the f32
    values' max magnitude."""
    x, kernel, bvec, bias, mask = _inputs(4, 64, 2, shifted=True, seed=3)
    t = torch.from_numpy
    w = t(np.ascontiguousarray(kernel.T))
    args32 = (t(x), w, t(bvec))
    args16 = tuple(a.bfloat16() for a in args32)
    f32 = window_attention_qkv_fused_train_ref(*args32, t(bias), t(mask), 2)
    b16 = window_attention_qkv_fused_train_ref(*args16, t(bias), t(mask), 2)
    for name, got, want, atol in zip(("out", "qkv", "p"), b16, f32,
                                     (6e-2, 6e-2, 1e-2)):
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   atol=atol, err_msg=name)
    # the projection is rounded to bf16 before the bias add, then again
    want_qkv = (torch.matmul(args16[0], args16[1].t()) + args16[2])
    assert torch.equal(b16[1], want_qkv)

    dout = t(np.random.default_rng(4).standard_normal(x.shape)
             .astype(np.float32))
    g32 = window_attention_qkv_fused_bwd_ref(f32[1], f32[2], dout, 2)
    g16 = window_attention_qkv_fused_bwd_ref(b16[1], b16[2], dout.bfloat16(),
                                             2)
    assert g16[0].dtype == torch.bfloat16 and g16[1].dtype == torch.float32
    for name, got, want in zip(("dqkv", "dbias"), g16, g32):
        bound = 4e-2 * float(want.abs().max())
        err = float((got.float() - want).abs().max())
        assert err <= bound, (name, err, bound)


def test_cpu_dispatch_is_the_plain_version_and_counts_nothing():
    """On CPU tensors impl='auto' runs the plain versions (equal bits to
    impl='plain'), launches no kernel, and a bad impl raises."""
    x, kernel, bvec, bias, mask = _inputs(4, 32, 2, shifted=True, seed=2)
    before = dict(kernels.launch_counts)
    a = _port_value_and_grads(x, kernel, bvec, bias, mask, 2)
    p = _port_value_and_grads(x, kernel, bvec, bias, mask, 2, impl="plain")
    assert torch.equal(a[0], p[0])
    for ga, gp in zip(a[2], p[2]):
        assert torch.equal(ga, gp)
    t = torch.from_numpy
    fwd = window_attention_qkv_fused_fwd(
        t(x), t(np.ascontiguousarray(kernel.T)), t(bvec), t(bias), t(mask), 2)
    assert [tuple(o.shape) for o in fwd] == [(4, 49, 32), (4, 49, 96),
                                             (4, 2, 49, 49)]
    dqkv, dbias = window_attention_qkv_fused_bwd(fwd[1], fwd[2],
                                                 torch.ones_like(fwd[0]), 2)
    assert tuple(dqkv.shape) == (4, 49, 96) and tuple(dbias.shape) == (2, 49,
                                                                       49)
    assert kernels.launch_counts == before
    with pytest.raises(ValueError, match="impl"):
        window_attention_qkv_fused(t(x), t(kernel.T.copy()), t(bvec),
                                   t(bias), None, 2, impl="cuda")


def test_plain_versions_ignore_autocast():
    """Under bf16 autocast the plain versions still round where the
    kernels round: f32 operands give the f32 result bit for bit (autocast
    would otherwise run the f32 score and p·v products in bf16)."""
    x, kernel, bvec, bias, mask = _inputs(4, 32, 2, shifted=True, seed=7)
    t = torch.from_numpy
    args = (t(x), t(np.ascontiguousarray(kernel.T)), t(bvec), t(bias),
            t(mask), 2)
    want = window_attention_qkv_fused_train_ref(*args)
    dout = torch.ones_like(want[0])
    want_b = window_attention_qkv_fused_bwd_ref(want[1], want[2], dout, 2)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = window_attention_qkv_fused_train_ref(*args)
        got_b = window_attention_qkv_fused_bwd_ref(got[1], got[2], dout, 2)
    for g, w in zip(got + got_b, want + want_b):
        assert g.dtype == w.dtype and torch.equal(g, w)
