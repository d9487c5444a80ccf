"""The port's window attention on a qkv computed outside, and the two
backward switches, against gdl_tpu's.

`window_attention_qkv` (a torch.autograd.Function) on CPU tensors runs
the plain versions of kernels #5 and #4 (or #4-delta under `BWD_DELTA`).
Here it is held to `window_attention_pallas_qkv(save_p=True,
transposed=True)`, and `window_attention_qkv_fused` under
`FUSED_PROJECTION_BACKWARD` (the plain version of kernel #3) to
`window_attention_pallas_qkv_fused` with the same gate, both through
`jax.value_and_grad` with the Pallas kernels in interpret mode; the
switches are set on both packages (gdl_tpu reads its gates when it
traces, so its jit caches are cleared). The new plain backwards are also
held to autograd's numerical gradient in float64 and, in bfloat16, to
their float32 results. The CUDA kernels themselves are held to the plain
versions on the card (tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdl_tpu.ops.window_attention as jwa
from gdl_tpu.models.swin import relative_position_index, shift_attn_mask
from gdl_tpu_torch import kernels
from gdl_tpu_torch.ops import window_attention as wa


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _set_switches(monkeypatch, bwd_delta=False, fused=False):
    """The same gate values on both packages."""
    monkeypatch.setattr(jwa, "BWD_DELTA", bwd_delta)
    monkeypatch.setattr(jwa, "FUSED_PROJECTION_BACKWARD", fused)
    monkeypatch.setattr(wa, "BWD_DELTA", bwd_delta)
    monkeypatch.setattr(wa, "FUSED_PROJECTION_BACKWARD", fused)
    jax.clear_caches()


def _bias_mask(heads, window, shifted, rng):
    n = window * window
    table = (rng.standard_normal(((2 * window - 1) ** 2, heads))
             * 0.5).astype(np.float32)
    idx = relative_position_index(window)
    bias = table[idx.reshape(-1)].reshape(n, n, heads).transpose(2, 0, 1)
    mask = shift_attn_mask(2 * window, 2 * window, window,
                           window // 2) if shifted else None
    return np.ascontiguousarray(bias), mask


def _grad_close(got, want, frac, name):
    """Largest error within `frac` of the reference's largest |value|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= frac * ref, (name, err, ref)


@pytest.mark.parametrize("bwd_delta", [False, True],
                         ids=["rowsum", "delta"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_qkv_op_matches_pallas_entry(shifted, bwd_delta, monkeypatch):
    """C=128, H=4, Bw=8, N=49, with and without the nW=4 shift mask and
    BWD_DELTA off and on: out within 2e-5, dqkv and dbias within 3e-4 of
    their largest value, against jax.value_and_grad of the Pallas entry
    (interpret mode; it pads 49 -> 56 tokens itself, the port does not)."""
    _set_switches(monkeypatch, bwd_delta=bwd_delta)
    c, heads, bw, n = 128, 4, 8, 49
    rng = np.random.default_rng(21 + shifted)
    qkv = rng.standard_normal((bw, n, 3, c)).astype(np.float32)
    bias, mask = _bias_mask(heads, 7, shifted, rng)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(qkv, bias):
        o = jwa.window_attention_pallas_qkv(qkv, bias, jmask, heads,
                                            save_p=True, transposed=True)
        return jnp.sum(jnp.sin(o)), o

    (_, jout), jg = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(bias))

    tq = torch.from_numpy(qkv).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    tm = None if mask is None else torch.from_numpy(mask)
    before = dict(kernels.launch_counts)
    out = wa.window_attention_qkv(tq, tb, tm, heads)
    torch.sin(out).sum().backward()
    assert kernels.launch_counts == before  # CPU: the plain versions
    assert tuple(out.shape) == (bw, n, c)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    assert tq.grad.shape == tq.shape
    _grad_close(tq.grad, jg[0], 3e-4, "dqkv")
    _grad_close(tb.grad, jg[1], 3e-4, "dbias")
    # the [Bw, N, 3C] form of the same tensor gives the same bits
    t2 = torch.from_numpy(qkv.reshape(bw, n, 3 * c))
    assert torch.equal(wa.window_attention_qkv(t2, tb.detach(), tm, heads),
                       out.detach())


@pytest.mark.parametrize("fused", [True, "auto"], ids=["on", "auto"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_fused_projection_backward_matches_pallas_entry(shifted, fused,
                                                        monkeypatch):
    """FUSED_PROJECTION_BACKWARD True and "auto" on both sides, C=128,
    H=4, Bw=8: out within 2e-5; dx, dW, db and dbias within 3e-4 of their
    largest value against the Pallas entry's fused backward kernel."""
    _set_switches(monkeypatch, fused=fused)
    c, heads, bw, n, n_pad = 128, 4, 8, 49, 56
    rng = np.random.default_rng(31 + shifted)
    x = rng.standard_normal((bw, n, c)).astype(np.float32)
    kernel = (rng.standard_normal((c, 3 * c)) * c ** -0.5).astype(np.float32)
    bvec = (rng.standard_normal(3 * c) * 0.1).astype(np.float32)
    bias, mask = _bias_mask(heads, 7, shifted, rng)
    jmask = None if mask is None else jnp.asarray(mask)
    xp = np.pad(x, ((0, 0), (0, n_pad - n), (0, 0)))

    def f(xp, w, bv, bias):
        o = jwa.window_attention_pallas_qkv_fused(xp, w, bv, bias, jmask,
                                                  heads, n_valid=n)
        return jnp.sum(jnp.sin(o)), o

    (_, jout), jg = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        jnp.asarray(xp), jnp.asarray(kernel), jnp.asarray(bvec),
        jnp.asarray(bias))

    assert wa.fused_bwd_supported(n, c, heads, torch.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in
              (x, np.ascontiguousarray(kernel.T), bvec, bias)]
    tm = None if mask is None else torch.from_numpy(mask)
    out = wa.window_attention_qkv_fused(*leaves, tm, heads)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    dx, dw, db, dbias = (t.grad for t in leaves)
    _grad_close(dx, np.asarray(jg[0])[:, :n], 3e-4, "dx")
    _grad_close(dw, np.asarray(jg[1]).T, 3e-4, "dW")
    _grad_close(db, jg[2], 3e-4, "db")
    _grad_close(dbias, jg[3], 3e-4, "dbias")


@pytest.mark.parametrize("bwd_delta,fused", [(True, False), (False, True),
                                             (True, True)],
                         ids=["delta", "fused", "both"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_switched_plain_backwards_pass_gradcheck_in_float64(
        shifted, bwd_delta, fused, monkeypatch):
    """The plain backwards under the switches (delta given instead of the
    row sum; kernel #3's plain version) against autograd's finite
    differences of the plain forwards, float64, Bw=4, N=4, C=4, H=2, for
    both ops."""
    monkeypatch.setattr(wa, "BWD_DELTA", bwd_delta)
    monkeypatch.setattr(wa, "FUSED_PROJECTION_BACKWARD", fused)
    rng = np.random.default_rng(5)
    bw, n, c, heads = 4, 4, 4, 2
    t = lambda a: torch.from_numpy(a).requires_grad_(True)  # noqa: E731
    x, w, b, bias, qkv = (
        t(rng.standard_normal((bw, n, c))),
        t(rng.standard_normal((3 * c, c)) * .5),
        t(rng.standard_normal(3 * c) * .1),
        t(rng.standard_normal((heads, n, n))),
        t(rng.standard_normal((bw, n, 3 * c))))
    mask = None
    if shifted:
        m = np.zeros((2, n, n))
        m[1, :2, 2:] = m[1, 2:, :2] = -100.0
        mask = torch.from_numpy(m)
    tol = dict(eps=1e-6, atol=1e-7, rtol=1e-5)
    assert torch.autograd.gradcheck(
        lambda *a: wa.window_attention_qkv_fused(*a, mask, heads),
        (x, w, b, bias), **tol)
    assert torch.autograd.gradcheck(
        lambda q, bi: wa.window_attention_qkv(q, bi, mask, heads),
        (qkv, bias), **tol)


def test_delta_is_the_softmax_row_sum():
    """attention_delta(out, dout) equals Σ_k dp·p of the plain backward
    (f32, 1e-5 of its largest value), has shape [Bw, H, N] in f32, and the
    backward given it agrees with the default one."""
    rng = np.random.default_rng(8)
    bw, n, c, heads = 4, 49, 64, 2
    qkv = torch.from_numpy(rng.standard_normal((bw, n, 3 * c))
                           .astype(np.float32))
    bias, mask = _bias_mask(heads, 7, True, rng)
    out, p = wa.window_attention_qkv_train_ref(
        qkv, torch.from_numpy(bias), torch.from_numpy(mask), heads)
    dout = torch.from_numpy(rng.standard_normal((bw, n, c))
                            .astype(np.float32))
    delta = wa.attention_delta(out, dout, heads)
    assert delta.dtype == torch.float32 and tuple(delta.shape) == (bw, heads,
                                                                   n)
    v = qkv.reshape(bw, n, 3, heads, c // heads)[:, :, 2]
    dp = torch.einsum("bihd,bjhd->bhij",
                      dout.reshape(bw, n, heads, c // heads), v)
    want = (dp * p).sum(-1)
    _grad_close(delta, want, 1e-5, "delta")
    a = wa.window_attention_qkv_fused_bwd_ref(qkv, p, dout, heads)
    d = wa.window_attention_qkv_fused_bwd_ref(qkv, p, dout, heads,
                                              delta=delta)
    for name, g, w_ in zip(("dqkv", "dbias"), d, a):
        _grad_close(g, w_, 1e-5, name)


def test_bf16_rounding_points_track_f32():
    """bf16 plain versions of kernels #5, #4-delta and #3 keep the
    kernels' rounding points (p, out, dqkv, dx, dW and db in bf16; delta
    and dbias in f32) and agree with their f32 versions to bf16
    precision: out atol 6e-2, p 1e-2; gradients within 4e-2 of the f32
    values' largest magnitude."""
    rng = np.random.default_rng(3)
    bw, n, c, heads = 4, 49, 64, 2
    t = torch.from_numpy
    x = t(rng.standard_normal((bw, n, c)).astype(np.float32))
    w = t((rng.standard_normal((3 * c, c)) * c ** -0.5).astype(np.float32))
    qkv = t(rng.standard_normal((bw, n, 3 * c)).astype(np.float32))
    bias, mask = (t(a) for a in _bias_mask(heads, 7, True, rng))
    dout = t(rng.standard_normal((bw, n, c)).astype(np.float32))
    f32 = wa.window_attention_qkv_train_ref(qkv, bias, mask, heads)
    b16 = wa.window_attention_qkv_train_ref(qkv.bfloat16(), bias, mask, heads)
    for name, got, want, atol in zip(("out", "p"), b16, f32, (6e-2, 1e-2)):
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   atol=atol, err_msg=name)
    d32 = wa.attention_delta(f32[0], dout, heads)
    d16 = wa.attention_delta(b16[0], dout.bfloat16(), heads)
    assert d16.dtype == torch.float32
    g32 = wa.window_attention_qkv_fused_bwd_ref(qkv, f32[1], dout, heads,
                                                delta=d32)
    g16 = wa.window_attention_qkv_fused_bwd_ref(
        qkv.bfloat16(), b16[1], dout.bfloat16(), heads, delta=d16)
    assert g16[0].dtype == torch.bfloat16 and g16[1].dtype == torch.float32
    for name, got, want in zip(("dqkv", "dbias"), g16, g32):
        _grad_close(got.float(), want, 4e-2, "delta " + name)
    h32 = wa.window_attention_qkv_fused_bwd_fused_ref(qkv, f32[1], dout, x, w,
                                                      heads)
    h16 = wa.window_attention_qkv_fused_bwd_fused_ref(
        qkv.bfloat16(), b16[1], dout.bfloat16(), x.bfloat16(), w.bfloat16(),
        heads)
    assert [g.dtype for g in h16] == [torch.bfloat16] * 3 + [torch.float32]
    for name, got, want in zip(("dx", "dW", "db", "dbias"), h16, h32):
        _grad_close(got.float(), want, 4e-2, "fused " + name)


def test_cpu_dispatch_is_the_plain_version_and_counts_nothing(monkeypatch):
    """On CPU tensors impl='auto' gives the bits of impl='plain' under
    every switch setting, launches no kernel, and a bad impl or switch
    value raises."""
    rng = np.random.default_rng(2)
    bw, n, c, heads = 4, 49, 32, 2
    qkv = rng.standard_normal((bw, n, 3 * c)).astype(np.float32)
    x = rng.standard_normal((bw, n, c)).astype(np.float32)
    w = (rng.standard_normal((3 * c, c)) * c ** -0.5).astype(np.float32)
    b = (rng.standard_normal(3 * c) * 0.1).astype(np.float32)
    bias, mask = _bias_mask(heads, 7, True, rng)
    tm = torch.from_numpy(mask)
    before = dict(kernels.launch_counts)

    def run(op, arrays, impl):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        out = op(*leaves, tm, heads, impl=impl)
        torch.sin(out).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    for bwd_delta, fused in ((False, False), (True, False), (False, True),
                             (True, "auto")):
        monkeypatch.setattr(wa, "BWD_DELTA", bwd_delta)
        monkeypatch.setattr(wa, "FUSED_PROJECTION_BACKWARD", fused)
        for op, arrays in ((wa.window_attention_qkv, (qkv, bias)),
                           (wa.window_attention_qkv_fused, (x, w, b, bias))):
            for a, p in zip(run(op, arrays, "auto"),
                            run(op, arrays, "plain")):
                assert torch.equal(a, p)
    assert kernels.launch_counts == before
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    with pytest.raises(ValueError, match="impl"):
        wa.window_attention_qkv(tq, tb, None, heads, impl="cuda")
    monkeypatch.setattr(wa, "FUSED_PROJECTION_BACKWARD", "always")
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w, b, bias)]
    out = wa.window_attention_qkv_fused(*leaves, None, heads)
    with pytest.raises(ValueError, match="FUSED_PROJECTION_BACKWARD"):
        out.sum().backward()


def test_fused_backward_rules_are_functions_of_the_shape():
    """fused_bwd_supported holds at the four Swin-B stages and fails past
    the kernels' token and head-dim limits. Kernel #3's attention stage
    takes #4's runs of windows and its dW product a K split, both
    functions of the shape alone: at the batch-32 stage shapes the split
    keeps the dW partials under 20 MiB, and at stages 0-2 (whose [3C, C]
    grids of 128 x 128 tiles are under a wave) it fills at least one wave
    of the H100's 132 SMs."""
    kcs = []
    for bw, c, heads in ((2048, 128, 4), (512, 256, 8), (128, 512, 16),
                         (32, 1024, 32)):
        assert wa.fused_bwd_supported(49, c, heads, torch.float32)
        assert wa.fused_bwd_supported(49, c, heads, torch.bfloat16)
        wpb = wa._bwd_windows_per_block(bw, heads)
        runs = -(-bw // wpb)
        assert runs * wpb >= bw and (runs - 1) * wpb < bw
        assert runs * heads >= 132  # stage A's blocks fill a wave too
        tokens = bw * 49
        kc = wa._fused_bwd_split(tokens, c)
        splits = -(-tokens // kc)
        assert kc == tokens or kc % 64 == 0  # the tile's aligned rows
        assert (splits - 1) * kc < tokens  # no empty partial
        assert splits * 3 * c * c * 4 <= 20 * 2 ** 20  # bytes of partials
        tiles = -(-3 * c // 128) * -(-c // 128)
        if c <= 512:
            assert tiles < 132 <= tiles * splits
        else:
            assert splits == 1
        kcs.append(kc)
    assert kcs == [1152, 1152, 1088, 1568]
    assert wa._fused_bwd_split(3 * 49, 64) == 3 * 49  # one short partial
    assert not wa.fused_bwd_supported(65, 128, 4, torch.float32)
    assert not wa.fused_bwd_supported(49, 256, 2, torch.float32)
    assert not wa.fused_bwd_supported(49, 128, 4, torch.float64)
