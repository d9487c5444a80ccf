"""The port's other window-attention variants against gdl_tpu's.

- `window_attention_qkv(save_p, transposed)` at the three argument
  combinations the default does not take: (False, False) and (False,
  True), both kernel #7 (the backward that computes the scores again),
  and (True, False), kernel #6 (the row score layout), each against
  `window_attention_pallas_qkv` with the same arguments through
  `jax.value_and_grad` (Pallas in interpret mode), and unchanged by
  `BWD_DELTA`, which gdl_tpu's two variants ignore.
- `window_attention_bhnd` (kernel #8), `window_attention_packed` (kernel
  #9) and the `window_attention` dispatcher on q, k, v [B, H, N, D]
  against `window_attention_pallas`, `window_attention_pallas_packed` and
  `window_attention_xla`.

On the CPU the ops run their plain versions; tests/test_torch_kernels_cuda.py
holds the CUDA kernels to those on the card. Tolerances: forward atol
2e-5 (test_swin.py's 2e-5 and rtol 2e-4, tightened), gradients those of
test_swin.py (rtol 5e-4, atol 5e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdl_tpu.ops.window_attention as jwa
from gdl_tpu.models.swin import shift_attn_mask
from gdl_tpu_torch import kernels
from gdl_tpu_torch.ops import window_attention as wa

# tests/test_swin.py:235's cases (heads, windows, masked), d = 32
GRAD_CASES = [(4, 8, True), (8, 8, False)]
# tests/test_swin.py:191's cases
FWD_CASES = [(4, 8, True), (8, 8, False), (32, 4, True)]
VARIANTS = [(False, False), (False, True), (True, False)]
VARIANT_IDS = ["recompute_rows", "recompute_t", "savep_rows"]
N, D = 49, 32


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _set_bwd_delta(monkeypatch, on):
    monkeypatch.setattr(jwa, "BWD_DELTA", on)
    monkeypatch.setattr(wa, "BWD_DELTA", on)
    jax.clear_caches()


def _qkv_case(h, b, use_mask, seed):
    """qkv [B, N, 3, C], bias [H, N, N], mask [4, N, N] or None (numpy)."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, N, 3, h * D)).astype(np.float32)
    bias = (rng.standard_normal((h, N, N)) * 0.1).astype(np.float32)
    mask = shift_attn_mask(14, 14, 7, 3)[:4] if use_mask else None
    return qkv, bias, mask


def _jax_value_and_grad(qkv, bias, mask, h, save_p, transposed):
    jmask = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def run(qkv, bias):
        def f(qkv, bias):
            o = jwa.window_attention_pallas_qkv(qkv, bias, jmask, h,
                                                save_p=save_p,
                                                transposed=transposed)
            return jnp.sum(jnp.sin(o)), o
        return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(qkv, bias)

    (_, out), grads = run(jnp.asarray(qkv), jnp.asarray(bias))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(qkv, bias, mask, h, **kw):
    tq = torch.from_numpy(qkv).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    tm = None if mask is None else torch.from_numpy(mask)
    out = wa.window_attention_qkv(tq, tb, tm, h, **kw)
    torch.sin(out).sum().backward()
    return out.detach(), tq.grad, tb.grad


def _assert_matches(port, jout, jgrads, what):
    out, dq, db = port
    np.testing.assert_allclose(out.numpy(), jout, atol=2e-5, rtol=0,
                               err_msg=f"{what} out")
    for name, g, w in (("dqkv", dq, jgrads[0]), ("dbias", db, jgrads[1])):
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-4, atol=5e-5,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", GRAD_CASES, ids=["h4_masked", "h8"])
@pytest.mark.parametrize("save_p,transposed", VARIANTS, ids=VARIANT_IDS)
def test_qkv_variant_matches_pallas_entry(save_p, transposed, case):
    """Forward and jax.grad (dqkv, dbias) of the Pallas entry with the
    same (save_p, transposed), which pads 49 -> 56 tokens itself; the
    port takes the 49 as they are. Nothing is launched on the CPU."""
    h, b, use_mask = case
    qkv, bias, mask = _qkv_case(h, b, use_mask, seed=10 * h + save_p)
    jout, jgrads = _jax_value_and_grad(qkv, bias, mask, h, save_p,
                                       transposed)
    before = dict(kernels.launch_counts)
    got = _port(qkv, bias, mask, h, save_p=save_p, transposed=transposed)
    assert kernels.launch_counts == before
    assert tuple(got[0].shape) == (b, N, h * D)
    _assert_matches(got, jout, jgrads, f"save_p={save_p} t={transposed}")


@pytest.mark.parametrize("save_p,transposed", VARIANTS, ids=VARIANT_IDS)
def test_bwd_delta_changes_none_of_the_variants(save_p, transposed,
                                                monkeypatch):
    """BWD_DELTA set on both packages: gdl_tpu's row-layout and recompute
    backwards ignore it, and the port's three variants give the bits they
    give without it (no `out` saved, no delta formed)."""
    h, b, use_mask = GRAD_CASES[0]
    qkv, bias, mask = _qkv_case(h, b, use_mask, seed=3)
    off = _port(qkv, bias, mask, h, save_p=save_p, transposed=transposed)
    _set_bwd_delta(monkeypatch, True)
    calls = []
    monkeypatch.setattr(wa, "attention_delta",
                        lambda *a: calls.append(a) or 1 / 0)
    on = _port(qkv, bias, mask, h, save_p=save_p, transposed=transposed)
    assert not calls
    for a, b_ in zip(on, off):
        assert torch.equal(a, b_)
    jout, jgrads = _jax_value_and_grad(qkv, bias, mask, h, save_p,
                                       transposed)
    _assert_matches(on, jout, jgrads, "BWD_DELTA")


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_variant_plain_backwards_pass_gradcheck_in_float64(shifted):
    """The recompute backward (#7) and the row-layout backward (#6) are
    the derivatives of their forwards: autograd's finite differences in
    float64, Bw=4, N=4, C=4, H=2."""
    rng = np.random.default_rng(6)
    bw, n, c, heads = 4, 4, 4, 2
    qkv = torch.from_numpy(rng.standard_normal((bw, n, 3 * c))
                           ).requires_grad_(True)
    bias = torch.from_numpy(rng.standard_normal((heads, n, n))
                            ).requires_grad_(True)
    mask = None
    if shifted:
        m = np.zeros((2, n, n))
        m[1, :2, 2:] = m[1, 2:, :2] = -100.0
        mask = torch.from_numpy(m)
    tol = dict(eps=1e-6, atol=1e-7, rtol=1e-5)
    for save_p, transposed in VARIANTS:
        assert torch.autograd.gradcheck(
            lambda q, bi: wa.window_attention_qkv(
                q, bi, mask, heads, save_p=save_p, transposed=transposed),
            (qkv, bias), **tol), (save_p, transposed)


def test_bf16_recompute_backward_keeps_p_unrounded():
    """Kernel #7's rounding point in bf16: its backward uses the f32 p it
    computes again in ds = p·(dp − Σ dp·p) and rounds p to bf16 only as
    the operand of dv; the save-p backward (#6, #4) reads the bf16 p
    everywhere. So dv agrees bit for bit, dq and dk do not; each equals
    the hand computation with its own p, and both stay within bf16 reach
    of the f32 gradients."""
    rng = np.random.default_rng(12)
    bw, n, c, heads = 4, 49, 64, 2
    d = c // heads
    t = torch.from_numpy
    qkv = t(rng.standard_normal((bw, n, 3 * c)).astype(np.float32))
    bias = t((rng.standard_normal((heads, n, n)) * 0.5).astype(np.float32))
    mask = t(shift_attn_mask(14, 14, 7, 3)[:4])
    dout = t(rng.standard_normal((bw, n, c)).astype(np.float32))
    q16, g16 = qkv.bfloat16(), dout.bfloat16()
    _, p16 = wa.window_attention_qkv_train_ref(q16, bias, mask, heads)
    saved = wa.window_attention_qkv_fused_bwd_ref(q16, p16, g16, heads)
    recomputed = wa.window_attention_qkv_recompute_bwd_ref(q16, bias, mask,
                                                           g16, heads)
    for got in (saved, recomputed):
        assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    rows = lambda x: x.reshape(bw, n, 3, heads, d)  # noqa: E731
    assert torch.equal(rows(saved[0])[:, :, 2], rows(recomputed[0])[:, :, 2])
    assert not torch.equal(saved[0], recomputed[0])
    assert not torch.equal(saved[1], recomputed[1])

    # the hand computation, from the f32 scores of the bf16 operands
    scale = d ** -0.5
    q5 = rows(q16)
    qs = (q5[:, :, 0] * torch.tensor(scale, dtype=torch.bfloat16)).float()
    k, v, g = q5[:, :, 1].float(), q5[:, :, 2].float(), \
        g16.reshape(bw, n, heads, d).float()
    s = torch.einsum("bnhd,bmhd->bhnm", qs, k) + bias[None]
    s = (s.reshape(1, 4, heads, n, n) + mask[None, :, None]).reshape(
        bw, heads, n, n)
    p32 = torch.softmax(s, dim=-1)
    dp = torch.einsum("bihd,bjhd->bhij", g, v)
    for p_ds, got in ((p32, recomputed), (p16.float(), saved)):
        ds = p_ds * (dp - (dp * p_ds).sum(-1, keepdim=True))
        ds_t = ds.bfloat16().float()
        dq = torch.einsum("bhij,bjhd->bihd", ds_t, k) * scale
        dk = torch.einsum("bhij,bihd->bjhd", ds_t, qs)
        assert torch.equal(rows(got[0])[:, :, 0], dq.bfloat16())
        assert torch.equal(rows(got[0])[:, :, 1], dk.bfloat16())
        torch.testing.assert_close(got[1], ds.sum(0), atol=1e-5, rtol=1e-5)

    ref = wa.window_attention_qkv_recompute_bwd_ref(qkv, bias, mask, dout,
                                                    heads)
    for got in (saved, recomputed):
        for a, r in zip(got, ref):
            err = float((a.float() - r).abs().max())
            assert err <= 4e-2 * float(r.abs().max()), err


def _bhnd_case(h, b, use_mask, seed, nw=4):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, N, D)).astype(np.float32)
               for _ in range(3))
    bias = (rng.standard_normal((h, N, N)) * 0.1).astype(np.float32)
    mask = shift_attn_mask(14, 14, 7, 3)[:nw] if use_mask else None
    return q, k, v, bias, mask


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", FWD_CASES, ids=["h4_masked", "h8",
                                                 "h32_masked"])
def test_bhnd_ops_match_pallas(case):
    """window_attention_bhnd against window_attention_pallas,
    window_attention_packed against window_attention_pallas_packed, and
    the dispatcher at both use_pallas values against gdl_tpu's, at 2e-5;
    the port's forms agree with each other to the bit on the CPU."""
    h, b, use_mask = case
    arrays = _bhnd_case(h, b, use_mask, seed=h)
    jargs = [None if a is None else jnp.asarray(a) for a in arrays]
    targs = _torch(*arrays)
    want = {
        "bhnd": jax.jit(jwa.window_attention_pallas)(*jargs),
        "packed": jax.jit(jwa.window_attention_pallas_packed)(*jargs),
        "dispatch_pallas": jax.jit(lambda *a: jwa.window_attention(
            *a, use_pallas=True))(*jargs),
        "dispatch_xla": jax.jit(jwa.window_attention)(*jargs),
    }
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        got = {
            "bhnd": wa.window_attention_bhnd(*targs),
            "packed": wa.window_attention_packed(*targs),
            "dispatch_pallas": wa.window_attention(*targs, use_pallas=True),
        }
    got["dispatch_xla"] = wa.window_attention(*targs)
    assert kernels.launch_counts == before
    for name, w in want.items():
        assert tuple(got[name].shape) == (b, h, N, D)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w),
                                   atol=2e-5, rtol=0, err_msg=name)
    for name in ("packed", "dispatch_pallas", "dispatch_xla"):
        assert torch.equal(got[name], got["bhnd"]), name


def test_bhnd_takes_any_window_count_packed_raises():
    """Window i takes mask[i % nW] for any B in window_attention_pallas
    and in the port's #8; the packed forms raise ValueError when nW does
    not divide B, as gdl_tpu's does."""
    arrays = _bhnd_case(4, 6, True, seed=2)
    want = jax.jit(jwa.window_attention_pallas)(
        *[None if a is None else jnp.asarray(a) for a in arrays])
    targs = _torch(*arrays)
    with torch.no_grad():
        got = wa.window_attention_bhnd(*targs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0)
        with pytest.raises(ValueError, match="not a multiple of nW"):
            wa.window_attention_packed(*targs)
        with pytest.raises(ValueError, match="not a multiple of nW"):
            wa.window_attention(*targs, use_pallas=True)
    with pytest.raises(ValueError, match="not a multiple of nW"):
        jwa.window_attention_pallas_packed(
            *[None if a is None else jnp.asarray(a) for a in arrays])


def test_forward_only_ops_refuse_autograd_dispatcher_plain_is_differentiable():
    """#8 and #9 have no backward and raise when autograd would need one
    (not under no_grad); the dispatcher's plain path is differentiable and
    its gradients are jax.grad's of window_attention_xla."""
    h, b, use_mask = FWD_CASES[0]
    arrays = _bhnd_case(h, b, use_mask, seed=5)
    q, k, v, bias, mask = _torch(*arrays)
    leaf = q.clone().requires_grad_(True)
    for op in (wa.window_attention_bhnd, wa.window_attention_packed,
               lambda *a: wa.window_attention(*a, use_pallas=True)):
        with pytest.raises(RuntimeError, match="no backward"):
            op(leaf, k, v, bias, mask)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    torch.sin(wa.window_attention(*leaves, mask)).sum().backward()
    jgrads = jax.jit(jax.grad(
        lambda q, k, v, bi: jnp.sum(jnp.sin(jwa.window_attention_xla(
            q, k, v, bi, jnp.asarray(arrays[4])))),
        argnums=(0, 1, 2, 3)))(*[jnp.asarray(a) for a in arrays[:4]])
    for name, t, g in zip("qkvb", leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=5e-4,
                                   atol=5e-5, err_msg=name)


def test_cpu_dispatch_head_group_and_refusals(monkeypatch):
    """On CPU tensors impl='auto' gives impl='plain''s bits for every
    variant and launches nothing; head_group is gdl_tpu's g; a 4-D qkv
    whose third axis is not 3, a delta for the row-layout backward and a
    bad impl are refused."""
    qkv, bias, mask = _qkv_case(4, 8, True, seed=9)
    before = dict(kernels.launch_counts)
    for save_p, transposed in VARIANTS + [(True, True)]:
        kw = dict(save_p=save_p, transposed=transposed)
        for a, p in zip(_port(qkv, bias, mask, 4, impl="auto", **kw),
                        _port(qkv, bias, mask, 4, impl="plain", **kw)):
            assert torch.equal(a, p)
    assert kernels.launch_counts == before
    for h in (1, 2, 3, 4, 6, 8, 16, 32):
        for d in (16, 24, 32, 64):
            g = max(1, min(h, 128 // d))
            while h % g:
                g -= 1
            assert wa.head_group(h, d) == g
    tb = torch.from_numpy(bias)
    with pytest.raises(ValueError, match=r"\[Bw, N, 3, C\]"):
        wa.window_attention_qkv(torch.zeros(2, 49, 2, 48), tb[:2], None, 2)
    q2 = torch.from_numpy(qkv).reshape(8, N, -1)
    with pytest.raises(ValueError, match="takes no delta"):
        wa.window_attention_qkv_fused_bwd(q2, None, None, 4,
                                          delta=torch.zeros(1),
                                          transposed=False)
    with pytest.raises(ValueError, match="impl"):
        wa.window_attention_bhnd(*_torch(*_bhnd_case(2, 4, False, 1)),
                                 impl="cuda")


def test_profile_kinds_name_every_new_kernel_symbol():
    """profile_step files each kernel symbol of this port under its row,
    so a trace of the variants leaves nothing of theirs under "other"."""
    from gdl_tpu_torch.profile_step import kind_of

    want = {
        # #6's forward is #5's launch, filed with the forwards
        "wa_fwd_kernel<float, 32, true>": "#5",
        "wa_bwd_rows_kernel<__nv_bfloat16, 64>": "#6",
        "wa_bwd_recompute_kernel<float, 32>": "#7",
        "wa_fwd_kernel<float, 32, false, false>": "#7 forward",
        "wa_bhnd_kernel<float, 32>": "#8",
        # #9 is #8's launch
        "wa_bhnd_kernel<float, 16>": "#9",
        "sa_train_kernel<float, 64, 64>": "#12",
        "wa_bwd_kernel<float, 32, true>": "#4",
        "wa_bwd_fused_kernel<float, 32, 256>": "#3",
    }
    for symbol, row in want.items():
        kind = kind_of(f"void (anonymous namespace)::{symbol}(int)")
        assert row in kind, (symbol, kind)
    # what the PR 6 traces left under "other" (chip_smoke's runs, PR 7)
    for symbol, kind in (
            ("void flip_filter<float, float>(float*)", "convolution"),
            ("void at::native::avg_pool2d_out_cuda_frame_nhwc<float>()",
             "pooling"),
            ("void at::native::reflection_pad1d_out_kernel<float>()", "pad"),
            ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>()",
             "sort")):
        assert kind_of(symbol) == kind, symbol
    assert kind_of("void some_other_kernel<float>(float*)") == "other"


@pytest.mark.parametrize("symbol,kind", [
    ("wa_bwd_kernel<__nv_bfloat16, 32, false>", "window_attention_bwd (#4)"),
    ("wa_bwd_kernel<float, 64, true>", "window_attention_bwd (#4)"),
    ("wa_bwd_fused_attn_kernel<float, 32>",
     "window_attention_bwd_fused (#3)"),
    ("wa_bwd_rows_kernel<__nv_bfloat16, 16>", "window_attention_rows (#6)"),
    ("wa_bwd_recompute_kernel<float, 32>",
     "window_attention_bwd_recompute (#7)"),
    ("wa_fwd_kernel<__nv_bfloat16, 32, true>",
     "window_attention (#1, #2, #5, #7 forward)"),
])
def test_profile_kinds_file_the_backward_symbols_under_their_rows(symbol,
                                                                   kind):
    """The backward kernels on the one body, each taking the BwdArgs of
    window_attention_bwd.cuh, are filed by profile_step: #4 and #4-delta
    under a row of their own, apart from the forwards' attention
    (wa_fwd_kernel), and #3's stage A, #6's and #7's backward under
    theirs."""
    from gdl_tpu_torch.profile_step import kind_of

    assert kind_of(f"void (anonymous namespace)::{symbol}((anonymous "
                   f"namespace)::BwdArgs)") == kind
