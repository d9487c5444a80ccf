"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked `cuda` and skips
without a CUDA device.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest` because tests/conftest.py sets up JAX for the rest of
the suite.)
"""

import numpy as np
import pytest
import torch

from gdl_tpu_torch.models.swin import relative_position_index, shift_attn_mask
from gdl_tpu_torch.ops.window_attention import (
    window_attention_qkv_fused,
    window_attention_qkv_fused_bwd,
    window_attention_qkv_fused_eval,
    window_attention_qkv_fused_fwd,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(bw, c, heads, seed, window=7):
    rng = np.random.default_rng(seed)
    n = window * window
    x = rng.standard_normal((bw, n, c)).astype(np.float32)
    w = (rng.standard_normal((3 * c, c)) * c ** -0.5).astype(np.float32)
    b = (rng.standard_normal(3 * c) * 0.1).astype(np.float32)
    table = (rng.standard_normal(((2 * window - 1) ** 2, heads))
             * 0.5).astype(np.float32)
    bias = table[relative_position_index(window).reshape(-1)].reshape(
        n, n, heads).transpose(2, 0, 1)
    return x, w, b, np.ascontiguousarray(bias)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,c,heads,res,window", [
    (1024, 128, 4, 56, 7), (256, 256, 8, 28, 7), (64, 512, 16, 14, 7),
    (16, 1024, 32, 7, 7), (8, 32, 2, 14, 7), (8, 128, 2, 14, 7),
    (8, 64, 2, 8, 4)],
    ids=["stage0", "stage1", "stage2", "stage3", "d16", "d64", "n16"])
def test_window_attention_kernel_matches_plain(cuda, bw, c, heads, res,
                                               window, dtype):
    """The dual Swin-B batch-16 stage shapes (shift mask wherever the
    window does not cover the map), head dims 16 and 64, and 16-token
    windows: f32 atol and rtol 2e-4, bf16 atol 3e-2. One launch is
    counted per kernel call and none for the plain version."""
    from gdl_tpu_torch import kernels

    x, w, b, bias = _inputs(bw, c, heads, seed=res, window=window)
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(cuda, dt) for a in (x, w, b)]
    bias_t = torch.from_numpy(bias).to(cuda)
    mask_t = (torch.from_numpy(shift_attn_mask(res, res, window,
                                               window // 2)).to(cuda)
              if res > window else None)
    before = kernels.launch_counts["window_attention_qkv_fused_eval"]
    with torch.no_grad():
        got = window_attention_qkv_fused_eval(*args, bias_t, mask_t, heads)
        want = window_attention_qkv_fused_eval(*args, bias_t, mask_t, heads,
                                               impl="plain")
    torch.cuda.synchronize()
    assert kernels.launch_counts["window_attention_qkv_fused_eval"] == \
        before + 1
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=0)


@pytest.mark.cuda
def test_window_attention_kernel_refuses_what_it_cannot_take(cuda):
    """N > 64 or head dim > 64 raises ValueError; never the plain path."""
    x = torch.zeros(2, 65, 64, device=cuda)
    w = torch.zeros(192, 64, device=cuda)
    b = torch.zeros(192, device=cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="N <= 64"):
        window_attention_qkv_fused_eval(
            x, w, b, torch.zeros(1, 65, 65, device=cuda), None, 1)
    x = torch.zeros(2, 49, 128, device=cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="head dim"):
        window_attention_qkv_fused_eval(
            x, torch.zeros(384, 128, device=cuda),
            torch.zeros(384, device=cuda),
            torch.zeros(1, 49, 49, device=cuda), None, 1)


# the dual Swin-B batch-32 training stage shapes (shift mask wherever the
# window does not cover the map) and a small odd shape: 25-token windows,
# head dim 24, three heads
TRAIN_SHAPES = [(2048, 128, 4, 56, 7), (512, 256, 8, 28, 7),
                (128, 512, 16, 14, 7), (32, 1024, 32, 7, 7),
                (8, 72, 3, 10, 5)]
TRAIN_IDS = ["stage0", "stage1", "stage2", "stage3", "odd"]


def _train_case(cuda, bw, c, heads, res, window, dtype):
    x, w, b, bias = _inputs(bw, c, heads, seed=res + 1, window=window)
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(cuda, dt) for a in (x, w, b)]
    bias_t = torch.from_numpy(bias).to(cuda)
    mask_t = (torch.from_numpy(shift_attn_mask(res, res, window,
                                               window // 2)).to(cuda)
              if res > window else None)
    return args, bias_t, mask_t


def _close(got, want, dtype, what):
    """f32: atol and rtol 2e-4 (forward) or 2e-4 of the largest |value|
    (gradients); bf16: atol 3e-2 and rtol 1e-2, or 2e-2 of the largest
    |value|."""
    got, want = got.float(), want.float()
    if what == "fwd":
        tol = (dict(atol=2e-4, rtol=2e-4) if dtype == "float32"
               else dict(atol=3e-2, rtol=1e-2))
        torch.testing.assert_close(got, want, **tol)
        return
    frac = 2e-4 if dtype == "float32" else 2e-2
    err = float((got - want).abs().max())
    assert err <= frac * float(want.abs().max()), (err, what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,c,heads,res,window", TRAIN_SHAPES,
                         ids=TRAIN_IDS)
def test_savep_kernel_matches_plain(cuda, bw, c, heads, res, window, dtype):
    """Kernel #2: out, qkv and p against the plain forward; one launch
    counted."""
    from gdl_tpu_torch import kernels

    args, bias_t, mask_t = _train_case(cuda, bw, c, heads, res, window,
                                       dtype)
    before = kernels.launch_counts["window_attention_qkv_fused_savep"]
    with torch.no_grad():
        got = window_attention_qkv_fused_fwd(*args, bias_t, mask_t, heads)
        want = window_attention_qkv_fused_fwd(*args, bias_t, mask_t, heads,
                                              impl="plain")
    torch.cuda.synchronize()
    assert kernels.launch_counts["window_attention_qkv_fused_savep"] == \
        before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w, dtype, "fwd")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,c,heads,res,window", TRAIN_SHAPES,
                         ids=TRAIN_IDS)
def test_bwd_kernel_and_train_op_match_plain(cuda, bw, c, heads, res,
                                             window, dtype):
    """Kernel #4 against the plain backward from the same saved qkv and p
    (dqkv, dbias; dbias equal bits on a second run), and the whole
    training op's dx, dW, db and dbias against the plain op."""
    from gdl_tpu_torch import kernels

    args, bias_t, mask_t = _train_case(cuda, bw, c, heads, res, window,
                                       dtype)
    with torch.no_grad():
        _, qkv, p = window_attention_qkv_fused_fwd(*args, bias_t, mask_t,
                                                   heads, impl="plain")
        gen = torch.Generator(device=cuda).manual_seed(bw)
        dout = torch.randn(args[0].shape, generator=gen, device=cuda).to(
            args[0].dtype)
        before = kernels.launch_counts["window_attention_qkv_fused_bwd"]
        got = window_attention_qkv_fused_bwd(qkv, p, dout, heads)
        again = window_attention_qkv_fused_bwd(qkv, p, dout, heads)
        want = window_attention_qkv_fused_bwd(qkv, p, dout, heads,
                                              impl="plain")
    torch.cuda.synchronize()
    assert kernels.launch_counts["window_attention_qkv_fused_bwd"] == \
        before + 2
    assert got[0].dtype == qkv.dtype and got[1].dtype == torch.float32
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    for g, w in zip(got, want):
        _close(g, w, dtype, "grad")

    grads = {}
    for impl in ("auto", "plain"):
        leaves = [a.clone().requires_grad_(True) for a in args + [bias_t]]
        out = window_attention_qkv_fused(*leaves[:3], leaves[3], mask_t,
                                         heads, impl=impl)
        out.backward(dout)
        grads[impl] = [t.grad for t in leaves]
    for g, w in zip(grads["auto"], grads["plain"]):
        _close(g, w, dtype, "grad")


@pytest.mark.cuda
def test_train_kernels_refuse_what_they_cannot_take(cuda):
    """N > 64 or head dim > 64 raises ValueError in both training kernels;
    never the plain path."""
    with torch.no_grad(), pytest.raises(ValueError, match="N <= 64"):
        window_attention_qkv_fused_fwd(
            torch.zeros(2, 65, 64, device=cuda),
            torch.zeros(192, 64, device=cuda), torch.zeros(192, device=cuda),
            torch.zeros(1, 65, 65, device=cuda), None, 1)
    with torch.no_grad(), pytest.raises(ValueError, match="head dim"):
        window_attention_qkv_fused_fwd(
            torch.zeros(2, 49, 128, device=cuda),
            torch.zeros(384, 128, device=cuda),
            torch.zeros(384, device=cuda),
            torch.zeros(1, 49, 49, device=cuda), None, 1)
    with torch.no_grad(), pytest.raises(ValueError, match="N <= 64"):
        window_attention_qkv_fused_bwd(
            torch.zeros(2, 65, 192, device=cuda),
            torch.zeros(2, 1, 65, 65, device=cuda),
            torch.zeros(2, 65, 64, device=cuda), 1)
    with torch.no_grad(), pytest.raises(ValueError, match="head dim"):
        window_attention_qkv_fused_bwd(
            torch.zeros(2, 49, 384, device=cuda),
            torch.zeros(2, 1, 49, 49, device=cuda),
            torch.zeros(2, 49, 128, device=cuda), 1)


# --- kernel #16: the stem max-pool's backward -------------------------------

POOL_SHAPES = [(64, 112, 112, 64), (64, 129, 94, 64), (2, 7, 9, 8),
               (3, 8, 5, 3), (1, 1, 1, 4), (2, 13, 10, 20), (1, 33, 21, 72),
               (1, 9, 40, 130)]


def _pool_inputs(shape, dtype, cuda, kind="relu", seed=0):
    b, h, w, c = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=cuda)
    x = torch.relu(x) if kind == "relu" else torch.full_like(x, 0.5)
    g = torch.randn((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c),
                    generator=gen, device=cuda)
    dt = getattr(torch, dtype)
    return x.to(dt), g.to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["relu", "equal"])
@pytest.mark.parametrize("shape", POOL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_maxpool_bwd_kernel_matches_plain_and_library(cuda, shape, kind,
                                                      dtype):
    """The two flagship stem shapes and small odd ones (a channel count
    that is no multiple of the 16-byte vector takes the scalar variant,
    more than 64 channels take several blocks per tile):
    dx is bit-equal to the plain version's and across two runs; against
    aten.max_pool2d_with_indices_backward, which sums in another order,
    within 4 eps of Σ|g| per element. One launch is counted per kernel
    call, none for the plain version."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.maxpool import max_pool_3x3_s2_bwd

    x, g = _pool_inputs(shape, dtype, cuda, kind, seed=shape[1])
    before = kernels.launch_counts["max_pool_3x3_s2_bwd"]
    got = max_pool_3x3_s2_bwd(x, g)
    again = max_pool_3x3_s2_bwd(x, g)
    assert kernels.launch_counts["max_pool_3x3_s2_bwd"] == before + 2
    want = max_pool_3x3_s2_bwd(x, g, impl="plain")
    assert kernels.launch_counts["max_pool_3x3_s2_bwd"] == before + 2
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, want)
    assert torch.equal(got, again)

    args = ([3, 3], [2, 2], [1, 1], [1, 1], False)
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    _, idx = torch.ops.aten.max_pool2d_with_indices(xn, *args)
    lib = torch.ops.aten.max_pool2d_with_indices_backward(
        gn, xn, *args, idx).permute(0, 2, 3, 1)
    mag = max_pool_3x3_s2_bwd(x, g.abs()).float()
    err = (got.float() - lib.float()).abs()
    assert bool((err <= 4 * torch.finfo(x.dtype).eps * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_autograd_memory_formats_and_refusals(cuda, dtype):
    """Through the autograd Function: NCHW-contiguous, channels_last and
    a strided channels_last view give the plain arm's dx bit for bit and
    launch the kernel once each; under bf16 autocast's dtype the op keeps
    x's dtype. A wrong-shaped g, a dtype the kernel does not take and a
    CPU/CUDA mix are refused."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.maxpool import (
        _launch_bwd,
        max_pool_3x3_s2,
        max_pool_3x3_s2_bwd,
    )

    x, g = _pool_inputs((4, 17, 12, 16), dtype, cuda, seed=3)
    nchw, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    big = torch.zeros((4, 32, 17, 12), dtype=x.dtype, device=cuda).contiguous(
        memory_format=torch.channels_last)
    big[:, :16] = nchw
    grads = []
    for inp in (nchw.contiguous(),
                nchw.contiguous(memory_format=torch.channels_last),
                big[:, :16]):
        for impl in ("auto", "plain"):
            leaf = inp.detach().requires_grad_(True)
            before = kernels.launch_counts["max_pool_3x3_s2_bwd"]
            max_pool_3x3_s2(leaf, impl).backward(gn)
            assert (kernels.launch_counts["max_pool_3x3_s2_bwd"] - before
                    == (1 if impl == "auto" else 0))
            assert leaf.grad.dtype == x.dtype
            grads.append(leaf.grad.permute(0, 2, 3, 1).contiguous())
    torch.cuda.synchronize()
    for other in grads[1:]:
        assert torch.equal(grads[0], other)

    with pytest.raises(ValueError, match="expected"):
        max_pool_3x3_s2_bwd(x, g[:, :, :-1])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _launch_bwd(x.half(), g.half())
    with pytest.raises(ValueError, match="CUDA"):
        _launch_bwd(x, g.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        _launch_bwd(x.transpose(1, 2), g.transpose(1, 2))


# ---- fused self-attention (mmformer) and the dropout-mask generator ------

# the mmformer shapes of one training step (intra 196 tokens, inter 392,
# 8 heads of 64), ragged token counts, and head dims 16, 32 and 128
SA_SHAPES = [(64, 196, 512, 8), (64, 392, 512, 8), (3, 197, 512, 8),
             (2, 52, 512, 8), (2, 9, 128, 8), (2, 70, 96, 3), (2, 33, 256, 2)]
SA_IDS = ["intra", "inter", "n197", "n52", "d16_n9", "d32", "d128"]
SA_FWD_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
              "bfloat16": dict(atol=3e-2, rtol=1e-2)}
SA_GRAD_FRAC = {"float32": 2e-4, "bfloat16": 2e-2}


def _sa_inputs(cuda, b, n, c, dtype, seed):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3 * c, c))
                          * c ** -0.5).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    return x.to(cuda, dt), w.to(cuda, dt), g.to(cuda, dt)


def _grad_close(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    assert err <= SA_GRAD_FRAC[dtype] * float(want.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", ["none", "hbm", "kernel"])
@pytest.mark.parametrize("b,n,c,heads", SA_SHAPES, ids=SA_IDS)
def test_self_attention_kernels_match_plain(cuda, b, n, c, heads, dropout,
                                            dtype):
    """The training forward (out, qkv, p: f32 atol and rtol 2e-4, bf16
    atol 3e-2 + rtol 1e-2), the backward and the whole op's dx and dW
    (largest error within 2e-4 of the reference's largest |value| in f32,
    2e-2 in bf16), with no dropout, a mask read from memory, and a mask
    drawn in the kernel, whose bits must be the plain generator's."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.dropout import fold_seed_words
    from gdl_tpu_torch.ops.self_attention import (
        make_dropout,
        self_attention_fused,
        self_attention_fused_bwd,
        self_attention_fused_fwd,
    )

    x, w, g = _sa_inputs(cuda, b, n, c, dtype, seed=n + c)
    gen = torch.Generator(device=cuda).manual_seed(n)
    words = fold_seed_words(gen, cuda)
    drop = make_dropout(x, heads, 0.3, dropout != "none",
                        "kernel" if dropout == "none" else dropout,
                        seed_words=words)
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        got = self_attention_fused_fwd(x, w, heads, drop=drop,
                                       return_keep=True)
        want = self_attention_fused_fwd(x, w, heads, drop=drop, impl="plain",
                                        return_keep=True)
        for name, a, r in zip(("out", "qkv", "p"), got, want):
            torch.testing.assert_close(a.float(), r.float(),
                                       **SA_FWD_TOL[dtype], msg=name)
        if dropout == "kernel":
            assert torch.equal(got[3], want[3])
            rate = float(got[3].float().mean())
            sigma = (0.3 * 0.7 / got[3].numel()) ** 0.5
            assert abs(rate - 0.7) < 5 * sigma + 1e-9, rate
        _, qkv, p, _ = want
        dq_got = self_attention_fused_bwd(qkv, p, g, heads, drop=drop)
        dq_want = self_attention_fused_bwd(qkv, p, g, heads, drop=drop,
                                           impl="plain")
        _grad_close(dq_got, dq_want, dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts["self_attention_fused_fwd"] == \
        before["self_attention_fused_fwd"] + 1
    assert kernels.launch_counts["self_attention_fused_bwd"] == \
        before["self_attention_fused_bwd"] + 1
    grads = {}
    for impl in ("auto", "plain"):
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = self_attention_fused(
            xl, wl, heads, dropout_rate=0.3, seed_words=words,
            train=dropout != "none",
            dropout_impl="kernel" if dropout == "none" else dropout,
            impl=impl)
        out.backward(g)
        grads[impl] = (xl.grad, wl.grad)
    for a, r in zip(grads["auto"], grads["plain"]):
        _grad_close(a, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c,heads", SA_SHAPES, ids=SA_IDS)
def test_self_attention_eval_kernel_matches_plain(cuda, b, n, c, heads,
                                                  dtype):
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.self_attention import self_attention_fused_eval

    x, w, _ = _sa_inputs(cuda, b, n, c, dtype, seed=n + c + 1)
    before = kernels.launch_counts["self_attention_fused_eval"]
    with torch.no_grad():
        got = self_attention_fused_eval(x, w, heads)
        want = self_attention_fused_eval(x, w, heads, impl="plain")
    torch.cuda.synchronize()
    assert kernels.launch_counts["self_attention_fused_eval"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), **SA_FWD_TOL[dtype])


@pytest.mark.cuda
def test_self_attention_kernels_refuse_what_they_cannot_take(cuda):
    from gdl_tpu_torch.ops.self_attention import (
        self_attention_fused,
        self_attention_fused_eval,
    )

    with torch.no_grad():
        with pytest.raises(ValueError, match="N <= 1024"):
            self_attention_fused_eval(torch.zeros(1, 1025, 64, device=cuda),
                                      torch.zeros(192, 64, device=cuda), 1)
        with pytest.raises(ValueError, match="head dim"):
            self_attention_fused_eval(torch.zeros(1, 8, 256, device=cuda),
                                      torch.zeros(768, 256, device=cuda), 1)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            self_attention_fused_eval(
                torch.zeros(1, 8, 64, device=cuda, dtype=torch.float16),
                torch.zeros(192, 64, device=cuda, dtype=torch.float16), 1)
        with pytest.raises(ValueError, match="w: expected"):
            self_attention_fused(torch.zeros(1, 8, 64, device=cuda),
                                 torch.zeros(64, 192, device=cuda), 1)
    x = torch.zeros(1, 8, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        self_attention_fused_eval(x, torch.zeros(192, 64, device=cuda), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(12544, 512), (12544, 4096), (25088, 512),
                                   (25088, 4096), (7, 13), (3, 5, 2)],
                         ids=["intra512", "intra4096", "inter512",
                              "inter4096", "ragged", "tail"])
def test_dropout_mask_kernel_is_bit_equal_to_plain(cuda, shape, dtype):
    """Kernel #14 against the generator in torch integer arithmetic: the
    same bits, values exactly {0, 1/(1-rate)} in the mask's dtype."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.dropout import fold_seed_words, prng_dropout_mask

    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(len(shape) + shape[0])
    words = fold_seed_words(gen, cuda)
    before = kernels.launch_counts["prng_dropout_mask"]
    got = prng_dropout_mask(words, shape, 0.1, dt)
    want = prng_dropout_mask(words, shape, 0.1, dt, impl="plain")
    torch.cuda.synchronize()
    assert kernels.launch_counts["prng_dropout_mask"] == before + 1
    assert got.dtype == dt and tuple(got.shape) == tuple(shape)
    assert torch.equal(got, want)
    kept = torch.tensor(1.0 / 0.9, dtype=torch.float32).to(dt)
    assert set(got.unique().tolist()) <= {0.0, float(kept)}
    if got.numel() > 10 ** 6:
        rate = float((got != 0).float().mean())
        assert abs(rate - 0.9) < 5 * (0.09 / got.numel()) ** 0.5
    other = prng_dropout_mask(fold_seed_words(gen, cuda), shape, 0.1, dt)
    if got.numel() > 64:
        assert not torch.equal(got, other)
