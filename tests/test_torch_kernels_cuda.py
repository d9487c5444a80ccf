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
