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
from gdl_tpu_torch.ops.window_attention import window_attention_qkv_fused_eval


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
