"""The port's fused eval window attention against gdl_tpu's.

The plain PyTorch version (what the op runs on the CPU) is held to
gdl_tpu's Pallas eval kernel, which runs in interpret mode on the CPU,
and to the XLA attention at a width the Pallas kernel does not take.
The CUDA kernel itself is held to the plain version on the card in
tests/test_torch_kernels_cuda.py. Inputs are numpy-seeded and go to
both packages as numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.models.swin import relative_position_index, shift_attn_mask
from gdl_tpu.ops.window_attention import (
    window_attention_pallas_qkv_fused_eval,
    window_attention_xla_bnhd,
)
from gdl_tpu_torch.ops.window_attention import (
    window_attention_qkv_fused_eval,
    window_attention_qkv_fused_eval_ref,
)


def _inputs(bw, c, heads, window=7, shifted=False, seed=0):
    """x [Bw, N, C], flax kernel [C, 3C], bias vec [3C], rel-pos bias
    [H, N, N], mask [nW, N, N] or None."""
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


def _port(x, kernel, bvec, bias, mask, heads, **kw):
    t = torch.from_numpy
    with torch.no_grad():
        out = window_attention_qkv_fused_eval(
            t(x), t(np.ascontiguousarray(kernel.T)), t(bvec), t(bias),
            None if mask is None else t(mask), heads, **kw)
    return out.numpy()


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_plain_matches_pallas_eval_kernel(shifted):
    """C=128, H=4 (Swin-B stage 0 heads), Bw=8, nW=4 mask: the plain
    version against the Pallas kernel in interpret mode, f32."""
    c, heads, bw, n = 128, 4, 8, 49
    x, kernel, bvec, bias, mask = _inputs(bw, c, heads, shifted=shifted)
    n_pad = 56  # the Pallas entry takes tokens pre-padded to a multiple of 8
    xp = np.pad(x, ((0, 0), (0, n_pad - n), (0, 0)))
    want = window_attention_pallas_qkv_fused_eval(
        jnp.asarray(xp), jnp.asarray(kernel), jnp.asarray(bvec),
        jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
        heads, n_valid=n)
    got = _port(x, kernel, bvec, bias, mask, heads)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_plain_matches_xla_attention_unaligned_width():
    """C=32, H=2 (head dim 16, a width the Pallas kernel refuses): the
    plain version against the projection + window_attention_xla_bnhd."""
    c, heads, bw, n = 32, 2, 8, 49
    x, kernel, bvec, bias, mask = _inputs(bw, c, heads, shifted=True, seed=1)
    qkv = jnp.asarray(x) @ jnp.asarray(kernel) + jnp.asarray(bvec)
    want = window_attention_xla_bnhd(
        qkv.reshape(bw, n, 3, heads, c // heads), jnp.asarray(bias),
        jnp.asarray(mask))
    got = _port(x, kernel, bvec, bias, mask, heads)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_plain_impl_equals_auto_on_cpu():
    """On a CPU tensor the op's default dispatch is the plain version."""
    x, kernel, bvec, bias, mask = _inputs(4, 32, 2, shifted=True, seed=2)
    auto = _port(x, kernel, bvec, bias, mask, 2)
    plain = _port(x, kernel, bvec, bias, mask, 2, impl="plain")
    np.testing.assert_array_equal(auto, plain)


def test_op_refuses_autograd():
    """Like the Pallas eval kernel (no vjp), the op has no backward."""
    x, kernel, bvec, bias, _ = _inputs(4, 32, 2)
    xt = torch.from_numpy(x).requires_grad_(True)
    w = torch.from_numpy(np.ascontiguousarray(kernel.T))
    with pytest.raises(RuntimeError, match="no backward"):
        window_attention_qkv_fused_eval(xt, w, torch.from_numpy(bvec),
                                        torch.from_numpy(bias), None, 2)
    with torch.no_grad():  # the same call is fine without autograd
        window_attention_qkv_fused_eval(xt, w, torch.from_numpy(bvec),
                                        torch.from_numpy(bias), None, 2)


def test_bf16_plain_rounds_like_the_kernel():
    """bf16: projection rounded to bf16 before the bias add, q scaled in
    bf16, softmax in f32 — agrees with the f32 result to bf16 precision."""
    x, kernel, bvec, bias, mask = _inputs(4, 64, 2, shifted=True, seed=3)
    t = torch.from_numpy
    w = t(np.ascontiguousarray(kernel.T))
    with torch.no_grad():
        f32 = window_attention_qkv_fused_eval_ref(
            t(x), w, t(bvec), t(bias), t(mask), 2)
        b16 = window_attention_qkv_fused_eval_ref(
            t(x).bfloat16(), w.bfloat16(), t(bvec).bfloat16(), t(bias),
            t(mask), 2)
    assert b16.dtype == torch.bfloat16
    np.testing.assert_allclose(b16.float().numpy(), f32.numpy(), atol=6e-2)

