"""The port's stem max-pool (`gdl_tpu_torch/ops/maxpool.py`) against
gdl_tpu's `max_pool_3x3_s2_pallas` (its Pallas backward in interpret
mode, through jax.vjp) and against F.max_pool2d's own autograd.

On the CPU the op's backward is its plain version, the function the CUDA
kernel is held to on the card. All comparisons are EXACT in f32: dx is a
selection of g values, summed (at most four) in the same order as the
Pallas kernel sums them. The library's autograd sums in another order,
so that comparison uses cotangents with few mantissa bits, whose sums
are exact in any order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gdl_tpu.ops.maxpool import max_pool_3x3_s2_pallas
from gdl_tpu_torch.models.layers import max_pool_3x3_s2 as layer_pool
from gdl_tpu_torch.ops.maxpool import (
    max_pool_3x3_s2,
    max_pool_3x3_s2_bwd,
    max_pool_3x3_s2_bwd_ref,
)

SHAPES = [(2, 129, 94, 8), (2, 112, 112, 8), (1, 7, 9, 4), (3, 8, 6, 5),
          (1, 1, 1, 2), (2, 2, 5, 3)]


def _x(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "relu":  # about half the values exactly 0: ties everywhere
        x = np.maximum(x, 0.0)
    elif kind == "equal":
        x = np.full(shape, 0.5, np.float32)
    elif kind == "coarse":  # few distinct values: ties at the maximum
        x = np.round(x * 2.0) / 2.0
    return x


def _g(shape, seed=1, coarse=False):
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c))
    if coarse:
        g = np.round(g * 8.0) / 8.0
    return g.astype(np.float32)


def _port_dx(x, g, **kw):
    """dx [B,H,W,C] through the autograd Function (NCHW in and out)."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).clone().requires_grad_(True)
    y = max_pool_3x3_s2(xt, **kw)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    return (y.detach().permute(0, 2, 3, 1).numpy(),
            xt.grad.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("kind", ["relu", "equal", "coarse", "normal"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_equals_pallas_interpret(shape, kind):
    """Forward and dx equal gdl_tpu's op (Pallas backward, interpret
    mode) exactly in f32, including ties, all-equal input and odd H/W."""
    x, g = _x(shape, kind), _g(shape)
    y_ref, vjp = jax.vjp(max_pool_3x3_s2_pallas, jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    y, dx = _port_dx(x, g)
    np.testing.assert_array_equal(y, np.asarray(y_ref))
    np.testing.assert_array_equal(dx, np.asarray(dx_ref))


@pytest.mark.parametrize("kind", ["relu", "equal", "normal"])
@pytest.mark.parametrize("shape", SHAPES[:4],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_equals_library_autograd(shape, kind):
    """dx equals F.max_pool2d's autograd exactly (first maximum in
    row-major order, ties included)."""
    x, g = _x(shape, kind, seed=2), _g(shape, seed=3, coarse=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).clone().requires_grad_(True)
    F.max_pool2d(xt, 3, 2, 1).backward(
        torch.from_numpy(g).permute(0, 3, 1, 2))
    _, dx = _port_dx(x, g)
    np.testing.assert_array_equal(dx, xt.grad.permute(0, 2, 3, 1).numpy())
    # every cotangent lands somewhere: the sums agree
    np.testing.assert_allclose(dx.sum(), g.sum(), rtol=1e-5, atol=1e-3)


def test_memory_formats_and_impl_argument():
    """NCHW-contiguous, channels_last and a strided channels_last view
    give the same dx; impl='plain' equals impl='auto' on the CPU; the
    layers.py entry is the same op; an unknown impl raises."""
    shape = (2, 9, 12, 8)
    x, g = _x(shape, "relu", seed=4), _g(shape, seed=5)
    _, want = _port_dx(x, g)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    big = torch.zeros(2, 16, 9, 12).contiguous(
        memory_format=torch.channels_last)
    big[:, :8] = nchw
    for inp in (nchw.contiguous(),
                nchw.contiguous(memory_format=torch.channels_last),
                big[:, :8]):
        for fn in (max_pool_3x3_s2, layer_pool,
                   lambda t: max_pool_3x3_s2(t, impl="plain")):
            leaf = inp.detach().requires_grad_(True)
            fn(leaf).backward(torch.from_numpy(g).permute(0, 3, 1, 2))
            np.testing.assert_array_equal(
                leaf.grad.permute(0, 2, 3, 1).numpy(), want)
    with pytest.raises(ValueError, match="impl"):
        max_pool_3x3_s2(nchw, impl="library")


def test_bf16_rounds_once_and_wrong_shapes_raise():
    """bf16: the compares are exact, the sum is taken in f32 and rounded
    once, so dx is the rounding of the f32 dx of the same bf16 values. A
    wrong-shaped or wrong-typed g is refused."""
    shape = (2, 11, 10, 4)
    x = torch.from_numpy(_x(shape, "relu", seed=6)).bfloat16()
    g = torch.from_numpy(_g(shape, seed=7)).bfloat16()
    dx = max_pool_3x3_s2_bwd(x, g)
    assert dx.dtype == torch.bfloat16 and dx.shape == x.shape
    want = max_pool_3x3_s2_bwd_ref(x.float(), g.float()).bfloat16()
    assert torch.equal(dx, want)
    with pytest.raises(ValueError, match="expected"):
        max_pool_3x3_s2_bwd(x, g[:, :-1])
    with pytest.raises(ValueError, match="float32"):
        max_pool_3x3_s2_bwd(x, g.float())
    with pytest.raises(ValueError, match="impl"):
        max_pool_3x3_s2_bwd(x, g, impl="kernel")
