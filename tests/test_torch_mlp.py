"""The port's fused MLP op against gdl_tpu's.

`mlp_fused` (a torch.autograd.Function) on CPU tensors runs the plain
version of kernel #15 in its forward and the dense chain `mlp_ref` in its
recompute backward. Here it is held to `gdl_tpu.ops.mlp.mlp_fused` with
the Pallas kernel in interpret mode, forward and all five gradients; the
two plain versions to each other (they differ by the erf approximation
alone); bfloat16 to float32; and the shape rule to its docstring. The CUDA
kernel itself is held to the plain version on the card
(tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.ops import mlp as jmlp
from gdl_tpu_torch import kernels
from gdl_tpu_torch.ops import mlp as tmlp


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(m, c, hidden, seed):
    """x [M, C] and gdl_tpu's operands: w1 [C, hidden], b1, w2 [hidden, C],
    b2 (the port takes the transposes, nn.Linear's layout)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((m, c)).astype(f),
            (rng.standard_normal((c, hidden)) * c ** -0.5).astype(f),
            (rng.standard_normal(hidden) * 0.1).astype(f),
            (rng.standard_normal((hidden, c)) * hidden ** -0.5).astype(f),
            (rng.standard_normal(c) * 0.1).astype(f))


def _port_args(arrays, dtype=torch.float32):
    x, w1, b1, w2, b2 = arrays
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in (x, w1.T, b1, w2.T, b2)]


def test_mlp_fused_matches_pallas_kernel_and_its_gradients():
    """M=128, C=128, hidden=512 (inside both packages' supported sets):
    forward within 1e-5 of the Pallas kernel in interpret mode; the
    gradients to x, w1, b1, w2, b2 within 2e-5 of their largest value of
    jax.grad through gdl_tpu's recompute backward."""
    m, c, hidden = 128, 128, 512
    arrays = _inputs(m, c, hidden, seed=1)
    assert jmlp.mlp_kernel_supported(m, c, hidden, 4)
    assert tmlp.mlp_kernel_supported(m, c, hidden, torch.float32)

    def f(*a):
        o = jmlp.mlp_fused(*a, interpret=True)
        return jnp.sum(jnp.sin(o)), o

    (_, jout), jg = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True)(
        *(jnp.asarray(a) for a in arrays))

    leaves = [t.requires_grad_(True) for t in _port_args(arrays)]
    before = dict(kernels.launch_counts)
    out = tmlp.mlp_fused(*leaves)
    torch.sin(out).sum().backward()
    assert kernels.launch_counts == before  # CPU: the plain version
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    want = (jg[0], np.asarray(jg[1]).T, jg[2], np.asarray(jg[3]).T, jg[4])
    for name, t, w in zip(("dx", "dw1", "db1", "dw2", "db2"), leaves, want):
        w = np.asarray(w)
        assert t.grad.shape == w.shape, name
        err = np.abs(t.grad.numpy() - w).max()
        assert err <= 2e-5 * np.abs(w).max(), (name, err)


def test_plain_versions_differ_by_the_erf_approximation_alone():
    """mlp_fused_ref (Abramowitz-Stegun erf, max error 1.5e-7) against
    mlp_ref (exact GELU) within 1e-6; mlp_ref against the nn.Linear chain
    the model runs when the op is off within 1e-5; and the A&S erf
    against torch.erf within 5e-7 (its 1.5e-7 plus f32 rounding of the
    polynomial)."""
    arrays = _inputs(64, 96, 200, seed=2)
    args = _port_args(arrays)
    a, b = tmlp.mlp_fused_ref(*args), tmlp.mlp_ref(*args)
    assert float((a - b).abs().max()) <= 1e-6
    x, w1, b1, w2, b2 = args
    chain = torch.nn.functional.linear(torch.nn.functional.gelu(
        torch.nn.functional.linear(x, w1, b1), approximate="none"), w2, b2)
    assert float((b - chain).abs().max()) <= 1e-5
    grid = torch.linspace(-6, 6, 4001)
    assert float((tmlp._erf_as(grid) - torch.erf(grid)).abs().max()) <= 5e-7
    assert float(tmlp._erf_as(torch.zeros(1))) == 0.0


def test_bf16_stages_round_where_the_kernel_rounds():
    """In bfloat16 the output is bf16 and within bf16 noise of the f32
    result (2e-2 of its largest value); the intermediate h is rounded to
    bf16 before the GELU: the op equals a chain written out with explicit
    roundings, bit for bit."""
    arrays = _inputs(64, 64, 256, seed=3)
    f32 = tmlp.mlp_fused(*_port_args(arrays))
    x, w1, b1, w2, b2 = _port_args(arrays, torch.bfloat16)
    got = tmlp.mlp_fused(x, w1, b1, w2, b2)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - f32).abs().max())
    assert err <= 2e-2 * float(f32.abs().max()), err
    h = (x.float() @ w1.float().t() + b1.float()).bfloat16()
    g = tmlp._gelu_as(h.float()).bfloat16()
    want = (g.float() @ w2.float().t() + b2.float()).bfloat16()
    assert torch.equal(got, want)
    with torch.autocast("cpu", dtype=torch.bfloat16):  # no effect inside
        assert torch.equal(tmlp.mlp_fused(x, w1, b1, w2, b2), got)


def test_backward_is_the_dense_chain_recomputed():
    """The op saves its five inputs only and its gradients are those of
    mlp_ref (equal bits), in float64 those of finite differences."""
    arrays = _inputs(16, 32, 64, seed=4)
    grads = {}
    for op in (tmlp.mlp_fused, tmlp.mlp_ref):
        leaves = [t.requires_grad_(True) for t in _port_args(arrays)]
        out = op(*leaves)
        torch.sin(out).sum().backward()
        grads[op] = [t.grad for t in leaves]
    for a, b in zip(grads[tmlp.mlp_fused], grads[tmlp.mlp_ref]):
        assert a.abs().max() > 0
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    small = [t.requires_grad_(True) for t in
             _port_args(_inputs(5, 4, 6, seed=5), torch.float64)]
    assert torch.autograd.gradcheck(tmlp.mlp_ref, small, eps=1e-6,
                                    atol=1e-7, rtol=1e-5)


def test_unsupported_shape_runs_the_dense_chain():
    """The rule is a function of the shapes alone: C <= 1024 in float32 or
    bfloat16, at any M and hidden (all four Swin-B stages). Outside it
    mlp_fused is mlp_ref, with autograd's own backward; a bad impl
    raises either way."""
    for m, c in ((100352, 128), (25088, 256), (6272, 512), (1568, 1024)):
        for dt in (torch.float32, torch.bfloat16):
            assert tmlp.mlp_kernel_supported(m, c, 4 * c, dt)
    assert not tmlp.mlp_kernel_supported(64, 1088, 256, torch.float32)
    assert not tmlp.mlp_kernel_supported(64, 128, 512, torch.float64)
    args = _port_args(_inputs(8, 1088, 64, seed=6))
    leaves = [t.requires_grad_(True) for t in args]
    out = tmlp.mlp_fused(*leaves)
    assert torch.equal(out, tmlp.mlp_ref(*args))
    assert out.grad_fn is not None and "MlpFused" not in type(
        out.grad_fn).__name__
    for bad in (args, _port_args(_inputs(8, 64, 64, seed=7))):
        with pytest.raises(ValueError, match="impl"):
            tmlp.mlp_fused(*bad, impl="cuda")
