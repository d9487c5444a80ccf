"""Fused transformer MLP (fc1 + exact GELU + fc2), port of
`gdl_tpu/ops/mlp.py`.

`mlp_fused(x, w1, b1, w2, b2)` on x [M, C] computes

    h = x·w1ᵀ + b1   (f32 accumulate, bias added in f32) → x's dtype
    g = gelu(h)      (in f32)                            → x's dtype
    o = g·w2ᵀ + b2   (f32 accumulate, bias added in f32) → x's dtype

with the weights in nn.Linear layout (w1 [hidden, C], w2 [C, hidden];
gdl_tpu stores their transposes). On a CUDA tensor the forward is one
call of `kernels/mlp_fused.cu` (kernel #15, Pallas body `_mlp_kernel`):
two launches of the shared GEMM tile on the current stream, fc1 with the
bias and GELU in its epilogue, then fc2 with its bias, g passing between
them in x's dtype through a workspace this wrapper allocates. Like
gdl_tpu's, the op saves nothing score-sized: its backward recomputes h and
g from the inputs with plain ops (`mlp_ref`) and takes that chain's
gradients.

Three plain versions, as in gdl_tpu: `mlp_ref` is the dense chain at the
kernel's dtype staging with the exact GELU (the chain the model runs when
the op is off, and the backward's source); `mlp_fused_ref` is the
kernel's own plain version, the same staging with the kernel's erf
(Abramowitz & Stegun 7.1.26, within 1.5e-7 of the exact one), so that
kernel and plain can be held to each other tightly. On a CPU tensor
`mlp_fused` runs `mlp_fused_ref`; on a CUDA tensor it launches the kernel
or raises. Shapes outside `mlp_kernel_supported` run `mlp_ref` on any
device: that rule is a function of the shapes alone. While `torch.export`
traces, the forward calls its launch as the operator
`gdl_tpu_torch::mlp_fused_fwd` (CUDA only, with a shape-only fake
implementation), which a replayed artifact launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gdl_tpu_torch import kernels
from gdl_tpu_torch.ops.window_attention import (
    _DTYPE_CODES,
    _acc_dtype,
    _no_autocast,
    _raise_on,
    _require_cuda,
    _use_kernel,
)

KERNEL_NAME = "mlp_fused"
# kept from the first design (see mlp_kernel_supported)
MAX_C = 1024


def _erf_as(x):
    """Abramowitz & Stegun 7.1.26 erf (max abs err 1.5e-7), in x's dtype."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_as(x):
    return x * 0.5 * (1.0 + _erf_as(x * (2.0 ** -0.5)))


def _linear(x, w, b):
    """x·wᵀ + b with f32 accumulation, the bias added before the one
    rounding to x's dtype. On the card that is what the library's GEMM
    with its bias does; on the CPU the product is taken in f32."""
    if x.is_cuda:
        return F.linear(x, w, b)
    acc = _acc_dtype(x.dtype)
    return (torch.matmul(x.to(acc), w.to(acc).t()) + b.to(acc)).to(x.dtype)


def _chain(x, w1, b1, w2, b2, gelu):
    dt, acc = x.dtype, _acc_dtype(x.dtype)
    with _no_autocast(x.device):
        h = _linear(x, w1, b1)
        g = gelu(h.to(acc)).to(dt)
        return _linear(g, w2, b2)


def mlp_ref(x, w1, b1, w2, b2):
    """The dense chain at the kernel's dtype staging, exact GELU; also the
    backward's recompute source."""
    return _chain(x, w1, b1, w2, b2, lambda h: F.gelu(h, approximate="none"))


def mlp_fused_ref(x, w1, b1, w2, b2):
    """Plain PyTorch version of kernel #15: `mlp_ref` with the kernel's
    erf approximation."""
    return _chain(x, w1, b1, w2, b2, _gelu_as)


def mlp_kernel_supported(m: int, c: int, hidden: int,
                         dtype: torch.dtype) -> bool:
    """Where kernel #15 runs: float32 or bfloat16 and C <= 1024; M and
    hidden are free (ragged edges are masked). All four Swin-B stages
    qualify. The cap on C is kept from the first design, whose block held
    all C output sums of its rows in registers, so that no model path
    changes which op it runs; the GEMM tile of the present design takes
    any C. Unlike gdl_tpu's rule, the weights need not fit on the chip."""
    return dtype in _DTYPE_CODES and 1 <= c <= MAX_C and m >= 1 \
        and hidden >= 1


def _launch(x, w1, b1, w2, b2):
    m, c = x.shape
    hidden = w1.shape[0]
    for arg, t, shape in (("w1", w1, (hidden, c)), ("b1", b1, (hidden,)),
                          ("w2", w2, (c, hidden)), ("b2", b2, (c,))):
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"{arg}: expected {shape} {x.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    _require_cuda([x, w1, b1, w2, b2], x)
    lib = kernels.load("mlp_fused")
    g = torch.empty((m, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.gdl_mlp_fused_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), g.data_ptr(), out.data_ptr(), m, c, hidden,
        _DTYPE_CODES[x.dtype], stream)
    _raise_on(err, KERNEL_NAME)
    kernels.launch_counts[KERNEL_NAME] += 1
    return out


@torch.library.custom_op("gdl_tpu_torch::mlp_fused_fwd", mutates_args=(),
                         device_types="cuda")
def _mlp_fused_fwd_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Kernel #15 as an operator that `torch.export` records: the launch
    itself on CUDA tensors, no CPU implementation."""
    return _launch(x, w1, b1, w2, b2)


@_mlp_fused_fwd_op.register_fake
def _(x, w1, b1, w2, b2):
    return x.new_empty(x.shape)


def mlp_fused_fwd(x, w1, b1, w2, b2, impl: str = "auto"):
    """The forward alone at a supported shape: kernel #15 on a CUDA tensor
    under impl="auto", else its plain version."""
    if _use_kernel(impl, x):
        if torch.compiler.is_exporting():
            return torch.ops.gdl_tpu_torch.mlp_fused_fwd(x, w1, b1, w2, b2)
        return _launch(x, w1, b1, w2, b2)
    return mlp_fused_ref(x, w1, b1, w2, b2)


class _MlpFused(torch.autograd.Function):
    """Saves the five inputs only; the backward recomputes h and g through
    `mlp_ref` with plain ops and takes its gradients."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, impl):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return mlp_fused_fwd(x, w1, b1, w2, b2, impl)

    @staticmethod
    def backward(ctx, dy):
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = mlp_ref(*leaves)
        grads = torch.autograd.grad(out, leaves, dy.to(out.dtype))
        return (*grads, None)


def mlp_fused(x, w1, b1, w2, b2, impl: str = "auto"):
    """Fused MLP over 2D [M, C] tokens, with a backward. Gradients flow
    to all five operands.

    impl="auto" launches kernel #15 for a CUDA `x` (raising if it cannot)
    and runs its plain version for a CPU `x`; impl="plain" runs the plain
    version on any device. A shape outside `mlp_kernel_supported` runs the
    dense chain `mlp_ref`."""
    m, c = x.shape
    if not mlp_kernel_supported(m, c, w1.shape[0], x.dtype):
        _use_kernel(impl, x)  # validates impl
        return mlp_ref(x, w1, b1, w2, b2)
    return _MlpFused.apply(x.contiguous(), w1.contiguous(), b1.contiguous(),
                           w2.contiguous(), b2.contiguous(), impl)
