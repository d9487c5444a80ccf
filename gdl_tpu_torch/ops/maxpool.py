"""MaxPool2d(kernel 3, stride 2, padding 1) for the ResNet stems, with a
hand-written backward. Port of `gdl_tpu/ops/maxpool.py`
(`max_pool_3x3_s2_pallas`).

As there, the forward is the library's pooling (XLA's reduce_window in
gdl_tpu, `F.max_pool2d` here) and only the backward is a kernel: on a
CUDA tensor it launches `kernels/maxpool_bwd.cu`. Gradient semantics:
each cotangent goes to the FIRST maximal element of its window in
row-major order, ties included (ties are the common case: x is a ReLU
output, so whole windows are exactly 0). Both the kernel and the plain
version read the saved x itself, never a recomputed copy: two roundings
of x would fail the tie test and drop gradients.

On a CPU tensor the backward is the plain version
(`max_pool_3x3_s2_bwd_ref`); impl="plain" runs it on any device. On a
CUDA tensor the op launches its kernel or raises; nothing falls back.

The public op takes and returns NCHW tensors (the port's ResNet keeps
them in `channels_last` memory, so C is innermost for cuDNN and for the
kernel); the `_bwd` functions work on the NHWC views [B, H, W, C] of x
and [B, ho, wo, C] of g, ho = (H-1)//2 + 1, gdl_tpu's layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gdl_tpu_torch import kernels
from gdl_tpu_torch.utils.profiling import annotate

KERNEL_NAME = "max_pool_3x3_s2_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _out_size(n: int) -> int:
    return (n - 1) // 2 + 1


def _check_shapes(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError("x and g must be [B, H, W, C] and [B, ho, wo, C]")
    b, h, w, c = x.shape
    want = (b, _out_size(h), _out_size(w), c)
    if tuple(g.shape) != want:
        raise ValueError(f"g: expected {want} for x {tuple(x.shape)}, got "
                         f"{tuple(g.shape)}")
    if g.dtype != x.dtype:
        raise ValueError(f"g is {g.dtype}, x is {x.dtype}")


def max_pool_3x3_s2_bwd_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: x [B, H, W, C],
    g [B, ho, wo, C] → dx [B, H, W, C].

    The nine strided views of the -inf-padded x, their running maximum,
    and a first-max count, as gdl_tpu's `_max_pool_bwd` writes them. The
    compares run in f32 (exact for bf16). The contributions are summed in
    f32 in the order of the window offsets (di, dj) and rounded once to
    g's dtype, the kernel's order and rounding."""
    _check_shapes(x, g)
    b, h, w, c = x.shape
    ho, wo = _out_size(h), _out_size(w)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1), value=float("-inf"))
    offsets = [(di, dj) for di in range(3) for dj in range(3)]
    views = [xp[:, di:di + 2 * ho:2, dj:dj + 2 * wo:2, :]
             for di, dj in offsets]
    m = views[0]
    for v in views[1:]:
        m = torch.maximum(m, v)
    gp = torch.zeros((b, 2 * ho + 2, 2 * wo + 2, c), dtype=acc,
                     device=x.device)
    count = torch.zeros(m.shape, dtype=torch.int32, device=x.device)
    gf = g.to(acc)
    zero = torch.zeros((), dtype=acc, device=x.device)
    for (di, dj), v in zip(offsets, views):
        eq = v == m
        take = eq & (count == 0)
        count = count + eq.to(torch.int32)
        gp[:, di:di + 2 * ho:2, dj:dj + 2 * wo:2, :] += torch.where(
            take, gf, zero)
    return gp[:, 1:h + 1, 1:w + 1, :].to(g.dtype).contiguous()


def _launch_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx from the CUDA kernel; x and g dense [B, H, W, C] / [B, ho, wo, C]
    on one CUDA device."""
    with annotate(kernels.span_names[KERNEL_NAME]):
        _check_shapes(x, g)
        if x.dtype not in _DTYPE_CODES:
            raise ValueError(
                f"kernel takes float32 or bfloat16, got {x.dtype}")
        if not (x.is_cuda and g.is_cuda and g.device == x.device):
            raise ValueError("x and g must be on one CUDA device")
        if not (x.is_contiguous() and g.is_contiguous()):
            raise ValueError("x and g must be contiguous")
        b, h, w, c = x.shape
        lib = kernels.load("maxpool_bwd")
        dx = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gdl_maxpool_bwd_launch(x.data_ptr(), g.data_ptr(),
                                         dx.data_ptr(), b, h, w, c,
                                         _DTYPE_CODES[x.dtype], stream)
        if err != 0:
            raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError {err}")
        kernels.launch_counts[KERNEL_NAME] += 1
    return dx


def max_pool_3x3_s2_bwd(x: torch.Tensor, g: torch.Tensor,
                        impl: str = "auto") -> torch.Tensor:
    """dx [B, H, W, C] of the pool given x [B, H, W, C] and the cotangent
    g [B, ho, wo, C]. impl="auto": the kernel on a CUDA tensor, the plain
    version on a CPU tensor; "plain": the plain version on any device."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if impl == "plain" or not x.is_cuda:
        return max_pool_3x3_s2_bwd_ref(x, g)
    with torch.cuda.device(x.device):
        return _launch_bwd(x.contiguous(), g.contiguous())


class _MaxPool3x3S2(torch.autograd.Function):
    """NCHW in and out; the backward works on the dense NHWC views."""

    @staticmethod
    def forward(ctx, x, impl):
        ctx.save_for_backward(x)
        ctx.impl = impl
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)

    @staticmethod
    def backward(ctx, grad_out):
        (x,) = ctx.saved_tensors
        # permute is a view; contiguous() copies only where the memory is
        # not already dense channel-last (an NCHW-contiguous input, or a
        # channels_last tensor reached through a strided view)
        x_nhwc = x.permute(0, 2, 3, 1).contiguous()
        g_nhwc = grad_out.to(x.dtype).permute(0, 2, 3, 1).contiguous()
        dx = max_pool_3x3_s2_bwd(x_nhwc, g_nhwc, ctx.impl)
        return dx.permute(0, 3, 1, 2), None


def max_pool_3x3_s2(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """MaxPool2d(3, 2, 1) of an NCHW tensor x (any memory format) with the
    backward above. `impl` is an argument handed down from the classifier,
    like the Swin modules' `attn_impl`."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    return _MaxPool3x3S2.apply(x, impl)
