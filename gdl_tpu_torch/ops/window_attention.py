"""Fused window attention with the qkv projection inside, forward only.

Port of `gdl_tpu/ops/window_attention.py::
window_attention_pallas_qkv_fused_eval` (the Pallas body
`_wa_xw_t_eval_kernel`), the Swin eval path. On a CUDA tensor
`window_attention_qkv_fused_eval` launches the hand-written kernel in
`gdl_tpu_torch/kernels/window_attention_eval.cu`; on a CPU tensor it
runs `window_attention_qkv_fused_eval_ref`, the plain PyTorch version of
the same math (`window_attention_xla_bnhd` after the qkv projection).

Layouts are the reference package's, except that `w` is in nn.Linear
layout: x [Bw, N, C]; w [3C, C] with rows ordered [q|k|v][head][d];
b [3C]; bias [H, N, N]; mask [nW, N, N] or None, window i taking
mask[i % nW]. Returns [Bw, N, C], heads concatenated.

Like the Pallas kernel, the op has no backward: it raises when autograd
would need one.
"""

from __future__ import annotations

from typing import Optional

import torch

from gdl_tpu_torch import kernels

KERNEL_NAME = "window_attention_qkv_fused_eval"
MAX_TOKENS = 64  # N the kernel takes (a Swin window is 49)
MAX_HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def window_attention_qkv_fused_eval_ref(x, w, b, bias, mask, num_heads: int,
                                        scale: Optional[float] = None):
    """Plain PyTorch version, with the kernel's rounding points: the
    projection accumulates in f32 and is rounded to x's dtype before the
    bias add; q is scaled in x's dtype; scores, softmax and p·v
    accumulation run in f32, with p rounded to x's dtype first."""
    bw, n, c = x.shape
    d = c // num_heads
    scale = scale if scale is not None else d ** -0.5
    dt = x.dtype
    qkv = torch.matmul(x, w.t()) + b  # f32 accumulate, rounded to dt
    qkv = qkv.reshape(bw, n, 3, num_heads, d)
    q = qkv[:, :, 0] * torch.tensor(scale, dtype=dt, device=x.device)
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    s = s + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, num_heads, n, n)
             + mask[None, :, None].float()).reshape(bw, num_heads, n, n)
    p = torch.softmax(s, dim=-1).to(dt)
    out = torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float())
    return out.to(dt).reshape(bw, n, c)


def _launch(x, w, b, bias, mask, num_heads, scale):
    bw, n, c = x.shape
    d = c // num_heads
    if n > MAX_TOKENS or d > MAX_HEAD_DIM:
        raise ValueError(f"window_attention_qkv_fused_eval kernel takes N <= "
                         f"{MAX_TOKENS} and head dim <= {MAX_HEAD_DIM}, got "
                         f"N={n}, d={d}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if num_heads * d != c:
        raise ValueError(f"C={c} is not a multiple of num_heads={num_heads}")
    for name, t, shape, dtype in (
            ("w", w, (3 * c, c), x.dtype), ("b", b, (3 * c,), x.dtype),
            ("bias", bias, (num_heads, n, n), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    nw = 1
    if mask is not None:
        nw = mask.shape[0]
        if (tuple(mask.shape) != (nw, n, n) or mask.dtype != torch.float32
                or bw % nw):
            raise ValueError(f"mask: expected [nW, {n}, {n}] float32 with "
                             f"nW dividing {bw}, got {tuple(mask.shape)} "
                             f"{mask.dtype}")
    tensors = [x, w, b, bias] + ([mask] if mask is not None else [])
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("all operands must be on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    lib = kernels.load("window_attention_eval")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.gdl_wa_eval_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        bw, n, c, num_heads, d, nw, float(scale), _DTYPE_CODES[x.dtype],
        stream)
    if err != 0:
        raise RuntimeError(f"window_attention_qkv_fused_eval launch failed: "
                           f"cudaError {err}")
    kernels.launch_counts[KERNEL_NAME] += 1
    return out


def window_attention_qkv_fused_eval(x, w, b, bias, mask, num_heads: int,
                                    scale: Optional[float] = None,
                                    impl: str = "auto"):
    """Fused qkv projection + window attention, forward only.

    impl="auto" launches the CUDA kernel for a CUDA `x` (raising if it
    cannot) and runs the plain version for a CPU `x`. impl="plain" runs
    the plain version on any device; it exists for the tests and for
    holding the kernel to its reference on the card."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b, bias, mask)):
        raise RuntimeError("window_attention_qkv_fused_eval has no backward; "
                           "call it under torch.no_grad() or "
                           "torch.inference_mode()")
    d = x.shape[-1] // num_heads
    scale = scale if scale is not None else d ** -0.5
    if impl == "plain" or (impl == "auto" and not x.is_cuda):
        return window_attention_qkv_fused_eval_ref(x, w, b, bias, mask,
                                                   num_heads, scale)
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    return _launch(x, w, b, bias, mask, num_heads, scale)
