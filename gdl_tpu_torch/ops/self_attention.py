"""Fused multi-head self-attention for the mmformer transformer stack.
Ports of four entries of `gdl_tpu/ops/self_attention.py`:

- `self_attention_fused`: the training op (`_sa_xw_core`), a
  `torch.autograd.Function`. Its forward is the fused-projection forward
  (Pallas body `_sa_xw_fwd_kernel` + `_sa_attn_tail`): qkv = x·Wᵀ,
  softmax(q·scale·kᵀ), attention-probability dropout, p·v, saving qkv and
  the pre-dropout p. Its backward is the attention backward from the
  saved p (`_sa_bwd_kernel`) followed by dx = dqkv·W and dW = dqkvᵀ·x as
  plain GEMMs, the split of gdl_tpu's `_sa_xw_bwd`. On a CUDA tensor both
  halves launch `kernels/self_attention_train.cu`.
- `self_attention_qkv`: the same training op on a qkv that the caller
  projected (`_sa_core`, the `SA_FUSED_QKV = False` path of the model).
  Its forward is `_sa_fwd_kernel` + `_sa_attn_tail` (kernel #12: #10's
  attention without the projection, on `kernels/self_attention_train.cu`)
  and its backward the same attention backward #11.
- `self_attention_fused_eval`: the forward-only op (`_sa_xw_eval_kernel`),
  no residuals, no dropout, no backward. On a CUDA tensor it launches
  `kernels/self_attention_eval.cu`.
- `sa_kernel_supported`: gdl_tpu's gate, kept so that the port's models
  take the fused op for the same head configurations.

Dropout. Mode 'hbm': a mask [B, H, N, N] in x's dtype with values
{0, 1/(1−rate)} is read by the forward and by the backward. Mode
'kernel': both draw the mask themselves from two seed words with the
generator of `ops/dropout.py`, keyed on the flat [B, H, N, N] element
index placed in the stream by `dropout_offset` (an element offset, or a
layout (offset, seg_elems, seg_stride): `ops.dropout.check_layout`), so
forward, backward and the plain version see the same bits; no
score-sized mask reaches memory. A rank of a data-parallel run passes
where its rows lie in the global batch's mask
(`parallel.distributed.element_layout`: one segment, or one a pass for
a batch of stacked passes), so its mask is its rows of the one a single
process draws; 0 by default. gdl_tpu's own bits (the TPU's generator)
are not reproduced.

On a CPU tensor every op runs its plain PyTorch version (`*_ref`), which
rounds where the kernels round; impl="plain" runs the plain version on
any device, impl="kernel" insists on the kernel. On a CUDA tensor an op
launches its kernel or raises; nothing falls back. While `torch.export`
traces, the eval op calls its launch as the operator
`gdl_tpu_torch::sa_fused_eval` (CUDA only, with a shape-only fake
implementation), which a replayed artifact launches.

Layouts: x [B, N, C]; w [3C, C] in nn.Linear layout, rows ordered
[q|k|v][head][d] (gdl_tpu's Dense kernel [C, 3C], transposed); out
[B, N, C], heads concatenated. The residuals are the port's own: qkv
[B, N, 3C] and p [B, H, N, N], both in x's dtype. N needs no padding.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from gdl_tpu_torch import kernels
from gdl_tpu_torch.ops.dropout import (
    check_layout,
    keep_threshold,
    philox_keep_mask,
    prng_dropout_mask,
)
from gdl_tpu_torch.utils.profiling import annotate

FWD_KERNEL_NAME = "self_attention_fused_fwd"
QKV_FWD_KERNEL_NAME = "self_attention_qkv_fwd"
BWD_KERNEL_NAME = "self_attention_fused_bwd"
EVAL_KERNEL_NAME = "self_attention_fused_eval"
MAX_TOKENS = 1024   # the [32, N] f32 score tile must fit shared memory
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"none": 0, "hbm": 1, "kernel": 2}


def _pick_g(num_heads: int, d: int) -> int:
    g = max(1, min(num_heads, 128 // d))
    while num_heads % g:
        g -= 1
    return g


def sa_kernel_supported(dim: int, num_heads: int) -> bool:
    """gdl_tpu's gate on the fused kernels (head groups must fill whole
    128-lane tiles there). The CUDA kernels take any head dim up to 128;
    the models keep this gate so that both packages take the fused op
    for the same configurations."""
    if num_heads <= 0 or dim % num_heads:
        return False
    d = dim // num_heads
    if d > 128 or 128 % d:
        return False
    return (_pick_g(num_heads, d) * d) % 128 == 0


def _no_autocast(device: torch.device):
    # the operands arrive already cast; products of the plain versions run
    # in the dtypes written below, not in autocast's
    return torch.autocast(device.type, enabled=False)


def _rounded(scale: float, dt: torch.dtype) -> float:
    """`scale` rounded to dt, as a Python float (no device copy)."""
    return torch.tensor(scale, dtype=dt).item()


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.float64 if dt == torch.float64 else torch.float32


class _Dropout:
    """What the attention-probability dropout of one call needs: the mode
    (0 none, 1 'hbm', 2 'kernel'), the rate, and the mask [B, H, N, N]
    (mode 1) or the two seed words and the mask's layout in the stream
    (mode 2; `offset`, an element offset or a layout)."""

    def __init__(self, mode: int = 0, rate: float = 0.0,
                 mask: Optional[torch.Tensor] = None,
                 seed_words: Optional[torch.Tensor] = None,
                 offset: Union[int, Sequence[int]] = 0):
        self.mode, self.rate, self.mask, self.seed_words = (
            mode, rate, mask, seed_words)
        self.layout = check_layout(offset)

    @property
    def keep_thresh(self) -> int:
        return keep_threshold(self.rate) if self.mode == 2 else 0

    @property
    def inv_keep(self) -> float:
        return 1.0 / (1.0 - self.rate) if self.mode else 1.0

    def multiplier(self, shape, acc: torch.dtype) -> Optional[torch.Tensor]:
        """m [B, H, N, N] in the accumulation dtype, or None."""
        if self.mode == 1:
            return self.mask.to(acc)
        if self.mode == 2:
            keep = philox_keep_mask(self.seed_words, shape, self.rate,
                                    self.layout)
            # the kernel multiplies by float32(1/(1-rate)), not rounded to T
            return keep.to(acc) * torch.tensor(self.inv_keep,
                                               dtype=torch.float32).item()
        return None


_NO_DROPOUT = _Dropout()


def self_attention_qkv_train_ref(qkv, num_heads: int,
                                 scale: Optional[float] = None,
                                 drop: _Dropout = _NO_DROPOUT):
    """Plain PyTorch version of the training forward on a given qkv
    [B, N, 3C] → (out, p), with the kernels' rounding points: q is scaled
    in qkv's dtype; scores, softmax and the dropout multiply run in f32; p
    is stored rounded, before dropout; p·m is rounded to qkv's dtype for
    p·v, which accumulates in f32."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    scale = scale if scale is not None else d ** -0.5
    dt, acc = qkv.dtype, _acc_dtype(qkv.dtype)
    with _no_autocast(qkv.device):
        q5 = qkv.reshape(b, n, 3, num_heads, d)
        q = q5[:, :, 0] * _rounded(scale, dt)
        k, v = q5[:, :, 1], q5[:, :, 2]
        s = torch.einsum("bnhd,bmhd->bhnm", q.to(acc), k.to(acc))
        pf = torch.softmax(s, dim=-1)
        m = drop.multiplier(pf.shape, acc)
        pd = (pf if m is None else pf * m).to(dt)
        out = torch.einsum("bhnm,bmhd->bnhd", pd.to(acc), v.to(acc))
    return out.to(dt).reshape(b, n, c3 // 3), pf.to(dt)


def self_attention_fused_train_ref(x, w, num_heads: int,
                                   scale: Optional[float] = None,
                                   drop: _Dropout = _NO_DROPOUT):
    """Plain PyTorch version of the training forward → (out, qkv, p): the
    projection accumulates in f32 and is rounded to x's dtype, then
    `self_attention_qkv_train_ref`."""
    with _no_autocast(x.device):
        qkv = torch.matmul(x, w.t())
    out, p = self_attention_qkv_train_ref(qkv, num_heads, scale, drop)
    return out, qkv, p


def self_attention_fused_eval_ref(x, w, num_heads: int,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of the eval op: the training forward's `out`
    without dropout (the eval kernel rounds at the same points)."""
    return self_attention_fused_train_ref(x, w, num_heads, scale)[0]


def self_attention_fused_bwd_ref(qkv, p, dout, num_heads: int,
                                 scale: Optional[float] = None,
                                 drop: _Dropout = _NO_DROPOUT):
    """Plain PyTorch version of the attention backward → dqkv [B, N, 3C]
    in qkv's dtype, from the rounded p residual: p_d = p·m rounded for
    dv = p_dᵀ·dout; dp = (dout·vᵀ)·m and ds = p·(dp − Σ_j dp·p) in f32;
    ds rounded for dq = (ds·k)·scale (scale in f32) and
    dk = dsᵀ·(q·scale) (that scale in qkv's dtype)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    scale = scale if scale is not None else d ** -0.5
    dt, acc = qkv.dtype, _acc_dtype(qkv.dtype)
    with _no_autocast(qkv.device):
        q5 = qkv.reshape(b, n, 3, num_heads, d)
        qs = (q5[:, :, 0] * _rounded(scale, dt)).to(acc)
        k, v = q5[:, :, 1].to(acc), q5[:, :, 2].to(acc)
        pf = p.to(acc)
        g = dout.reshape(b, n, num_heads, d).to(acc)
        m = drop.multiplier(pf.shape, acc)
        pd = (pf if m is None else pf * m).to(dt).to(acc)
        dv = torch.einsum("bhij,bihd->bjhd", pd, g)
        dp = torch.einsum("bihd,bjhd->bhij", g, v)
        if m is not None:
            dp = dp * m
        ds = pf * (dp - (dp * pf).sum(-1, keepdim=True))
        ds_t = ds.to(dt).to(acc)
        dq = torch.einsum("bhij,bjhd->bihd", ds_t, k) * scale
        dk = torch.einsum("bhij,bihd->bjhd", ds_t, qs)
        dqkv = torch.stack([dq, dk, dv], dim=2).to(dt).reshape(b, n, c3)
    return dqkv


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check_kernel_operands(name, x, w, num_heads):
    """Validate the forward kernels' operands → (b, n, c, d)."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, C], got {tuple(x.shape)}")
    b, n, c = x.shape
    if num_heads <= 0 or c % num_heads:
        raise ValueError(f"C={c} is not a multiple of num_heads={num_heads}")
    d = c // num_heads
    if n > MAX_TOKENS or d > MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel takes N <= {MAX_TOKENS} and head "
                         f"dim <= {MAX_HEAD_DIM}, got N={n}, d={d}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if tuple(w.shape) != (3 * c, c) or w.dtype != x.dtype:
        raise ValueError(f"w: expected {(3 * c, c)} {x.dtype}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    _require_cuda([x, w], x)
    return b, n, c, d


def _require_cuda(tensors, like) -> None:
    for t in tensors:
        if not t.is_cuda or t.device != like.device:
            raise ValueError("all operands must be on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def _check_dropout(drop: _Dropout, like, shape) -> None:
    if drop.mode == 1:
        mask = drop.mask
        if tuple(mask.shape) != tuple(shape) or mask.dtype != like.dtype:
            raise ValueError(f"mask: expected {tuple(shape)} {like.dtype}, "
                             f"got {tuple(mask.shape)} {mask.dtype}")
        _require_cuda([drop.mask], like)
    elif drop.mode == 2:
        sw = drop.seed_words
        if sw.dtype != torch.int32 or tuple(sw.shape) != (2,):
            raise ValueError("seed_words must be an int32 tensor [2]")
        sample = shape[1] * shape[2] * shape[3]  # a block maps its start
        if drop.layout.seg_elems % sample:
            raise ValueError(f"the kernels take mask segments of whole "
                             f"samples: seg_elems {drop.layout.seg_elems} is "
                             f"not a multiple of H*N*N = {sample}")
        _require_cuda([sw], like)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _launch_fwd(x, w, num_heads, scale, drop: _Dropout,
                return_keep: bool = False):
    with annotate(kernels.span_names[FWD_KERNEL_NAME]):
        b, n, c, d = _check_kernel_operands(FWD_KERNEL_NAME, x, w, num_heads)
        pshape = (b, num_heads, n, n)
        _check_dropout(drop, x, pshape)
        lib = kernels.load("self_attention_train")
        out = torch.empty_like(x)
        qkv = torch.empty((b, n, 3 * c), dtype=x.dtype, device=x.device)
        p = torch.empty(pshape, dtype=x.dtype, device=x.device)
        keep = (torch.empty(pshape, dtype=torch.uint8, device=x.device)
                if return_keep and drop.mode == 2 else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gdl_sa_fwd_launch(
            x.data_ptr(), w.data_ptr(), qkv.data_ptr(), p.data_ptr(),
            out.data_ptr(), _ptr(drop.mask), _ptr(drop.seed_words), _ptr(keep),
            b, n, c, num_heads, d, float(scale), drop.mode, drop.keep_thresh,
            drop.inv_keep, *drop.layout, _DTYPE_CODES[x.dtype], stream)
        _raise_on(err, FWD_KERNEL_NAME)
        kernels.launch_counts[FWD_KERNEL_NAME] += 1
    return (out, qkv, p, keep) if return_keep else (out, qkv, p)


def _check_qkv(name, qkv, num_heads):
    """Validate a qkv [B, N, 3C] for the kernels → (b, n, c, d)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads if num_heads > 0 else 0
    if num_heads <= 0 or 3 * c != c3 or num_heads * d != c:
        raise ValueError(f"qkv: expected [B, N, 3C] with C a multiple of "
                         f"num_heads={num_heads}, got {tuple(qkv.shape)}")
    if n > MAX_TOKENS or d > MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel takes N <= {MAX_TOKENS} and head "
                         f"dim <= {MAX_HEAD_DIM}, got N={n}, d={d}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {qkv.dtype}")
    return b, n, c, d


def _launch_qkv_fwd(qkv, num_heads, scale, drop: _Dropout,
                    return_keep: bool = False):
    with annotate(kernels.span_names[QKV_FWD_KERNEL_NAME]):
        b, n, c, d = _check_qkv(QKV_FWD_KERNEL_NAME, qkv, num_heads)
        _require_cuda([qkv], qkv)
        pshape = (b, num_heads, n, n)
        _check_dropout(drop, qkv, pshape)
        lib = kernels.load("self_attention_train")
        out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
        p = torch.empty(pshape, dtype=qkv.dtype, device=qkv.device)
        keep = (torch.empty(pshape, dtype=torch.uint8, device=qkv.device)
                if return_keep and drop.mode == 2 else None)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.gdl_sa_qkv_fwd_launch(
            qkv.data_ptr(), p.data_ptr(), out.data_ptr(), _ptr(drop.mask),
            _ptr(drop.seed_words), _ptr(keep), b, n, c, num_heads, d,
            float(scale), drop.mode, drop.keep_thresh, drop.inv_keep,
            *drop.layout, _DTYPE_CODES[qkv.dtype], stream)
        _raise_on(err, QKV_FWD_KERNEL_NAME)
        kernels.launch_counts[QKV_FWD_KERNEL_NAME] += 1
    return (out, p, keep) if return_keep else (out, p)


def _launch_bwd(qkv, p, dout, num_heads, scale, drop: _Dropout):
    with annotate(kernels.span_names[BWD_KERNEL_NAME]):
        b, n, c, d = _check_qkv(BWD_KERNEL_NAME, qkv, num_heads)
        pshape = (b, num_heads, n, n)
        for arg, t, shape in (("p", p, pshape), ("dout", dout, (b, n, c))):
            if tuple(t.shape) != shape or t.dtype != qkv.dtype:
                raise ValueError(f"{arg}: expected {shape} {qkv.dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
        _require_cuda([qkv, p, dout], qkv)
        _check_dropout(drop, qkv, pshape)
        lib = kernels.load("self_attention_train")
        dqkv = torch.empty_like(qkv)
        ds = torch.empty_like(p)  # scratch between the two backward kernels
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.gdl_sa_bwd_launch(
            qkv.data_ptr(), p.data_ptr(), _ptr(drop.mask),
            _ptr(drop.seed_words), dout.data_ptr(), ds.data_ptr(),
            dqkv.data_ptr(), b, n, c, num_heads, d, float(scale), drop.mode,
            drop.keep_thresh, drop.inv_keep, *drop.layout, _DTYPE_CODES[qkv.dtype], stream)
        _raise_on(err, BWD_KERNEL_NAME)
        kernels.launch_counts[BWD_KERNEL_NAME] += 1
    return dqkv


def _launch_eval(x, w, num_heads, scale):
    with annotate(kernels.span_names[EVAL_KERNEL_NAME]):
        b, n, c, d = _check_kernel_operands(EVAL_KERNEL_NAME, x, w, num_heads)
        lib = kernels.load("self_attention_eval")
        out = torch.empty_like(x)
        qkv = torch.empty((b, n, 3 * c), dtype=x.dtype,
                          device=x.device)  # scratch
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gdl_sa_eval_launch(
            x.data_ptr(), w.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, n,
            c, num_heads, d, float(scale), _DTYPE_CODES[x.dtype], stream)
        _raise_on(err, EVAL_KERNEL_NAME)
        kernels.launch_counts[EVAL_KERNEL_NAME] += 1
    return out


@torch.library.custom_op("gdl_tpu_torch::sa_fused_eval", mutates_args=(),
                         device_types="cuda")
def _sa_fused_eval_op(x: torch.Tensor, w: torch.Tensor, num_heads: int,
                      scale: float) -> torch.Tensor:
    """Kernel #13 as an operator that `torch.export` records: the launch
    itself on CUDA tensors, no CPU implementation."""
    with torch.cuda.device(x.device):
        return _launch_eval(x, w, num_heads, scale)


@_sa_fused_eval_op.register_fake
def _(x, w, num_heads, scale):
    return x.new_empty(x.shape)


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got "
                         f"{impl!r}")
    if impl == "kernel" and not x.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors")
    return impl != "plain" and x.is_cuda


def _default_scale(c: int, num_heads: int, scale: Optional[float]) -> float:
    return scale if scale is not None else (c // num_heads) ** -0.5


def make_dropout(x: torch.Tensor, num_heads: int, rate: float, train: bool,
                 dropout_impl: str = "kernel",
                 seed_words: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None,
                 impl: str = "auto",
                 offset: Union[int, Sequence[int]] = 0) -> _Dropout:
    """The dropout of one call, as gdl_tpu's `_dropout_setup` resolves it.
    'kernel' needs `seed_words`; 'hbm' takes `mask` [B, H, N, N] in x's
    dtype or, given `seed_words` instead, generates that mask with the
    mask generator of `ops/dropout.py`. `offset`: where the mask lies in
    the stream, an element offset (a multiple of 4) or a layout."""
    if not (train and rate > 0.0):
        return _NO_DROPOUT
    if dropout_impl not in ("kernel", "hbm"):
        raise ValueError(f"dropout_impl must be 'kernel' or 'hbm', got "
                         f"{dropout_impl!r}")
    if dropout_impl == "kernel":
        if seed_words is None:
            raise ValueError("dropout_rate > 0 at train needs seed_words")
        return _Dropout(2, rate, seed_words=seed_words, offset=offset)
    if mask is None:
        if seed_words is None:
            raise ValueError("dropout_impl='hbm' needs mask or seed_words")
        b, n, _ = x.shape
        mask = prng_dropout_mask(seed_words, (b, num_heads, n, n), rate,
                                 x.dtype,
                                 "plain" if impl == "plain" else "auto",
                                 offset)
    return _Dropout(1, rate, mask=mask)


def self_attention_fused_fwd(x, w, num_heads: int,
                             scale: Optional[float] = None,
                             drop: _Dropout = _NO_DROPOUT, impl: str = "auto",
                             return_keep: bool = False):
    """The training op's forward alone → (out, qkv, p): the kernel on a
    CUDA tensor, else the plain version. With return_keep a fourth value
    is the keep mask the forward drew in 'kernel' dropout mode (uint8
    [B, H, N, N]; None otherwise): from the kernel, a debug output of the
    launch; from the plain version, the generator's mask itself."""
    scale = _default_scale(x.shape[-1], num_heads, scale)
    if _use_kernel(impl, x):
        with torch.cuda.device(x.device):
            return _launch_fwd(x, w, num_heads, scale, drop, return_keep)
    res = self_attention_fused_train_ref(x, w, num_heads, scale, drop)
    if not return_keep:
        return res
    keep = None
    if drop.mode == 2:
        keep = philox_keep_mask(drop.seed_words, res[2].shape, drop.rate,
                                drop.layout).to(torch.uint8)
    return res + (keep,)


def self_attention_fused_bwd(qkv, p, dout, num_heads: int,
                             scale: Optional[float] = None,
                             drop: _Dropout = _NO_DROPOUT, impl: str = "auto"):
    """The attention backward alone → dqkv: the kernel on a CUDA tensor,
    else the plain version."""
    scale = _default_scale(qkv.shape[-1] // 3, num_heads, scale)
    if _use_kernel(impl, qkv):
        with torch.cuda.device(qkv.device):
            return _launch_bwd(qkv, p, dout, num_heads, scale, drop)
    return self_attention_fused_bwd_ref(qkv, p, dout, num_heads, scale, drop)


def self_attention_qkv_fwd(qkv, num_heads: int,
                           scale: Optional[float] = None,
                           drop: _Dropout = _NO_DROPOUT, impl: str = "auto",
                           return_keep: bool = False):
    """The forward of `self_attention_qkv` alone on qkv [B, N, 3C] →
    (out, p): kernel #12 on a CUDA tensor, else the plain version. With
    return_keep a third value is the keep mask drawn in 'kernel' dropout
    mode (uint8 [B, H, N, N], gdl_tpu's `emit_mask`; None otherwise)."""
    scale = _default_scale(qkv.shape[-1] // 3, num_heads, scale)
    if _use_kernel(impl, qkv):
        with torch.cuda.device(qkv.device):
            return _launch_qkv_fwd(qkv, num_heads, scale, drop, return_keep)
    res = self_attention_qkv_train_ref(qkv, num_heads, scale, drop)
    if not return_keep:
        return res
    keep = None
    if drop.mode == 2:
        keep = philox_keep_mask(drop.seed_words, res[1].shape, drop.rate,
                                drop.layout).to(torch.uint8)
    return res + (keep,)


class _SelfAttentionQkv(torch.autograd.Function):
    """out = attention(qkv); saves (qkv, p) and the dropout's mask or seed
    words. The backward is the attention backward (kernel #11, or its
    plain version); dqkv is the whole gradient."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, drop, impl):
        out, p = self_attention_qkv_fwd(qkv, num_heads, scale, drop, impl)
        ctx.save_for_backward(qkv, p)
        ctx.num_heads, ctx.scale, ctx.drop, ctx.impl = (num_heads, scale,
                                                        drop, impl)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, p = ctx.saved_tensors
        dout = dout.to(qkv.dtype).contiguous()
        dqkv = self_attention_fused_bwd(qkv, p, dout, ctx.num_heads,
                                        ctx.scale, ctx.drop, ctx.impl)
        return dqkv, None, None, None, None


def self_attention_qkv(qkv, num_heads: int, scale: Optional[float] = None,
                       dropout_rate: float = 0.0,
                       seed_words: Optional[torch.Tensor] = None,
                       train: bool = False, dropout_impl: str = "kernel",
                       mask: Optional[torch.Tensor] = None,
                       impl: str = "auto",
                       dropout_offset: Union[int, Sequence[int]] = 0):
    """Fused multi-head self-attention on the output of the qkv
    projection, with a backward: qkv is [B, N, 3C] as nn.Linear gives it
    (columns [q|k|v][head][d]), or its [B, N, 3, C] view; the result is
    [B, N, C]. Gradients flow to qkv. Dropout as in `self_attention_fused`:
    the same seed words draw the same mask in both ops (keyed on the flat
    [B, H, N, N] index), so past the projection the two compute the same
    function.

    impl="auto" launches kernels #12 and #11 for a CUDA `qkv` (raising if
    it cannot) and runs their plain versions for a CPU `qkv`;
    impl="plain" runs the plain versions on any device."""
    if qkv.dim() == 4:
        if qkv.shape[2] != 3:
            raise ValueError(f"qkv: expected [B, N, 3, C], got "
                             f"{tuple(qkv.shape)}")
        qkv = qkv.reshape(qkv.shape[0], qkv.shape[1], -1)
    scale = _default_scale(qkv.shape[-1] // 3, num_heads, scale)
    drop = make_dropout(qkv, num_heads, dropout_rate, train, dropout_impl,
                        seed_words, mask, impl, dropout_offset)
    return _SelfAttentionQkv.apply(qkv, num_heads, scale, drop, impl)


class _SelfAttentionFused(torch.autograd.Function):
    """out = attention(x·Wᵀ); saves (x, w, qkv, p) and the dropout's mask
    or seed words. The backward runs the attention backward, then
    dx = dqkv·W and dW = dqkvᵀ·x as plain GEMMs in the operands' dtype
    (f32 accumulate)."""

    @staticmethod
    def forward(ctx, x, w, num_heads, scale, drop, impl):
        out, qkv, p = self_attention_fused_fwd(x, w, num_heads, scale, drop,
                                               impl)
        ctx.save_for_backward(x, w, qkv, p)
        ctx.num_heads, ctx.scale, ctx.drop, ctx.impl = (num_heads, scale,
                                                        drop, impl)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w, qkv, p = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        dqkv = self_attention_fused_bwd(qkv, p, dout, ctx.num_heads,
                                        ctx.scale, ctx.drop, ctx.impl)
        c = x.shape[-1]
        with _no_autocast(x.device):
            dq2 = dqkv.reshape(-1, 3 * c)
            dx = torch.matmul(dq2, w).reshape(x.shape)
            dw = torch.matmul(dq2.t(), x.reshape(-1, c))
        return dx, dw, None, None, None, None


def self_attention_fused(x, w, num_heads: int, scale: Optional[float] = None,
                         dropout_rate: float = 0.0,
                         seed_words: Optional[torch.Tensor] = None,
                         train: bool = False, dropout_impl: str = "kernel",
                         mask: Optional[torch.Tensor] = None,
                         impl: str = "auto",
                       dropout_offset: Union[int, Sequence[int]] = 0):
    """Fused multi-head self-attention including the qkv projection, with
    a backward (the mmformer training op). Gradients flow to x and w.

    Attention-probability dropout applies when `train` and
    dropout_rate > 0: dropout_impl 'kernel' draws the mask inside the
    forward and again inside the backward from `seed_words` (int32 [2] on
    x's device, `ops.dropout.fold_seed_words`); 'hbm' reads `mask`
    ([B, H, N, N] in x's dtype, values {0, 1/(1−rate)}), generated from
    `seed_words` when not given. `dropout_offset` places the mask in the
    generator's stream: an element offset (a multiple of 4) or a layout
    (`ops.dropout.check_layout`).

    impl="auto" launches the kernels for a CUDA `x` (raising if it
    cannot) and runs their plain versions for a CPU `x`; impl="plain"
    runs the plain versions on any device."""
    scale = _default_scale(x.shape[-1], num_heads, scale)
    drop = make_dropout(x, num_heads, dropout_rate, train, dropout_impl,
                        seed_words, mask, impl, dropout_offset)
    return _SelfAttentionFused.apply(x, w, num_heads, scale, drop, impl)


def self_attention_fused_eval(x, w, num_heads: int,
                              scale: Optional[float] = None,
                              impl: str = "auto"):
    """Fused qkv projection + self-attention, forward only (eval and
    serving). Like the Pallas kernel, the op has no backward: it raises
    when autograd would need one."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("self_attention_fused_eval has no backward; call "
                           "it under torch.no_grad() or "
                           "torch.inference_mode()")
    scale = _default_scale(x.shape[-1], num_heads, scale)
    if _use_kernel(impl, x):
        if torch.compiler.is_exporting():
            return torch.ops.gdl_tpu_torch.sa_fused_eval(x, w, num_heads,
                                                         scale)
        with torch.cuda.device(x.device):
            return _launch_eval(x, w, num_heads, scale)
    return self_attention_fused_eval_ref(x, w, num_heads, scale)
