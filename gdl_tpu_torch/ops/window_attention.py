"""Fused window attention, with the qkv projection inside or outside.

Ports of the window-attention entries of `gdl_tpu/ops/window_attention.py`:

- `window_attention_qkv_fused_eval`: `window_attention_pallas_qkv_fused_eval`
  (Pallas body `_wa_xw_t_eval_kernel`), the forward-only Swin eval op. On
  a CUDA tensor it launches `kernels/window_attention_eval.cu`.
- `window_attention_qkv_fused`: `window_attention_pallas_qkv_fused` with
  its default gates, the Swin training op, a `torch.autograd.Function`.
  Its forward is the save-p kernel (`_wa_xw_t_savep_kernel`) and its
  backward the attention backward from the saved p (`_attn_bwd_pallas_t`
  → `_wa_qkv_t_bwd_p_kernel`) followed by the projection backward as
  plain GEMMs, as gdl_tpu's phase-1 split runs it. On a CUDA tensor both
  halves launch `kernels/window_attention_train.cu`.
- `window_attention_qkv`: `window_attention_pallas_qkv`, the training op
  on a qkv that the caller projected (the model's `fuse_qkv=False` path),
  with gdl_tpu's three argument combinations:
  - save_p=True, transposed=True (the default): forward kernel #5
    (`_wa_qkv_t_savep_kernel`), backward the attention backward #4;
  - save_p=True, transposed=False: kernel #6 (`_wa_qkv_savep_kernel`,
    `_wa_qkv_bwd_p_kernel`), the same functions in the TPU's row score
    layout: its forward is #5's launch under a count of its own, its
    backward #4's body in blocks that walk a group of heads;
  - save_p=False, either layout, as gdl_tpu routes it: kernel #7
    (`_wa_qkv_kernel`, `_wa_qkv_bwd_kernel`), a forward that saves no p
    and a backward that computes the scores and the softmax again from
    qkv, bias and mask; p stays unrounded f32 in ds there.
- `window_attention_bhnd` (kernel #8, `window_attention_pallas`) and
  `window_attention_packed` (kernel #9, `window_attention_pallas_packed`):
  forward-only attention on separate q, k, v [B, H, N, D], and the
  `window_attention` dispatcher over `window_attention_packed` and the
  plain, differentiable `window_attention_ref` (`window_attention_xla`).

Two module switches, with gdl_tpu's names, values and defaults, are read
when an op is called (they are no CLI flags):

- `BWD_DELTA` (False | True): both training forwards (of
  `window_attention_qkv` only its default, transposed save-p variant, as
  in gdl_tpu) also save `out`, and the backward hands the
  attention-backward kernel the softmax row sums
  delta = Σ_d dout·out per (window, head, query), computed in f32 with
  plain torch ops, instead of letting it form Σ_k dp·p (kernel #4-delta,
  `_wa_qkv_t_bwd_pd_kernel`).
- `FUSED_PROJECTION_BACKWARD` (False | True | "auto"), for
  `window_attention_qkv_fused` only: where `fused_bwd_supported` allows,
  the whole backward is kernel #3 (`_wa_xw_t_bwd_fused_kernel`), which
  returns dx, dW, db and dbias: three launches on one stream, the
  attention backward into a dqkv workspace in x's dtype (where the TPU
  kernel rounds dqkv), then dx = dqkv·W and dW = dqkvᵀ·x on the GEMM
  tile; elsewhere the split above. gdl_tpu's "auto" is a VMEM budget
  with no counterpart here, so "auto" means "wherever supported", the
  same as True.

On a CPU tensor every op runs its plain PyTorch version
(`*_ref` below), which rounds where the kernels round; impl="plain" runs
the plain version on any device. On a CUDA tensor an op launches its
kernel or raises; nothing falls back. While `torch.export` traces
(`torch.compiler.is_exporting()`), the eval op calls its launch as the
operator `gdl_tpu_torch::wa_qkv_fused_eval` (CUDA only, with a
shape-only fake implementation), which a replayed artifact launches.

Layouts are the reference package's, except that `w` is in nn.Linear
layout: x [Bw, N, C]; w [3C, C] with rows ordered [q|k|v][head][d];
b [3C]; bias [H, N, N]; mask [nW, N, N] or None, window i taking
mask[i % nW]. Outputs are [Bw, N, C], heads concatenated. The saved
residuals are qkv [Bw, N, 3C] (after the bias add, q not yet scaled) and
p [Bw, H, N, N], both in x's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from gdl_tpu_torch import kernels

KERNEL_NAME = "window_attention_qkv_fused_eval"
SAVEP_KERNEL_NAME = "window_attention_qkv_fused_savep"
BWD_KERNEL_NAME = "window_attention_qkv_fused_bwd"
QKV_SAVEP_KERNEL_NAME = "window_attention_qkv_savep"
BWD_DELTA_KERNEL_NAME = "window_attention_qkv_fused_bwd_delta"
BWD_FUSED_KERNEL_NAME = "window_attention_qkv_fused_bwd_fused"
QKV_SAVEP_ROWS_KERNEL_NAME = "window_attention_qkv_savep_rows"    # 6
BWD_ROWS_KERNEL_NAME = "window_attention_qkv_bwd_rows"            # 6
QKV_FWD_KERNEL_NAME = "window_attention_qkv_fwd"                  # 7
BWD_RECOMPUTE_KERNEL_NAME = "window_attention_qkv_bwd_recompute"  # 7
BHND_KERNEL_NAME = "window_attention_bhnd"                        # 8
PACKED_KERNEL_NAME = "window_attention_packed"                    # 9
BWD_DELTA = False  # False | True
FUSED_PROJECTION_BACKWARD = False  # False | True | "auto"
MAX_TOKENS = 64  # N the kernels take (a Swin window is 49)
MAX_HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the backward kernel gives each block one head and a run of windows;
# about this many blocks fill an H100's 132 SMs a few times over
_BWD_TARGET_BLOCKS = 1024
# the forward body likewise (a run of windows of one mask class a block)
_FWD_TARGET_BLOCKS = 1024
# kernel #3's dW = dqkvᵀ·x splits its K (the tokens) until its grid of
# 128 x 128 tiles holds two blocks for each of an H100's SMs. The count is
# fixed, not read from the device: the split sets the order of dW's sum,
# so a split that followed the card would give other bits on another one
_SMS = 132
_DW_SPLIT_QUANTUM = 64  # tokens: a split keeps the tile's 16-byte rows
_DW_SPLIT_MIN = 256     # tokens a split sums at least


def _no_autocast(device: torch.device):
    # the operands arrive already cast; products of the plain versions run
    # in the dtypes written below, not in autocast's
    return torch.autocast(device.type, enabled=False)


def _rounded(scale: float, dt: torch.dtype) -> float:
    """`scale` rounded to dt, as a Python float: a tensor times it rounds
    once, like the kernels' product in dt (and needs no device copy)."""
    return torch.tensor(scale, dtype=dt).item()


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype of the plain versions: f32, or f64 for f64
    inputs (gradcheck)."""
    return torch.float64 if dt == torch.float64 else torch.float32


def _add_mask(s, mask):
    """s [B, H, N, N] + mask[i % nW] for window i (any B)."""
    if mask is None:
        return s
    idx = torch.arange(s.shape[0], device=s.device) % mask.shape[0]
    return s + mask[idx][:, None].to(s.dtype)


def _qkv_scores(qkv, bias, mask, num_heads: int, scale: float):
    """(q, k, v [Bw, N, H, d] in qkv's dtype, q scaled in it; the scores
    s = q·kᵀ + bias + mask [Bw, H, N, N] in f32, f64 for f64 inputs)."""
    bw, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    dt, acc = qkv.dtype, _acc_dtype(qkv.dtype)
    q5 = qkv.reshape(bw, n, 3, num_heads, d)
    q = q5[:, :, 0] * _rounded(scale, dt)
    k, v = q5[:, :, 1], q5[:, :, 2]
    s = torch.einsum("bnhd,bmhd->bhnm", q.to(acc), k.to(acc))
    return q, k, v, _add_mask(s + bias[None].to(acc), mask)


def window_attention_qkv_train_ref(qkv, bias, mask, num_heads: int,
                                   scale: Optional[float] = None):
    """Plain PyTorch version of the save-p forward on a given qkv
    [Bw, N, 3C] → (out, p), with kernel #5's rounding points (and #6's,
    and #7's for out): q is scaled in qkv's dtype; scores and softmax run
    in f32 and p is rounded to qkv's dtype; p·v accumulates in f32."""
    bw, n, c3 = qkv.shape
    scale = scale if scale is not None else (c3 // 3 // num_heads) ** -0.5
    dt, acc = qkv.dtype, _acc_dtype(qkv.dtype)
    with _no_autocast(qkv.device):
        _, _, v, s = _qkv_scores(qkv, bias, mask, num_heads, scale)
        p = torch.softmax(s, dim=-1).to(dt)
        out = torch.einsum("bhnm,bmhd->bnhd", p.to(acc), v.to(acc))
    return out.to(dt).reshape(bw, n, c3 // 3), p


def window_attention_qkv_fused_train_ref(x, w, b, bias, mask, num_heads: int,
                                         scale: Optional[float] = None):
    """Plain PyTorch version of the save-p forward → (out, qkv, p), with
    the kernels' rounding points: the projection accumulates in f32 and is
    rounded to x's dtype before the bias add; the rest is
    `window_attention_qkv_train_ref`."""
    with _no_autocast(x.device):
        qkv = torch.matmul(x, w.t()) + b  # f32 accumulate, rounded to dt
    out, p = window_attention_qkv_train_ref(qkv, bias, mask, num_heads, scale)
    return out, qkv, p


def window_attention_qkv_fused_eval_ref(x, w, b, bias, mask, num_heads: int,
                                        scale: Optional[float] = None):
    """Plain PyTorch version of the eval op: the save-p forward's `out`
    (the eval kernel rounds at the same points)."""
    return window_attention_qkv_fused_train_ref(x, w, b, bias, mask,
                                                num_heads, scale)[0]


def attention_delta(out, dout, num_heads: int):
    """The softmax row sums of the attention backward, Σ_k dp·p = Σ_d
    dout·out per (window, head, query) → [Bw, H, N] in f32 (f64 for f64
    inputs): gdl_tpu's `_pack_delta_t` without the TPU lane packing."""
    bw, n, c = out.shape
    acc = _acc_dtype(out.dtype)
    prod = out.to(acc) * dout.to(acc)
    return prod.reshape(bw, n, num_heads, c // num_heads).sum(-1).permute(
        0, 2, 1).contiguous()


def _attn_bwd_ref(q, k, v, pf, pd, dout, scale: float, delta=None):
    """The attention backward's products from q (scaled), k, v
    [Bw, N, H, d] in the input dtype, the p of ds (pf) and the p operand of
    dv (pd), both [Bw, H, N, N] in the accumulation dtype → (dqkv
    [Bw, N, 3C] in the input dtype, dbias [H, N, N] in the accumulation
    dtype): ds = pf⊙(dp − Σ_k dp⊙pf) (or dp − delta) is rounded to the
    input dtype before the dq and dk products; dq is multiplied by `scale`
    in f32; dbias is the sum of ds over windows."""
    bw, n, heads, d = q.shape
    dt, acc = q.dtype, pf.dtype
    k, v = k.to(acc), v.to(acc)
    g = dout.reshape(bw, n, heads, d).to(acc)
    dv = torch.einsum("bhij,bihd->bjhd", pd, g)
    dp = torch.einsum("bihd,bjhd->bhij", g, v)
    rows = ((dp * pf).sum(-1, keepdim=True) if delta is None
            else delta.to(acc)[..., None])
    ds = pf * (dp - rows)
    dbias = ds.sum(0)
    ds_t = ds.to(dt).to(acc)
    dq = torch.einsum("bhij,bjhd->bihd", ds_t, k) * scale
    dk = torch.einsum("bhij,bihd->bjhd", ds_t, q.to(acc))
    return torch.stack([dq, dk, dv], dim=2).to(dt).reshape(bw, n, -1), dbias


def window_attention_qkv_fused_bwd_ref(qkv, p, dout, num_heads: int,
                                       scale: Optional[float] = None,
                                       delta=None):
    """Plain PyTorch version of the attention backward from the saved p →
    (dqkv [Bw, N, 3C] in qkv's dtype, dbias [H, N, N] f32), with kernel
    #4's rounding points (and #6's): ds = p⊙(dp − Σ_k dp⊙p) in f32 is
    rounded to the input dtype before the dq and dk products; dq is
    multiplied by `scale` in f32; dbias is an f32 sum over windows. With
    `delta` [Bw, H, N] (kernel #4-delta) ds = p⊙(dp − delta)."""
    bw, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    scale = scale if scale is not None else d ** -0.5
    dt, acc = qkv.dtype, _acc_dtype(qkv.dtype)
    with _no_autocast(qkv.device):
        q5 = qkv.reshape(bw, n, 3, num_heads, d)
        qs = q5[:, :, 0] * _rounded(scale, dt)
        pf = p.to(acc)
        return _attn_bwd_ref(qs, q5[:, :, 1], q5[:, :, 2], pf, pf, dout,
                             scale, delta)


def window_attention_qkv_recompute_bwd_ref(qkv, bias, mask, dout,
                                           num_heads: int,
                                           scale: Optional[float] = None):
    """Plain PyTorch version of kernel #7's backward → (dqkv [Bw, N, 3C]
    in qkv's dtype, dbias [H, N, N] f32), with `_wa_qkv_bwd_kernel`'s
    rounding points: the scores and p = softmax(s) are computed again in
    f32 as the forward computes them; p stays UNROUNDED in
    ds = p⊙(dp − Σ_k dp⊙p) and is rounded to qkv's dtype only as the
    operand of dv = pᵀ·dout; the rest as in
    `window_attention_qkv_fused_bwd_ref`."""
    scale = scale if scale is not None else (
        qkv.shape[-1] // 3 // num_heads) ** -0.5
    dt = qkv.dtype
    with _no_autocast(qkv.device):
        q, k, v, s = _qkv_scores(qkv, bias, mask, num_heads, scale)
        pf = torch.softmax(s, dim=-1)
        return _attn_bwd_ref(q, k, v, pf, pf.to(dt).to(pf.dtype), dout,
                             scale)


def window_attention_ref(q, k, v, bias, mask=None,
                         scale: Optional[float] = None):
    """Plain PyTorch version of kernels #8 and #9, gdl_tpu's
    `window_attention_xla` on q, k, v [B, H, N, D] → [B, H, N, D], with its
    rounding points: q is scaled in q's dtype; scores, bias, mask and the
    softmax in f32; p rounded to q's dtype for p·v, which accumulates in
    f32. Window i takes mask[i % nW]. Differentiable."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    dt, acc = q.dtype, _acc_dtype(q.dtype)
    with _no_autocast(q.device):
        s = torch.einsum("bhnd,bhmd->bhnm", (q * _rounded(scale, dt)).to(acc),
                         k.to(acc))
        s = _add_mask(s + bias[None].to(acc), mask)
        p = torch.softmax(s, dim=-1).to(dt)
        out = torch.einsum("bhnm,bhmd->bhnd", p.to(acc), v.to(acc))
    return out.to(dt)


def _projection_bwd(dqkv, x, w):
    """dx = dqkv·W, dW = dqkvᵀ·x, db = Σ dqkv: plain GEMMs in the
    operands' dtype (f32 accumulate, one rounding each)."""
    c = x.shape[-1]
    with _no_autocast(x.device):
        dq2 = dqkv.reshape(-1, 3 * c)
        dx = torch.matmul(dq2, w).reshape(x.shape)
        dw = torch.matmul(dq2.t(), x.reshape(-1, c))
        db = dq2.to(_acc_dtype(x.dtype)).sum(0).to(w.dtype)
    return dx, dw, db


def window_attention_qkv_fused_bwd_fused_ref(qkv, p, dout, x, w,
                                             num_heads: int,
                                             scale: Optional[float] = None):
    """Plain PyTorch version of kernel #3 → (dx, dW, db in x's dtype,
    dbias f32): the attention backward with dqkv rounded to the input
    dtype, then the three projection GEMMs, f32 accumulate, one rounding
    each."""
    dqkv, dbias = window_attention_qkv_fused_bwd_ref(qkv, p, dout, num_heads,
                                                     scale)
    return (*_projection_bwd(dqkv, x, w), dbias)


def _require_cuda(tensors, like) -> None:
    for t in tensors:
        if not t.is_cuda or t.device != like.device:
            raise ValueError("all operands must be on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def _check_head_shape(name, n, c, num_heads, dtype):
    d = c // num_heads
    if n > MAX_TOKENS or d > MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel takes N <= {MAX_TOKENS} and head "
                         f"dim <= {MAX_HEAD_DIM}, got N={n}, d={d}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {dtype}")
    if num_heads * d != c:
        raise ValueError(f"C={c} is not a multiple of num_heads={num_heads}")
    return d


def _check_mask(mask, bw: int, n: int) -> int:
    """Validate the shift mask → nW (1 without a mask)."""
    if mask is None:
        return 1
    nw = mask.shape[0]
    if (tuple(mask.shape) != (nw, n, n) or mask.dtype != torch.float32
            or bw % nw):
        raise ValueError(f"mask: expected [nW, {n}, {n}] float32 with "
                         f"nW dividing {bw}, got {tuple(mask.shape)} "
                         f"{mask.dtype}")
    return nw


def _check_forward_operands(name, x, w, b, bias, mask, num_heads):
    """Validate the forward kernels' operands → (bw, n, c, d, nw)."""
    bw, n, c = x.shape
    d = _check_head_shape(name, n, c, num_heads, x.dtype)
    for arg, t, shape, dtype in (
            ("w", w, (3 * c, c), x.dtype), ("b", b, (3 * c,), x.dtype),
            ("bias", bias, (num_heads, n, n), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{arg}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    nw = _check_mask(mask, bw, n)
    _require_cuda([x, w, b, bias] + ([mask] if mask is not None else []), x)
    return bw, n, c, d, nw


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _fwd_windows_per_block(bw: int, num_heads: int) -> int:
    """Windows each block of the forward body walks, all of one mask class
    (window i takes mask[i % nW]), so that the block copies bias[h] and
    its mask once. A function of the shape alone; the forward sums
    nothing across windows, so it sets no bits, only the grid:
    heads x nW x ceil(ceil(Bw / nW) / wpb) blocks."""
    return max(1, bw * num_heads // _FWD_TARGET_BLOCKS)


def _launch(x, w, b, bias, mask, num_heads, scale):
    bw, n, c, d, nw = _check_forward_operands(
        "window_attention_qkv_fused_eval", x, w, b, bias, mask, num_heads)
    lib = kernels.load("window_attention_eval")
    out = torch.empty_like(x)
    # the projection's output, read once by the attention launch
    qkv = torch.empty((bw, n, 3 * c), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.gdl_wa_eval_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, qkv.data_ptr(),
        out.data_ptr(), bw, n, c, num_heads, d, nw,
        _fwd_windows_per_block(bw, num_heads), float(scale),
        _DTYPE_CODES[x.dtype], stream)
    _raise_on(err, KERNEL_NAME)
    kernels.launch_counts[KERNEL_NAME] += 1
    return out


@torch.library.custom_op("gdl_tpu_torch::wa_qkv_fused_eval", mutates_args=(),
                         device_types="cuda")
def _wa_qkv_fused_eval_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          bias: torch.Tensor, mask: Optional[torch.Tensor],
                          num_heads: int, scale: float) -> torch.Tensor:
    """Kernel #1 as an operator that `torch.export` records: the launch
    itself on CUDA tensors, no CPU implementation."""
    return _launch(x, w, b, bias, mask, num_heads, scale)


@_wa_qkv_fused_eval_op.register_fake
def _(x, w, b, bias, mask, num_heads, scale):
    return x.new_empty(x.shape)


def _launch_savep(x, w, b, bias, mask, num_heads, scale):
    bw, n, c, d, nw = _check_forward_operands(
        SAVEP_KERNEL_NAME, x, w, b, bias, mask, num_heads)
    lib = kernels.load("window_attention_train")
    out = torch.empty_like(x)
    qkv = torch.empty((bw, n, 3 * c), dtype=x.dtype, device=x.device)
    p = torch.empty((bw, num_heads, n, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.gdl_wa_savep_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        qkv.data_ptr(), p.data_ptr(), bw, n, c, num_heads, d, nw,
        _fwd_windows_per_block(bw, num_heads), float(scale),
        _DTYPE_CODES[x.dtype], stream)
    _raise_on(err, SAVEP_KERNEL_NAME)
    kernels.launch_counts[SAVEP_KERNEL_NAME] += 1
    return out, qkv, p


def _bwd_windows_per_block(bw: int, num_heads: int) -> int:
    """Windows each backward block sums dbias over. A function of the
    shape alone, so the partials and their sum are the same every run."""
    return max(1, bw * num_heads // _BWD_TARGET_BLOCKS)


def _check_bwd_operands(name, qkv, p, dout, num_heads, extra=()):
    """Validate the backward kernels' operands → (bw, n, c, d). `extra`
    names the operands beyond qkv, p and dout as (argument, tensor, shape,
    dtype)."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    d = _check_head_shape(name, n, c, num_heads, qkv.dtype)
    operands = (("qkv", qkv, (bw, n, 3 * c), qkv.dtype),
                ("p", p, (bw, num_heads, n, n), qkv.dtype),
                ("dout", dout, (bw, n, c), qkv.dtype), *extra)
    for arg, t, shape, dtype in operands:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{arg}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    _require_cuda([t for _, t, _, _ in operands], qkv)
    return bw, n, c, d


def head_group(num_heads: int, d: int) -> int:
    """gdl_tpu's head group g (`window_attention_pallas_qkv`): the most
    heads, up to 128 / d, that divide num_heads. The blocks of kernel #6's
    backward walk a group of g heads."""
    g = max(1, min(num_heads, 128 // d))
    while num_heads % g:
        g -= 1
    return g


def _launch_bwd(qkv, p, dout, num_heads, scale, delta=None, rows=False):
    if rows:
        name = BWD_ROWS_KERNEL_NAME
    else:
        name = BWD_KERNEL_NAME if delta is None else BWD_DELTA_KERNEL_NAME
    extra = () if delta is None else ((
        "delta", delta, (qkv.shape[0], num_heads, qkv.shape[1]),
        torch.float32),)
    bw, n, c, d = _check_bwd_operands(name, qkv, p, dout, num_heads, extra)
    g = head_group(num_heads, d) if rows else 1
    wpb = _bwd_windows_per_block(bw, num_heads // g)
    lib = kernels.load("window_attention_train")
    dqkv = torch.empty_like(qkv)
    parts = torch.empty((-(-bw // wpb), num_heads, n, n), dtype=torch.float32,
                        device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    ptrs = (qkv.data_ptr(), p.data_ptr(), dout.data_ptr())
    tail = (dqkv.data_ptr(), parts.data_ptr(), bw, n, c, num_heads, d, wpb,
            float(scale), _DTYPE_CODES[qkv.dtype], stream)
    if rows:
        err = lib.gdl_wa_bwd_rows_launch(*ptrs, *tail[:7], g, *tail[7:])
    elif delta is None:
        err = lib.gdl_wa_bwd_launch(*ptrs, *tail)
    else:
        err = lib.gdl_wa_bwd_delta_launch(*ptrs, delta.data_ptr(), *tail)
    _raise_on(err, name)
    kernels.launch_counts[name] += 1
    return dqkv, parts.sum(0)


def _check_qkv_operands(name, qkv, bias, mask, num_heads):
    """Validate the operands of the forwards on a given qkv →
    (bw, n, c, d, nw)."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    d = _check_head_shape(name, n, c, num_heads, qkv.dtype)
    if 3 * c != c3 or tuple(bias.shape) != (num_heads, n, n) \
            or bias.dtype != torch.float32:
        raise ValueError(f"qkv [Bw, N, 3C] and bias [{num_heads}, {n}, {n}] "
                         f"float32 expected, got {tuple(qkv.shape)} and "
                         f"{tuple(bias.shape)} {bias.dtype}")
    nw = _check_mask(mask, bw, n)
    _require_cuda([qkv, bias] + ([mask] if mask is not None else []), qkv)
    return bw, n, c, d, nw


def _launch_qkv_savep(qkv, bias, mask, num_heads, scale, rows=False):
    """Kernel #5, or with rows=True #6's forward: the same launch (#6's
    entry makes #5's), counted under its own name."""
    name = QKV_SAVEP_ROWS_KERNEL_NAME if rows else QKV_SAVEP_KERNEL_NAME
    bw, n, c, d, nw = _check_qkv_operands(name, qkv, bias, mask, num_heads)
    lib = kernels.load("window_attention_train")
    out = torch.empty((bw, n, c), dtype=qkv.dtype, device=qkv.device)
    p = torch.empty((bw, num_heads, n, n), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    launch = (lib.gdl_wa_qkv_savep_rows_launch if rows
              else lib.gdl_wa_qkv_savep_launch)
    err = launch(
        qkv.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        p.data_ptr(), bw, n, c, num_heads, d, nw,
        _fwd_windows_per_block(bw, num_heads), float(scale),
        _DTYPE_CODES[qkv.dtype], stream)
    _raise_on(err, name)
    kernels.launch_counts[name] += 1
    return out, p


def _launch_qkv_fwd(qkv, bias, mask, num_heads, scale):
    bw, n, c, d, nw = _check_qkv_operands(QKV_FWD_KERNEL_NAME, qkv, bias,
                                          mask, num_heads)
    lib = kernels.load("window_attention_train")
    out = torch.empty((bw, n, c), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.gdl_wa_qkv_fwd_launch(
        qkv.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(), bw, n,
        c, num_heads, d, nw, _fwd_windows_per_block(bw, num_heads),
        float(scale), _DTYPE_CODES[qkv.dtype], stream)
    _raise_on(err, QKV_FWD_KERNEL_NAME)
    kernels.launch_counts[QKV_FWD_KERNEL_NAME] += 1
    return out


def _launch_bwd_recompute(qkv, bias, mask, dout, num_heads, scale):
    name = BWD_RECOMPUTE_KERNEL_NAME
    bw, n, c, d, nw = _check_qkv_operands(name, qkv, bias, mask, num_heads)
    if tuple(dout.shape) != (bw, n, c) or dout.dtype != qkv.dtype:
        raise ValueError(f"dout: expected {(bw, n, c)} {qkv.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    _require_cuda([dout], qkv)
    wpb = _bwd_windows_per_block(bw, num_heads)
    lib = kernels.load("window_attention_train")
    dqkv = torch.empty_like(qkv)
    parts = torch.empty((-(-bw // wpb), num_heads, n, n), dtype=torch.float32,
                        device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.gdl_wa_bwd_recompute_launch(
        qkv.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, dout.data_ptr(),
        dqkv.data_ptr(), parts.data_ptr(), bw, n, c, num_heads, d, nw, wpb,
        float(scale), _DTYPE_CODES[qkv.dtype], stream)
    _raise_on(err, name)
    kernels.launch_counts[name] += 1
    return dqkv, parts.sum(0)


def _launch_bhnd(q, k, v, bias, mask, scale, packed):
    """Kernel #8, or with packed=True #9: the same launch (#9's entry makes
    #8's), counted under its own name."""
    name = PACKED_KERNEL_NAME if packed else BHND_KERNEL_NAME
    b, h, n, d = q.shape
    _check_head_shape(name, n, h * d, h, q.dtype)
    for arg, t, shape, dtype in (
            ("k", k, (b, h, n, d), q.dtype), ("v", v, (b, h, n, d), q.dtype),
            ("bias", bias, (h, n, n), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{arg}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    nw = 1
    if mask is not None:
        nw = mask.shape[0]
        if tuple(mask.shape) != (nw, n, n) or mask.dtype != torch.float32:
            raise ValueError(f"mask: expected [nW, {n}, {n}] float32, got "
                             f"{tuple(mask.shape)} {mask.dtype}")
    _require_cuda([q, k, v, bias] + ([mask] if mask is not None else []), q)
    lib = kernels.load("window_attention_bhnd")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launch = lib.gdl_wa_packed_launch if packed else lib.gdl_wa_bhnd_launch
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(), b, n,
        h, d, nw, _fwd_windows_per_block(b, h), float(scale),
        _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, name)
    kernels.launch_counts[name] += 1
    return out


def fused_bwd_supported(n: int, c: int, num_heads: int,
                        dtype: torch.dtype) -> bool:
    """Where kernel #3 runs: a function of the shapes alone. Its
    attention stage is kernel #4's device code and its products the GEMM
    tile, so it has no limit beyond #4's own (N <= 64 tokens, head dim
    <= 64, float32 or bfloat16). All four Swin-B stages qualify.

    A recorded divergence from gdl_tpu: under True or "auto" gdl_tpu runs
    its fused kernel only where its f32 dW slab fits
    (`gdl_tpu/ops/window_attention.py:1279-1313`: hg·c·3·gd·4 bytes <=
    _DW_SLAB_FEASIBLE, 9 MB, and under "auto" a 4 MB cap), so Swin-B
    stage 3 (C = 1024: 3C²·4 = 12.6 MB) takes its split there: 44
    launches of #3 and 4 of #4 an arm-B step, where the port makes 48 of
    #3. The port's #3 holds no slab, and both routes compute the same
    function within the tolerances."""
    return (n <= MAX_TOKENS and c % num_heads == 0
            and c // num_heads <= MAX_HEAD_DIM and dtype in _DTYPE_CODES)


def _fused_bwd_split(tokens: int, c: int) -> int:
    """Tokens per K split of kernel #3's dW = dqkvᵀ·x, from the shape
    alone (so the partials and their sum are the same every run). Where
    the [3C, C] grid of 128 x 128 tiles is under a wave of the H100's 132
    SMs, K is split until the grid holds about two blocks an SM, in runs
    of at least 256 tokens that are a multiple of 64; else one partial
    (returns `tokens`). The partials number ceil(tokens / kc)."""
    tiles = -(-3 * c // 128) * -(-c // 128)
    if tiles >= _SMS:
        return tokens
    splits = min(-(-2 * _SMS // tiles), max(1, tokens // _DW_SPLIT_MIN))
    kc = -(-tokens // splits)
    kc = -(-kc // _DW_SPLIT_QUANTUM) * _DW_SPLIT_QUANTUM
    return min(kc, tokens)


def _launch_bwd_fused_parts(qkv, p, dout, x, w, num_heads, scale):
    """Kernel #3's three launches → (dqkv, the workspace in T; dx in T;
    dW's float32 partials [ceil(Bw·N / kc), 3C, C], unrounded; db's
    [runs, 3C] and dbias's [runs, H, N, N] float32 partials)."""
    c = qkv.shape[2] // 3
    extra = (("x", x, (*qkv.shape[:2], c), qkv.dtype),
             ("w", w, (3 * c, c), qkv.dtype))
    bw, n, c, d = _check_bwd_operands(BWD_FUSED_KERNEL_NAME, qkv, p, dout,
                                      num_heads, extra)
    tokens = bw * n
    wpb = _bwd_windows_per_block(bw, num_heads)
    kc = _fused_bwd_split(tokens, c)
    runs = -(-bw // wpb)
    lib = kernels.load("window_attention_train")
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)  # the workspace: dqkv in T
    dx = torch.empty_like(x)
    dw_parts = torch.empty((-(-tokens // kc), 3 * c, c), **f32)
    db_parts = torch.empty((runs, 3 * c), **f32)
    dbias_parts = torch.empty((runs, num_heads, n, n), **f32)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.gdl_wa_bwd_fused_launch(
        qkv.data_ptr(), p.data_ptr(), dout.data_ptr(), x.data_ptr(),
        w.data_ptr(), dqkv.data_ptr(), dx.data_ptr(), dw_parts.data_ptr(),
        db_parts.data_ptr(), dbias_parts.data_ptr(), bw, n, c, num_heads, d,
        wpb, kc, float(scale), _DTYPE_CODES[qkv.dtype], stream)
    _raise_on(err, BWD_FUSED_KERNEL_NAME)
    kernels.launch_counts[BWD_FUSED_KERNEL_NAME] += 1
    return dqkv, dx, dw_parts, db_parts, dbias_parts


def _launch_bwd_fused(qkv, p, dout, x, w, num_heads, scale):
    _, dx, dw_parts, db_parts, dbias_parts = _launch_bwd_fused_parts(
        qkv, p, dout, x, w, num_heads, scale)
    return (dx, dw_parts.sum(0).to(w.dtype), db_parts.sum(0).to(w.dtype),
            dbias_parts.sum(0))


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    return impl == "auto" and x.is_cuda


def _forward_only(name, tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward; call it under "
                           f"torch.no_grad() or torch.inference_mode()")


def window_attention_qkv_fused_eval(x, w, b, bias, mask, num_heads: int,
                                    scale: Optional[float] = None,
                                    impl: str = "auto"):
    """Fused qkv projection + window attention, forward only.

    impl="auto" launches the CUDA kernel for a CUDA `x` (raising if it
    cannot) and runs the plain version for a CPU `x`. impl="plain" runs
    the plain version on any device; it exists for the tests and for
    holding the kernel to its reference on the card. Like the Pallas
    kernel, the op has no backward: it raises when autograd would need
    one."""
    _forward_only("window_attention_qkv_fused_eval", (x, w, b, bias, mask))
    d = x.shape[-1] // num_heads
    scale = scale if scale is not None else d ** -0.5
    if _use_kernel(impl, x):
        if torch.compiler.is_exporting():
            return torch.ops.gdl_tpu_torch.wa_qkv_fused_eval(
                x, w, b, bias, mask, num_heads, scale)
        return _launch(x, w, b, bias, mask, num_heads, scale)
    return window_attention_qkv_fused_eval_ref(x, w, b, bias, mask,
                                               num_heads, scale)


def window_attention_qkv_fused_fwd(x, w, b, bias, mask, num_heads: int,
                                   scale: Optional[float] = None,
                                   impl: str = "auto"):
    """The training op's forward alone → (out, qkv, p): kernel #2 on a
    CUDA tensor under impl="auto", else the plain version."""
    scale = scale if scale is not None else (x.shape[-1] // num_heads) ** -0.5
    if _use_kernel(impl, x):
        return _launch_savep(x, w, b, bias, mask, num_heads, scale)
    return window_attention_qkv_fused_train_ref(x, w, b, bias, mask,
                                                num_heads, scale)


def window_attention_qkv_fused_bwd(qkv, p, dout, num_heads: int,
                                   scale: Optional[float] = None,
                                   impl: str = "auto", delta=None,
                                   transposed: bool = True):
    """The attention backward alone → (dqkv, dbias f32): kernel #4 on a
    CUDA tensor under impl="auto", else the plain version. With `delta`
    [Bw, H, N] f32 (see `attention_delta`) it is kernel #4-delta; with
    transposed=False kernel #6's backward (the same function), which takes
    no delta."""
    d = qkv.shape[-1] // 3 // num_heads
    scale = scale if scale is not None else d ** -0.5
    if not transposed and delta is not None:
        raise ValueError("the row-layout backward (kernel #6) takes no delta")
    if _use_kernel(impl, qkv):
        return _launch_bwd(qkv, p, dout, num_heads, scale, delta,
                           rows=not transposed)
    return window_attention_qkv_fused_bwd_ref(qkv, p, dout, num_heads, scale,
                                              delta)


def window_attention_qkv_fused_bwd_fused(qkv, p, dout, x, w, num_heads: int,
                                         scale: Optional[float] = None,
                                         impl: str = "auto"):
    """The attention backward and the projection backward in one →
    (dx, dW, db, dbias f32): kernel #3 on a CUDA tensor under impl="auto",
    else the plain version."""
    d = qkv.shape[-1] // 3 // num_heads
    scale = scale if scale is not None else d ** -0.5
    if _use_kernel(impl, qkv):
        return _launch_bwd_fused(qkv, p, dout, x, w, num_heads, scale)
    return window_attention_qkv_fused_bwd_fused_ref(qkv, p, dout, x, w,
                                                    num_heads, scale)


def window_attention_qkv_fwd(qkv, bias, mask, num_heads: int,
                             scale: Optional[float] = None,
                             impl: str = "auto", transposed: bool = True):
    """The save-p forward of `window_attention_qkv` alone → (out, p):
    kernel #5 (or #6 with transposed=False) on a CUDA tensor under
    impl="auto", else the plain version."""
    d = qkv.shape[-1] // 3 // num_heads
    scale = scale if scale is not None else d ** -0.5
    if _use_kernel(impl, qkv):
        return _launch_qkv_savep(qkv, bias, mask, num_heads, scale,
                                 rows=not transposed)
    return window_attention_qkv_train_ref(qkv, bias, mask, num_heads, scale)


def window_attention_qkv_recompute_fwd(qkv, bias, mask, num_heads: int,
                                       scale: Optional[float] = None,
                                       impl: str = "auto"):
    """Kernel #7's forward alone → out (no p): the kernel on a CUDA tensor
    under impl="auto", else the plain version."""
    d = qkv.shape[-1] // 3 // num_heads
    scale = scale if scale is not None else d ** -0.5
    if _use_kernel(impl, qkv):
        return _launch_qkv_fwd(qkv, bias, mask, num_heads, scale)
    return window_attention_qkv_train_ref(qkv, bias, mask, num_heads,
                                          scale)[0]


def window_attention_qkv_recompute_bwd(qkv, bias, mask, dout, num_heads: int,
                                       scale: Optional[float] = None,
                                       impl: str = "auto"):
    """Kernel #7's backward alone, from qkv, bias, mask and dout →
    (dqkv, dbias f32): the kernel on a CUDA tensor under impl="auto", else
    the plain version."""
    d = qkv.shape[-1] // 3 // num_heads
    scale = scale if scale is not None else d ** -0.5
    if _use_kernel(impl, qkv):
        return _launch_bwd_recompute(qkv, bias, mask, dout, num_heads, scale)
    return window_attention_qkv_recompute_bwd_ref(qkv, bias, mask, dout,
                                                  num_heads, scale)


def _use_fused_bwd(x, num_heads: int) -> bool:
    mode = FUSED_PROJECTION_BACKWARD
    if mode not in (False, True, "auto"):
        raise ValueError(f"FUSED_PROJECTION_BACKWARD must be False, True or "
                         f"'auto', got {mode!r}")
    return bool(mode) and fused_bwd_supported(x.shape[1], x.shape[2],
                                              num_heads, x.dtype)


def _attention_bwd(ctx, qkv, p, out, dout):
    """The attention backward of both training ops, by ctx's switches."""
    delta = (attention_delta(out, dout, ctx.num_heads) if out is not None
             else None)
    return window_attention_qkv_fused_bwd(qkv, p, dout, ctx.num_heads,
                                          ctx.scale, ctx.impl, delta=delta)


class _QkvFusedAttention(torch.autograd.Function):
    """out = attention(x·Wᵀ + b); saves (x, w, qkv, p), all in x's dtype,
    and `out` as well under BWD_DELTA. The backward runs the attention
    backward (kernel #4 or #4-delta, or their plain version), then
    dx = dqkv·W, dW = dqkvᵀ·x and db = Σ dqkv as plain GEMMs in the
    operands' dtype (f32 accumulate); or, under
    FUSED_PROJECTION_BACKWARD, all of it as kernel #3. The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, b, bias, mask, num_heads, scale, impl):
        out, qkv, p = window_attention_qkv_fused_fwd(x, w, b, bias, mask,
                                                     num_heads, scale, impl)
        ctx.save_for_backward(x, w, qkv, p, out if BWD_DELTA else None)
        ctx.num_heads, ctx.scale, ctx.impl = num_heads, scale, impl
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w, qkv, p, out = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        if _use_fused_bwd(x, ctx.num_heads):
            dx, dw, db, dbias = window_attention_qkv_fused_bwd_fused(
                qkv, p, dout, x, w, ctx.num_heads, ctx.scale, ctx.impl)
        else:
            dqkv, dbias = _attention_bwd(ctx, qkv, p, out, dout)
            dx, dw, db = _projection_bwd(dqkv, x, w)
        return (dx, dw, db, dbias.to(ctx.bias_dtype), None, None, None,
                None)


def window_attention_qkv_fused(x, w, b, bias, mask, num_heads: int,
                               scale: Optional[float] = None,
                               impl: str = "auto"):
    """Fused qkv projection + window attention with a backward (the Swin
    training op). Gradients flow to x, w, b and bias.

    impl="auto" launches kernels #2 and #4 (or #4-delta, or #3, by the
    module switches) for a CUDA `x` (raising if it cannot) and runs their
    plain versions for a CPU `x`; impl="plain" runs the plain versions on
    any device."""
    d = x.shape[-1] // num_heads
    scale = scale if scale is not None else d ** -0.5
    return _QkvFusedAttention.apply(x, w, b, bias, mask, num_heads, scale,
                                    impl)


class _QkvAttention(torch.autograd.Function):
    """out = attention(qkv), by `variant`:
    - "t" (save_p, transposed): saves (qkv, p), and `out` as well under
      BWD_DELTA; backward kernel #4 or #4-delta;
    - "rows" (save_p, row layout): saves (qkv, p); backward kernel #6's;
    - "recompute" (no save_p): saves (qkv, bias, mask), no p; backward
      kernel #7's, which computes p again.
    The plain versions stand in for the kernels on the CPU or under
    impl="plain". The mask gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads, scale, impl, variant):
        if variant == "recompute":
            out = window_attention_qkv_recompute_fwd(qkv, bias, mask,
                                                     num_heads, scale, impl)
            ctx.save_for_backward(qkv, bias, mask)
        else:
            out, p = window_attention_qkv_fwd(qkv, bias, mask, num_heads,
                                              scale, impl,
                                              transposed=variant == "t")
            delta_out = out if BWD_DELTA and variant == "t" else None
            ctx.save_for_backward(qkv, p, delta_out)
        ctx.num_heads, ctx.scale, ctx.impl = num_heads, scale, impl
        ctx.variant, ctx.bias_dtype = variant, bias.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        dout = dout.to(saved[0].dtype).contiguous()
        if ctx.variant == "recompute":
            qkv, bias, mask = saved
            dqkv, dbias = window_attention_qkv_recompute_bwd(
                qkv, bias, mask, dout, ctx.num_heads, ctx.scale, ctx.impl)
        elif ctx.variant == "rows":
            dqkv, dbias = window_attention_qkv_fused_bwd(
                saved[0], saved[1], dout, ctx.num_heads, ctx.scale, ctx.impl,
                transposed=False)
        else:
            dqkv, dbias = _attention_bwd(ctx, *saved, dout)
        return dqkv, dbias.to(ctx.bias_dtype), None, None, None, None, None


def window_attention_qkv(qkv, bias, mask, num_heads: int,
                         scale: Optional[float] = None, save_p: bool = True,
                         transposed: bool = True, impl: str = "auto"):
    """Window attention on the output of the qkv projection, with a
    backward: qkv is [Bw, N, 3C] as nn.Linear gives it, or its
    [Bw, N, 3, C] view; the result is [Bw, N, C]. Gradients flow to qkv
    and bias.

    The arguments pick gdl_tpu's kernels: save_p=True, transposed=True
    (default) #5 and #4 (or #4-delta under BWD_DELTA); save_p=True,
    transposed=False #6; save_p=False #7 whatever `transposed` is, as in
    gdl_tpu. BWD_DELTA reaches only the default, as in gdl_tpu.
    impl="auto" launches the kernels for a CUDA `qkv` (raising if it
    cannot) and runs their plain versions for a CPU `qkv`; impl="plain"
    runs the plain versions on any device.

    The kernels take N = 49 tokens as they are (up to 64), so gdl_tpu's
    `n_valid` and its pad of the tokens to a multiple of 8 have no
    counterpart here."""
    shape = qkv.shape
    if qkv.ndim == 4:
        if shape[2] != 3:
            raise ValueError(f"qkv: expected [Bw, N, 3, C], got "
                             f"{tuple(shape)}")
        qkv = qkv.reshape(shape[0], shape[1], 3 * shape[3])
    d = qkv.shape[-1] // 3 // num_heads
    scale = scale if scale is not None else d ** -0.5
    variant = "recompute" if not save_p else ("t" if transposed else "rows")
    return _QkvAttention.apply(qkv, bias, mask, num_heads, scale, impl,
                               variant)


def window_attention_bhnd(q, k, v, bias, mask=None,
                          scale: Optional[float] = None, impl: str = "auto"):
    """Window attention on separate q, k, v [B, H, N, D] → [B, H, N, D],
    forward only (gdl_tpu's `window_attention_pallas`, kernel #8): bias
    [H, N, N], mask [nW, N, N] or None, window i taking mask[i % nW] for
    any B. impl="auto" launches the kernel for a CUDA `q` (raising if it
    cannot) and runs `window_attention_ref` for a CPU `q`; impl="plain"
    runs it on any device. Raises when autograd would need a backward."""
    _forward_only("window_attention_bhnd", (q, k, v, bias, mask))
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _use_kernel(impl, q):
        return _launch_bhnd(q, k, v, bias, mask, scale, packed=False)
    return window_attention_ref(q, k, v, bias, mask, scale)


def window_attention_packed(q, k, v, bias, mask=None,
                            scale: Optional[float] = None,
                            impl: str = "auto"):
    """`window_attention_bhnd`'s function (gdl_tpu's
    `window_attention_pallas_packed`, kernel #9, which packs the heads in
    groups on the TPU): #8's launch, under a count of its own. Like
    gdl_tpu's, it raises ValueError when a mask is given and B is no
    multiple of nW."""
    _forward_only("window_attention_packed", (q, k, v, bias, mask))
    if mask is not None and q.shape[0] % mask.shape[0]:
        raise ValueError(f"windows {q.shape[0]} not a multiple of nW "
                         f"{mask.shape[0]}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _use_kernel(impl, q):
        return _launch_bhnd(q, k, v, bias, mask, scale, packed=True)
    return window_attention_ref(q, k, v, bias, mask, scale)


def window_attention(q, k, v, bias, mask=None, scale: Optional[float] = None,
                     use_pallas: bool = False, impl: str = "auto"):
    """The dispatcher over the [B, H, N, D] forms, gdl_tpu's stable entry
    point for external callers: use_pallas=True → `window_attention_packed`
    (kernel #9, forward only); otherwise `window_attention_ref`, plain and
    differentiable."""
    if use_pallas:
        return window_attention_packed(q, k, v, bias, mask, scale, impl)
    return window_attention_ref(q, k, v, bias, mask, scale)
