"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked `cuda` and skips
without a CUDA device.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest` because tests/conftest.py sets up JAX for the rest of
the suite.)
"""

import hashlib

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


# --- the backward body of #4, #4-delta, #6, #7 and #3's stage A ------------

# window sizes and head dims beyond the Swin-B stages: 64-token windows
# (window 8), one token, bf16 head dim 12 (24-byte rows: 8-byte copies),
# 49 tokens at head dim 32 (bf16 p slabs at odd w*H+h start 2 bytes off
# 16), 25 tokens at head dim 24, head dim 64, and head dim 7 (bf16 rows
# of 14 bytes: element copies)
BWD_BODY_SHAPES = [(16, 64, 64, 2), (6, 1, 32, 1), (10, 49, 24, 2),
                   (7, 49, 64, 2), (6, 25, 72, 3), (4, 49, 128, 2),
                   (6, 9, 14, 2)]
BWD_BODY_IDS = ["n64", "n1", "d12", "odd_slabs", "odd", "d64", "d7"]


def _guarded(shape, dt, cuda, guard=4096):
    """A NaN-filled tensor of `shape` at the front of a NaN buffer, and
    the guard behind it."""
    size = int(np.prod(shape))
    buf = torch.full((size + guard,), float("nan"), dtype=dt, device=cuda)
    return buf[:size].view(shape), buf[size:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,n,c,heads", BWD_BODY_SHAPES, ids=BWD_BODY_IDS)
def test_bwd_body_launchers_write_exactly_their_outputs(cuda, bw, n, c,
                                                        heads, dtype):
    """The five launchers on the one backward body (#4, #4-delta, #6's and
    #7's backward, #3's stage A), called at their C entries with runs of 3
    windows (a ragged last run) and p at an element offset of 1 (its slabs'
    alignment moves): dqkv, the dbias partials and #3's db partials
    prefilled with NaN at the front of larger NaN buffers come out finite
    and leave the buffers' tails NaN (every element written, nothing past
    them); each against its plain version at the gradient bar; equal bits
    on a rerun; #6's and #3's dqkv bit-equal to #4's."""
    import ctypes

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import window_attention as wa

    rng = np.random.default_rng(bw * n + c)
    dt = getattr(torch, dtype)
    code = {"float32": 0, "bfloat16": 1}[dtype]
    d = c // heads
    scale = d ** -0.5
    nw = 2 if bw % 2 == 0 else 1
    wpb, runs = 3, -(-bw // 3)
    scores = rng.standard_normal((bw, heads, n, n))
    pn = np.exp(scores - scores.max(-1, keepdims=True))
    pn /= pn.sum(-1, keepdims=True)

    def dev(a, to=dt):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(cuda, to)

    qkv = dev(rng.standard_normal((bw, n, 3 * c)))
    dout = dev(rng.standard_normal((bw, n, c)))
    pbuf = torch.zeros(1 + bw * heads * n * n, dtype=dt, device=cuda)
    pbuf[1:] = dev(pn.reshape(-1))
    p = pbuf[1:].view(bw, heads, n, n)
    bias = dev(rng.standard_normal((heads, n, n)) * 0.5, torch.float32)
    mask = (dev(np.where(rng.random((nw, n, n)) < 0.2, -100.0, 0.0),
                torch.float32) if nw > 1 else None)
    delta = dev(rng.standard_normal((bw, heads, n)), torch.float32)
    x = dev(rng.standard_normal((bw, n, c)))
    w = dev(rng.standard_normal((3 * c, c)) * c ** -0.5)
    lib = kernels.load("window_attention_train")
    stream = torch.cuda.current_stream(cuda).cuda_stream
    g = wa.head_group(heads, d)

    def launch(kind):
        dqkv, dq_tail = _guarded((bw, n, 3 * c), dt, cuda)
        parts, parts_tail = _guarded((runs, heads, n, n), torch.float32, cuda)
        db, db_tail = _guarded((runs, 3 * c), torch.float32, cuda)
        ptr = (lambda t: None if t is None else ctypes.c_void_p(t.data_ptr()))
        shape = (bw, n, c, heads, d)
        if kind == "4":
            err = lib.gdl_wa_bwd_launch(ptr(qkv), ptr(p), ptr(dout),
                                        ptr(dqkv), ptr(parts), *shape, wpb,
                                        scale, code, stream)
        elif kind == "4_delta":
            err = lib.gdl_wa_bwd_delta_launch(
                ptr(qkv), ptr(p), ptr(dout), ptr(delta), ptr(dqkv),
                ptr(parts), *shape, wpb, scale, code, stream)
        elif kind == "6":
            err = lib.gdl_wa_bwd_rows_launch(ptr(qkv), ptr(p), ptr(dout),
                                             ptr(dqkv), ptr(parts), *shape,
                                             g, wpb, scale, code, stream)
        elif kind == "7":
            err = lib.gdl_wa_bwd_recompute_launch(
                ptr(qkv), ptr(bias), ptr(mask), ptr(dout), ptr(dqkv),
                ptr(parts), *shape, nw, wpb, scale, code, stream)
        else:
            dx = torch.empty_like(x)
            dw = torch.empty((1, 3 * c, c), dtype=torch.float32, device=cuda)
            err = lib.gdl_wa_bwd_fused_launch(
                ptr(qkv), ptr(p), ptr(dout), ptr(x), ptr(w), ptr(dqkv),
                ptr(dx), ptr(dw), ptr(db), ptr(parts), *shape, wpb, bw * n,
                scale, code, stream)
        assert err == 0, (kind, err)
        torch.cuda.synchronize()
        for out, tail in ((dqkv, dq_tail), (parts, parts_tail)) + (
                ((db, db_tail),) if kind == "3" else ()):
            assert bool(torch.isfinite(out.float()).all()), kind
            assert bool(torch.isnan(tail.float()).all()), kind
        return dqkv, parts, db

    with torch.no_grad():
        got = {k: launch(k) for k in ("4", "4_delta", "6", "7", "3")}
        again = {k: launch(k) for k in got}
        want = {
            "4": wa.window_attention_qkv_fused_bwd_ref(qkv, p, dout, heads,
                                                       scale),
            "4_delta": wa.window_attention_qkv_fused_bwd_ref(
                qkv, p, dout, heads, scale, delta=delta),
            "7": wa.window_attention_qkv_recompute_bwd_ref(
                qkv, bias, mask, dout, heads, scale)}
    want["6"] = want["3"] = want["4"]
    for k, (dqkv, parts, db) in got.items():
        assert torch.equal(dqkv, again[k][0]), k
        assert torch.equal(parts, again[k][1]), k
        _close(dqkv, want[k][0], dtype, "grad")
        _close(parts.sum(0), want[k][1], dtype, "grad")
    assert torch.equal(got["6"][0], got["4"][0])
    assert torch.equal(got["3"][0], got["4"][0])
    assert torch.equal(got["3"][1], got["4"][1])
    assert torch.equal(got["3"][2], again["3"][2])
    _close(got["3"][2].sum(0), got["4"][0].float().sum((0, 1)), dtype,
           "grad")


# --- kernel #16: the stem max-pool's backward -------------------------------

# the two flagship stem shapes; small odd ones; then the edges of the tile
# of 4 x 8 windows and 128 bytes of channels: odd H and W that end a tile
# with one window row or column (17 x 33) or one cell short (15 x 31), H
# and W below one tile, C of 8, 72 and 200 (several channel chunks, a
# partial one) and C % 4 != 0 (the scalar variant in both dtypes)
POOL_SHAPES = [(64, 112, 112, 64), (64, 129, 94, 64), (2, 7, 9, 8),
               (3, 8, 5, 3), (1, 1, 1, 4), (2, 13, 10, 20), (1, 33, 21, 72),
               (1, 9, 40, 130), (2, 17, 33, 64), (1, 15, 31, 32),
               (2, 5, 7, 64), (1, 2, 3, 16), (2, 9, 17, 8), (1, 11, 19, 200),
               (1, 12, 18, 6), (2, 9, 9, 5)]
# x and g at an element offset of 1 (the unaligned, scalar path), with an
# aligned C that would otherwise take the vector one
POOL_OFFSET_SHAPES = [(2, 17, 33, 64), (1, 11, 19, 200), (2, 13, 10, 8)]
POOL_CASES = ([(s, 0) for s in POOL_SHAPES]
              + [(s, 1) for s in POOL_OFFSET_SHAPES])


def _pool_case_id(case):
    shape, offset = case
    return "x".join(map(str, shape)) + (f"+{offset}" if offset else "")


def _pool_inputs(shape, dtype, cuda, kind="relu", seed=0, offset=0):
    b, h, w, c = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=cuda)
    x = torch.relu(x) if kind == "relu" else torch.full_like(x, 0.5)
    g = torch.randn((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c),
                    generator=gen, device=cuda)
    dt = getattr(torch, dtype)
    x, g = x.to(dt), g.to(dt)
    if offset:  # the same values, `offset` elements into a larger buffer
        x, g = (torch.cat([torch.zeros(offset, dtype=dt, device=cuda),
                           z.reshape(-1)])[offset:].view(z.shape)
                for z in (x, g))
    return x, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["relu", "equal"])
@pytest.mark.parametrize("case", POOL_CASES, ids=_pool_case_id)
def test_maxpool_bwd_kernel_matches_plain_and_library(cuda, case, kind,
                                                      dtype):
    """The two flagship stem shapes, small odd ones and the edges of the
    kernel's tile (a channel count that is no multiple of the 16-byte
    vector, or x and g off 16 bytes, take the scalar variant; more than
    one chunk of 128 bytes of channels takes several tiles):
    dx is bit-equal to the plain version's and across two runs; against
    aten.max_pool2d_with_indices_backward, which sums in another order,
    within 4 eps of Σ|g| per element. One launch is counted per kernel
    call, none for the plain version."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.maxpool import max_pool_3x3_s2_bwd

    shape, offset = case
    x, g = _pool_inputs(shape, dtype, cuda, kind, seed=shape[1],
                        offset=offset)
    if offset:
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    before = kernels.launch_counts["max_pool_3x3_s2_bwd"]
    got = max_pool_3x3_s2_bwd(x, g)
    again = max_pool_3x3_s2_bwd(x, g)
    assert kernels.launch_counts["max_pool_3x3_s2_bwd"] == before + 2
    want = max_pool_3x3_s2_bwd(x, g, impl="plain")
    assert kernels.launch_counts["max_pool_3x3_s2_bwd"] == before + 2
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, want)
    assert torch.equal(got, again)

    args = ([3, 3], [2, 2], [1, 1], [1, 1], False)
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    _, idx = torch.ops.aten.max_pool2d_with_indices(xn, *args)
    lib = torch.ops.aten.max_pool2d_with_indices_backward(
        gn, xn, *args, idx).permute(0, 2, 3, 1)
    mag = max_pool_3x3_s2_bwd(x, g.abs()).float()
    err = (got.float() - lib.float()).abs()
    assert bool((err <= 4 * torch.finfo(x.dtype).eps * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_autograd_memory_formats_and_refusals(cuda, dtype):
    """Through the autograd Function: NCHW-contiguous, channels_last and
    a strided channels_last view give the plain arm's dx bit for bit and
    launch the kernel once each; under bf16 autocast's dtype the op keeps
    x's dtype. A wrong-shaped g, a dtype the kernel does not take and a
    CPU/CUDA mix are refused."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.maxpool import (
        _launch_bwd,
        max_pool_3x3_s2,
        max_pool_3x3_s2_bwd,
    )

    x, g = _pool_inputs((4, 17, 12, 16), dtype, cuda, seed=3)
    nchw, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    big = torch.zeros((4, 32, 17, 12), dtype=x.dtype, device=cuda).contiguous(
        memory_format=torch.channels_last)
    big[:, :16] = nchw
    grads = []
    for inp in (nchw.contiguous(),
                nchw.contiguous(memory_format=torch.channels_last),
                big[:, :16]):
        for impl in ("auto", "plain"):
            leaf = inp.detach().requires_grad_(True)
            before = kernels.launch_counts["max_pool_3x3_s2_bwd"]
            max_pool_3x3_s2(leaf, impl).backward(gn)
            assert (kernels.launch_counts["max_pool_3x3_s2_bwd"] - before
                    == (1 if impl == "auto" else 0))
            assert leaf.grad.dtype == x.dtype
            grads.append(leaf.grad.permute(0, 2, 3, 1).contiguous())
    torch.cuda.synchronize()
    for other in grads[1:]:
        assert torch.equal(grads[0], other)

    with pytest.raises(ValueError, match="expected"):
        max_pool_3x3_s2_bwd(x, g[:, :, :-1])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _launch_bwd(x.half(), g.half())
    with pytest.raises(ValueError, match="CUDA"):
        _launch_bwd(x, g.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        _launch_bwd(x.transpose(1, 2), g.transpose(1, 2))


# ---- fused self-attention (mmformer) and the dropout-mask generator ------

# the mmformer shapes of one training step (intra 196 tokens, inter 392,
# 8 heads of 64), ragged token counts, and head dims 16, 32 and 128; then
# the edges of #13's tiles: N = MAX_TOKENS (its 32-row blocks), N = 1000
# at d = 128 (f32: one chunk buffer, two do not fit), one token, C = 80
# (not a multiple of the projection's K step, 32 or 64) and d = 12 (bf16
# rows of q, k, v off 16 bytes: copied element by element)
SA_SHAPES = [(64, 196, 512, 8), (64, 392, 512, 8), (3, 197, 512, 8),
             (2, 52, 512, 8), (2, 9, 128, 8), (2, 70, 96, 3), (2, 33, 256, 2),
             (1, 1024, 512, 8), (1, 1000, 256, 2), (2, 1, 64, 1),
             (3, 45, 80, 5), (2, 20, 36, 3)]
SA_IDS = ["intra", "inter", "n197", "n52", "d16_n9", "d32", "d128",
          "n1024", "n1000_d128", "n1", "c80_d16", "c36_d12"]
SA_FWD_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
              "bfloat16": dict(atol=3e-2, rtol=1e-2)}
SA_GRAD_FRAC = {"float32": 2e-4, "bfloat16": 2e-2}


def _sa_inputs(cuda, b, n, c, dtype, seed):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3 * c, c))
                          * c ** -0.5).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    return x.to(cuda, dt), w.to(cuda, dt), g.to(cuda, dt)


def _grad_close(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    assert err <= SA_GRAD_FRAC[dtype] * float(want.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", ["none", "hbm", "kernel"])
@pytest.mark.parametrize("b,n,c,heads", SA_SHAPES, ids=SA_IDS)
def test_self_attention_kernels_match_plain(cuda, b, n, c, heads, dropout,
                                            dtype):
    """The training forward (out, qkv, p: f32 atol and rtol 2e-4, bf16
    atol 3e-2 + rtol 1e-2), the backward and the whole op's dx and dW
    (largest error within 2e-4 of the reference's largest |value| in f32,
    2e-2 in bf16), with no dropout, a mask read from memory, and a mask
    drawn in the kernel, whose bits must be the plain generator's."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.dropout import fold_seed_words
    from gdl_tpu_torch.ops.self_attention import (
        make_dropout,
        self_attention_fused,
        self_attention_fused_bwd,
        self_attention_fused_fwd,
    )

    x, w, g = _sa_inputs(cuda, b, n, c, dtype, seed=n + c)
    gen = torch.Generator(device=cuda).manual_seed(n)
    words = fold_seed_words(gen, cuda)
    drop = make_dropout(x, heads, 0.3, dropout != "none",
                        "kernel" if dropout == "none" else dropout,
                        seed_words=words)
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        got = self_attention_fused_fwd(x, w, heads, drop=drop,
                                       return_keep=True)
        want = self_attention_fused_fwd(x, w, heads, drop=drop, impl="plain",
                                        return_keep=True)
        for name, a, r in zip(("out", "qkv", "p"), got, want):
            torch.testing.assert_close(a.float(), r.float(),
                                       **SA_FWD_TOL[dtype], msg=name)
        if dropout == "kernel":
            assert torch.equal(got[3], want[3])
            rate = float(got[3].float().mean())
            sigma = (0.3 * 0.7 / got[3].numel()) ** 0.5
            assert abs(rate - 0.7) < 5 * sigma + 1e-9, rate
        _, qkv, p, _ = want
        dq_got = self_attention_fused_bwd(qkv, p, g, heads, drop=drop)
        dq_want = self_attention_fused_bwd(qkv, p, g, heads, drop=drop,
                                           impl="plain")
        _grad_close(dq_got, dq_want, dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts["self_attention_fused_fwd"] == \
        before["self_attention_fused_fwd"] + 1
    assert kernels.launch_counts["self_attention_fused_bwd"] == \
        before["self_attention_fused_bwd"] + 1
    grads = {}
    for impl in ("auto", "plain"):
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = self_attention_fused(
            xl, wl, heads, dropout_rate=0.3, seed_words=words,
            train=dropout != "none",
            dropout_impl="kernel" if dropout == "none" else dropout,
            impl=impl)
        out.backward(g)
        grads[impl] = (xl.grad, wl.grad)
    for a, r in zip(grads["auto"], grads["plain"]):
        _grad_close(a, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c,heads", SA_SHAPES, ids=SA_IDS)
def test_self_attention_eval_kernel_matches_plain(cuda, b, n, c, heads,
                                                  dtype):
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.self_attention import self_attention_fused_eval

    x, w, _ = _sa_inputs(cuda, b, n, c, dtype, seed=n + c + 1)
    before = kernels.launch_counts["self_attention_fused_eval"]
    with torch.no_grad():
        got = self_attention_fused_eval(x, w, heads)
        want = self_attention_fused_eval(x, w, heads, impl="plain")
    torch.cuda.synchronize()
    assert kernels.launch_counts["self_attention_fused_eval"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), **SA_FWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c,heads", SA_SHAPES[:2], ids=SA_IDS[:2])
def test_self_attention_eval_kernel_is_bit_equal_across_launches(
        cuda, b, n, c, heads, dtype):
    """#13 sums every output in one fixed order (no atomics, no split
    across blocks): two launches on the same inputs give the same bits."""
    from gdl_tpu_torch.ops.self_attention import self_attention_fused_eval

    x, w, _ = _sa_inputs(cuda, b, n, c, dtype, seed=n + c + 2)
    with torch.no_grad():
        first = self_attention_fused_eval(x, w, heads)
        second = self_attention_fused_eval(x, w, heads)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert bool(torch.isfinite(first.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", ["none", "hbm", "kernel"])
@pytest.mark.parametrize("b,n,c,heads", SA_SHAPES[:2] + SA_SHAPES[7:9],
                         ids=SA_IDS[:2] + SA_IDS[7:9])
def test_self_attention_train_kernels_are_bit_equal_across_launches(
        cuda, b, n, c, heads, dropout, dtype):
    """#10 (out, qkv, p, keep), #12 (out, p, keep) and #11 (dqkv) sum
    every output in one fixed order and draw the mask from the flat index
    alone: two launches on the same inputs give the same bits, finite and
    with p's rows summing to 1."""
    from gdl_tpu_torch.ops.dropout import fold_seed_words
    from gdl_tpu_torch.ops import self_attention as sa

    x, w, g = _sa_inputs(cuda, b, n, c, dtype, seed=n + c + 3)
    words = fold_seed_words(torch.Generator(device=cuda).manual_seed(n + 2),
                            cuda)
    drop = sa.make_dropout(x, heads, 0.1, dropout != "none",
                           "kernel" if dropout == "none" else dropout,
                           seed_words=words)
    with torch.no_grad():
        first = sa.self_attention_fused_fwd(x, w, heads, drop=drop,
                                            return_keep=True)
        second = sa.self_attention_fused_fwd(x, w, heads, drop=drop,
                                             return_keep=True)
        qkv = first[1]
        q1 = sa.self_attention_qkv_fwd(qkv, heads, drop=drop,
                                       return_keep=True)
        q2 = sa.self_attention_qkv_fwd(qkv, heads, drop=drop,
                                       return_keep=True)
        b1 = sa.self_attention_fused_bwd(qkv, first[2], g, heads, drop=drop)
        b2 = sa.self_attention_fused_bwd(qkv, first[2], g, heads, drop=drop)
    torch.cuda.synchronize()
    for a, r in list(zip(first, second)) + list(zip(q1, q2)) + [(b1, b2)]:
        assert (a is None and r is None) or torch.equal(a, r)
    for t in first[:3] + q1[:2] + (b1,):
        assert bool(torch.isfinite(t.float()).all())
    rows = first[2].float().sum(-1)
    torch.testing.assert_close(rows, torch.ones_like(rows),
                               atol=2e-5 if dtype == "float32" else 3e-2,
                               rtol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", ["none", "hbm", "kernel"])
@pytest.mark.parametrize("b,n,c,heads", [SA_SHAPES[2], SA_SHAPES[9]],
                         ids=[SA_IDS[2], SA_IDS[9]])
def test_self_attention_bwd_ds_scratch_matches_plain(cuda, b, n, c, heads,
                                                     dropout, dtype):
    """#11's part A writes ds = round_T(p * (dp - sum_j dp * p)) to the
    scratch the caller gives it, every element of it: within 2e-4 (f32) /
    2e-2 (bf16) of the plain ds's largest |value|, at a ragged N and at
    one token; the launch's dqkv is the op's to the bit."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import self_attention as sa
    from gdl_tpu_torch.ops.dropout import fold_seed_words

    x, w, g = _sa_inputs(cuda, b, n, c, dtype, seed=n + c + 5)
    words = fold_seed_words(torch.Generator(device=cuda).manual_seed(n + 5),
                            cuda)
    drop = sa.make_dropout(x, heads, 0.3, dropout != "none",
                           "kernel" if dropout == "none" else dropout,
                           seed_words=words)
    d = c // heads
    scale = d ** -0.5
    with torch.no_grad():
        _, qkv, p = sa.self_attention_fused_fwd(x, w, heads, drop=drop,
                                                impl="plain")
        ds = torch.full_like(p, float("nan"))
        dqkv = torch.empty_like(qkv)
        lib = kernels.load("self_attention_train")
        ptr = (lambda t: None if t is None else t.data_ptr())
        err = lib.gdl_sa_bwd_launch(
            qkv.data_ptr(), p.data_ptr(), ptr(drop.mask),
            ptr(drop.seed_words), g.data_ptr(), ds.data_ptr(),
            dqkv.data_ptr(), b, n, c, heads, d, scale, drop.mode,
            drop.keep_thresh, drop.inv_keep, *drop.layout,
            0 if dtype == "float32" else 1,
            torch.cuda.current_stream(cuda).cuda_stream)
        assert err == 0
        op = sa.self_attention_fused_bwd(qkv, p, g, heads, drop=drop)
        pf = p.float()
        v = qkv.reshape(b, n, 3, heads, d)[:, :, 2].float()
        dp = torch.einsum("bihd,bjhd->bhij",
                          g.reshape(b, n, heads, d).float(), v)
        m = drop.multiplier(pf.shape, torch.float32)
        if m is not None:
            dp = dp * m
        want = (pf * (dp - (dp * pf).sum(-1, keepdim=True))).to(p.dtype)
    torch.cuda.synchronize()
    assert torch.equal(dqkv, op)
    assert bool(torch.isfinite(ds.float()).all())
    _grad_close(ds, want, dtype)


@pytest.mark.cuda
def test_self_attention_kernels_refuse_what_they_cannot_take(cuda):
    from gdl_tpu_torch.ops.self_attention import (
        self_attention_fused,
        self_attention_fused_eval,
    )

    with torch.no_grad():
        with pytest.raises(ValueError, match="N <= 1024"):
            self_attention_fused_eval(torch.zeros(1, 1025, 64, device=cuda),
                                      torch.zeros(192, 64, device=cuda), 1)
        with pytest.raises(ValueError, match="head dim"):
            self_attention_fused_eval(torch.zeros(1, 8, 256, device=cuda),
                                      torch.zeros(768, 256, device=cuda), 1)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            self_attention_fused_eval(
                torch.zeros(1, 8, 64, device=cuda, dtype=torch.float16),
                torch.zeros(192, 64, device=cuda, dtype=torch.float16), 1)
        with pytest.raises(ValueError, match="w: expected"):
            self_attention_fused(torch.zeros(1, 8, 64, device=cuda),
                                 torch.zeros(64, 192, device=cuda), 1)
    x = torch.zeros(1, 8, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        self_attention_fused_eval(x, torch.zeros(192, 64, device=cuda), 1)


# elements a block writes in one round of its walk (256 threads, four
# Philox groups a thread) and the most blocks an SM holds (2048 threads)
MASK_BLOCK_ROUND = 256 * 4 * 4
MASK_MAX_BLOCKS_PER_SM = 8


def _mask_check(cuda, shape, dt, gen):
    """One kernel mask against the plain version; returns the mask."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.dropout import fold_seed_words, prng_dropout_mask

    words = fold_seed_words(gen, cuda)
    before = kernels.launch_counts["prng_dropout_mask"]
    got = prng_dropout_mask(words, shape, 0.1, dt)
    want = prng_dropout_mask(words, shape, 0.1, dt, impl="plain")
    torch.cuda.synchronize()
    assert kernels.launch_counts["prng_dropout_mask"] == before + 1
    assert got.dtype == dt and tuple(got.shape) == tuple(shape)
    assert torch.equal(got, want), shape
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(12544, 512), (12544, 4096), (25088, 512),
                                   (25088, 4096), (7, 13), (3, 5, 2),
                                   (3, 44), (1, 1029), (1, 100), (1, 5),
                                   (1,), None],
                         ids=["intra512", "intra4096", "inter512",
                              "inter4096", "ragged", "tail", "mod8is4",
                              "mod8is5", "below_a_warp", "one_group",
                              "one", "past_one_pass"])
def test_dropout_mask_kernel_is_bit_equal_to_plain(cuda, shape, dtype):
    """Kernel #14 against the generator in torch integer arithmetic: the
    same bits, values exactly {0, 1/(1-rate)} in the mask's dtype. Besides
    the mmformer shapes: n not a multiple of 4 or of 8 (the elements past
    the last 16-byte store), n below one warp's groups, and
    ("past_one_pass") n just past one round of the resident grid, for
    every number of blocks an SM could hold: a few elements, a group and
    a block's round more (the stores left over after the walk)."""
    from gdl_tpu_torch.ops.dropout import fold_seed_words, prng_dropout_mask

    dt = getattr(torch, dtype)
    if shape is None:
        gen = torch.Generator(device=cuda).manual_seed(77)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        for per_sm in range(1, MASK_MAX_BLOCKS_PER_SM + 1):
            one_pass = sms * per_sm * MASK_BLOCK_ROUND
            for extra in (3, 8, MASK_BLOCK_ROUND + 12):
                _mask_check(cuda, (one_pass + extra,), dt, gen)
        return
    gen = torch.Generator(device=cuda).manual_seed(len(shape) + shape[0])
    got = _mask_check(cuda, shape, dt, gen)
    kept = torch.tensor(1.0 / 0.9, dtype=torch.float32).to(dt)
    assert set(got.unique().tolist()) <= {0.0, float(kept)}
    if got.numel() > 10 ** 6:
        rate = float((got != 0).float().mean())
        assert abs(rate - 0.9) < 5 * (0.09 / got.numel()) ** 0.5
    other = prng_dropout_mask(fold_seed_words(gen, cuda), shape, 0.1, dt)
    if got.numel() > 64:
        assert not torch.equal(got, other)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_kernels_at_an_offset_are_the_slice_of_the_global_mask(
        cuda, dtype):
    """#14 and the in-kernel masks of #10 / #11 / #12 at an element offset
    (a rank's first row of a data-parallel batch): the second half of a
    batch computed alone at its offset has, bit for bit, the global
    launch's second half and the plain version's bits at that offset; #14
    also past 2^32 elements (the 64-bit counter)."""
    from gdl_tpu_torch.ops import self_attention as sa
    from gdl_tpu_torch.ops.dropout import (
        philox_keep_mask,
        prng_dropout_mask,
        prng_dropout_mask_ref,
    )

    dt = getattr(torch, dtype)
    words = torch.tensor([1234, -5678], dtype=torch.int32, device=cuda)
    whole = prng_dropout_mask(words, (8, 3, 44), 0.1, dt)
    part = prng_dropout_mask(words, (4, 3, 44), 0.1, dt, offset=4 * 132)
    assert torch.equal(part, whole[4:])
    for offset in (4 * 132, 2 ** 32 - 8):
        got = prng_dropout_mask(words, (4, 3, 44), 0.1, dt, offset=offset)
        want = prng_dropout_mask_ref(words, (4, 3, 44), 0.1, dt, offset)
        assert torch.equal(got, want), offset

    b, n, c, heads = 4, 40, 64, 2
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((b, n, c), generator=gen, device=cuda).to(dt)
    w = (torch.randn((3 * c, c), generator=gen, device=cuda)
         * c ** -0.5).to(dt)
    g = torch.randn((b, n, c), generator=gen, device=cuda).to(dt)
    drop = sa.make_dropout(x, heads, 0.2, True, "kernel", words)
    out, qkv, p, keep = sa.self_attention_fused_fwd(x, w, heads, drop=drop,
                                                    return_keep=True)
    dqkv = sa.self_attention_fused_bwd(qkv, p, g, heads, drop=drop)
    offset = 2 * heads * n * n
    d = sa.make_dropout(x[2:], heads, 0.2, True, "kernel", words,
                        offset=offset)
    o2, q2, p2, k2 = sa.self_attention_fused_fwd(x[2:].contiguous(), w,
                                                 heads, drop=d,
                                                 return_keep=True)
    assert torch.equal(k2, keep[2:])
    assert torch.equal(k2, philox_keep_mask(words, k2.shape, 0.2, offset)
                       .to(torch.uint8))
    assert torch.equal(o2, out[2:]) and torch.equal(p2, p[2:])
    d2 = sa.self_attention_fused_bwd(q2, p2, g[2:].contiguous(), heads,
                                     drop=d)
    assert torch.equal(d2, dqkv[2:])
    # #12 draws its mask in the kernel as #10 does
    o12, p12, k12 = sa.self_attention_qkv_fwd(q2, heads, drop=d,
                                              return_keep=True)
    assert torch.equal(k12, keep[2:]) and torch.equal(p12, p2)


def _stack_rows(world, rank, b, passes=3):
    big = world * b
    return torch.cat([torch.arange(p * big + rank * b, p * big + rank * b + b)
                      for p in range(passes)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_kernels_in_three_segments_are_a_ranks_rows(cuda, dtype):
    """#14 and the in-kernel masks of #10 / #11 / #12 in the three-segment
    layout of `element_layout(passes=3)` (a rank's [3b] stack of three
    passes' batches under --batched_inter 1): bit for bit the plain
    version's and the rank's rows of the global [3B] launch. #14 at
    segments of 12 elements (a bf16 store of 8 spans two segments, each
    group its own counter) and at a layout past 2^32 (the 64-bit
    counter); #10 at N = 10 (rows start inside Philox groups). A one-
    segment layout gives the element offset's bits."""
    from gdl_tpu_torch.ops import self_attention as sa
    from gdl_tpu_torch.ops.dropout import (
        philox_keep_mask,
        prng_dropout_mask,
        prng_dropout_mask_ref,
    )

    dt = getattr(torch, dtype)
    words = torch.tensor([2468, -1357], dtype=torch.int32, device=cuda)
    for world, b, row in ((2, 1, (3, 4)), (2, 3, (5, 44)), (4, 2, (7, 8))):
        per = row[0] * row[1]
        whole = prng_dropout_mask(words, (3 * world * b,) + row, 0.1, dt)
        for k in range(world):
            lay = (k * b * per, b * per, world * b * per)
            got = prng_dropout_mask(words, (3 * b,) + row, 0.1, dt,
                                    offset=lay)
            assert torch.equal(got, whole[_stack_rows(world, k, b)])
            assert torch.equal(got, prng_dropout_mask_ref(
                words, (3 * b,) + row, 0.1, dt, lay))
    far = (2 ** 32 - 8, 132, 2 * 132)
    assert torch.equal(
        prng_dropout_mask(words, (3, 132), 0.1, dt, offset=far),
        prng_dropout_mask_ref(words, (3, 132), 0.1, dt, far))
    assert torch.equal(
        prng_dropout_mask(words, (4, 3, 44), 0.1, dt, offset=(528, 8, 8)),
        prng_dropout_mask(words, (4, 3, 44), 0.1, dt, offset=528))

    world, b, n, c, heads = 2, 2, 10, 64, 2
    big = 3 * world * b
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((big, n, c), generator=gen, device=cuda).to(dt)
    w = (torch.randn((3 * c, c), generator=gen, device=cuda)
         * c ** -0.5).to(dt)
    g = torch.randn((big, n, c), generator=gen, device=cuda).to(dt)
    drop = sa.make_dropout(x, heads, 0.2, True, "kernel", words)
    out, qkv, p, keep = sa.self_attention_fused_fwd(x, w, heads, drop=drop,
                                                    return_keep=True)
    dqkv = sa.self_attention_fused_bwd(qkv, p, g, heads, drop=drop)
    per = heads * n * n
    for k in range(world):
        rows = _stack_rows(world, k, b)
        lay = (k * b * per, b * per, world * b * per)
        d = sa.make_dropout(x[rows], heads, 0.2, True, "kernel", words,
                            offset=lay)
        o2, q2, p2, k2 = sa.self_attention_fused_fwd(
            x[rows].contiguous(), w, heads, drop=d, return_keep=True)
        assert torch.equal(k2, keep[rows])
        assert torch.equal(k2, philox_keep_mask(words, k2.shape, 0.2, lay)
                           .to(torch.uint8))
        assert torch.equal(o2, out[rows]) and torch.equal(p2, p[rows])
        assert torch.equal(sa.self_attention_fused_bwd(
            q2, p2, g[rows].contiguous(), heads, drop=d), dqkv[rows])
        o12, p12, k12 = sa.self_attention_qkv_fwd(q2, heads, drop=d,
                                                  return_keep=True)
        assert torch.equal(k12, keep[rows]) and torch.equal(p12, p2)


# ---------------------------------------------------------------------------
# the Swin flag paths: kernels #5, #4-delta, #3 and #15
# ---------------------------------------------------------------------------

# a shape with head dim 64 (the fused backward's 128-column tile) besides
FLAG_SHAPES = TRAIN_SHAPES + [(8, 128, 2, 14, 7)]
FLAG_IDS = TRAIN_IDS + ["d64"]


def _saved(cuda, bw, c, heads, res, window, dtype):
    """(args, bias, mask, out, qkv, p, dout) from the plain forward."""
    args, bias_t, mask_t = _train_case(cuda, bw, c, heads, res, window,
                                       dtype)
    with torch.no_grad():
        out, qkv, p = window_attention_qkv_fused_fwd(*args, bias_t, mask_t,
                                                     heads, impl="plain")
    gen = torch.Generator(device=cuda).manual_seed(bw)
    dout = torch.randn(args[0].shape, generator=gen, device=cuda).to(
        args[0].dtype)
    return args, bias_t, mask_t, out, qkv, p, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,c,heads,res,window", FLAG_SHAPES, ids=FLAG_IDS)
def test_qkv_savep_kernel_matches_plain(cuda, bw, c, heads, res, window,
                                        dtype):
    """Kernel #5 on a given qkv: out and p against the plain forward, and
    against kernel #2's from the same qkv (equal bits: the same code after
    the projection); one launch counted; equal bits on a second run."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.window_attention import window_attention_qkv_fwd

    args, bias_t, mask_t, _, qkv, _, _ = _saved(cuda, bw, c, heads, res,
                                                window, dtype)
    before = kernels.launch_counts["window_attention_qkv_savep"]
    with torch.no_grad():
        got = window_attention_qkv_fwd(qkv, bias_t, mask_t, heads)
        again = window_attention_qkv_fwd(qkv, bias_t, mask_t, heads)
        want = window_attention_qkv_fwd(qkv, bias_t, mask_t, heads,
                                        impl="plain")
        k2 = window_attention_qkv_fused_fwd(*args, bias_t, mask_t, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts["window_attention_qkv_savep"] == before + 2
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, a)
        _close(g, w, dtype, "fwd")
    if torch.equal(k2[1], qkv):  # kernel #2 projected to the same bits
        assert torch.equal(got[0], k2[0]) and torch.equal(got[1], k2[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,c,heads,res,window", FLAG_SHAPES, ids=FLAG_IDS)
def test_bwd_delta_kernel_matches_plain_and_default(cuda, bw, c, heads, res,
                                                    window, dtype):
    """Kernel #4-delta against its plain version from the same qkv, p and
    delta, and against the default kernel #4 (delta from the rounded out
    differs from the f32 row sums only by out's rounding); equal bits on a
    second run; one launch counted per call and none of #4."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.window_attention import attention_delta

    _, _, _, out, qkv, p, dout = _saved(cuda, bw, c, heads, res, window,
                                        dtype)
    name = "window_attention_qkv_fused_bwd_delta"
    with torch.no_grad():
        delta = attention_delta(out, dout, heads)
        assert delta.dtype == torch.float32
        assert tuple(delta.shape) == (bw, heads, out.shape[1])
        before = dict(kernels.launch_counts)
        got = window_attention_qkv_fused_bwd(qkv, p, dout, heads, delta=delta)
        again = window_attention_qkv_fused_bwd(qkv, p, dout, heads,
                                               delta=delta)
        counts = dict(kernels.launch_counts)
        want = window_attention_qkv_fused_bwd(qkv, p, dout, heads,
                                              impl="plain", delta=delta)
        default = window_attention_qkv_fused_bwd(qkv, p, dout, heads)
    torch.cuda.synchronize()
    assert counts[name] == before[name] + 2
    assert counts["window_attention_qkv_fused_bwd"] == \
        before["window_attention_qkv_fused_bwd"]
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    for g, w, dflt in zip(got, want, default):
        _close(g, w, dtype, "grad")
        _close(g, dflt, dtype, "grad")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,c,heads,res,window", FLAG_SHAPES, ids=FLAG_IDS)
def test_bwd_fused_kernel_matches_plain_and_split(cuda, bw, c, heads, res,
                                                  window, dtype):
    """Kernel #3: dx, dW, db and dbias against its plain version and
    against kernel #4 followed by the three GEMMs; equal bits on a second
    run; through the op under FUSED_PROJECTION_BACKWARD it replaces #4."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import window_attention as wa

    args, bias_t, mask_t, _, qkv, p, dout = _saved(cuda, bw, c, heads, res,
                                                   window, dtype)
    x, w = args[0], args[1]
    name = "window_attention_qkv_fused_bwd_fused"
    with torch.no_grad():
        before = kernels.launch_counts[name]
        got = wa.window_attention_qkv_fused_bwd_fused(qkv, p, dout, x, w,
                                                      heads)
        again = wa.window_attention_qkv_fused_bwd_fused(qkv, p, dout, x, w,
                                                        heads)
        assert kernels.launch_counts[name] == before + 2
        want = wa.window_attention_qkv_fused_bwd_fused(qkv, p, dout, x, w,
                                                       heads, impl="plain")
        dqkv, dbias = window_attention_qkv_fused_bwd(qkv, p, dout, heads)
        split = (*wa._projection_bwd(dqkv, x, w), dbias)
    torch.cuda.synchronize()
    for g, a, wnt, s in zip(got, again, want, split):
        assert g.dtype == wnt.dtype and g.shape == wnt.shape
        assert torch.equal(g, a)
        _close(g, wnt, dtype, "grad")
        _close(g, s, dtype, "grad")

    grads = {}
    try:
        for mode in (True, "auto", False):
            wa.FUSED_PROJECTION_BACKWARD = mode
            leaves = [a.clone().requires_grad_(True) for a in args + [bias_t]]
            before = dict(kernels.launch_counts)
            out = window_attention_qkv_fused(*leaves[:3], leaves[3], mask_t,
                                             heads)
            out.backward(dout)
            fused = kernels.launch_counts[name] - before[name]
            default = (kernels.launch_counts["window_attention_qkv_fused_bwd"]
                       - before["window_attention_qkv_fused_bwd"])
            assert (fused, default) == ((1, 0) if mode else (0, 1))
            grads[mode] = [t.grad for t in leaves]
    finally:
        wa.FUSED_PROJECTION_BACKWARD = False
    for g, a, s in zip(grads[True], grads["auto"], grads[False]):
        assert torch.equal(g, a)
        _close(g, s, dtype, "grad")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_op_runs_kernels_5_and_4_or_delta(cuda, dtype):
    """window_attention_qkv on the card: #5 forward, then #4, or #4-delta
    under BWD_DELTA; gradients against the plain op."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import window_attention as wa

    _, bias_t, mask_t, _, qkv, _, dout = _saved(cuda, 128, 512, 16, 14, 7,
                                                dtype)
    names = ("window_attention_qkv_savep", "window_attention_qkv_fused_bwd",
             "window_attention_qkv_fused_bwd_delta")
    grads = {}
    try:
        for delta in (False, True):
            wa.BWD_DELTA = delta
            for impl in ("auto", "plain"):
                leaves = [qkv.clone().requires_grad_(True),
                          bias_t.clone().requires_grad_(True)]
                before = dict(kernels.launch_counts)
                out = wa.window_attention_qkv(
                    leaves[0].reshape(128, 49, 3, 512), leaves[1], mask_t, 16,
                    impl=impl)
                out.backward(dout)
                ran = tuple(kernels.launch_counts[k] - before[k]
                            for k in names)
                want = (0, 0, 0) if impl == "plain" else (
                    (1, 0, 1) if delta else (1, 1, 0))
                assert ran == want
                grads[(delta, impl)] = [t.grad for t in leaves]
    finally:
        wa.BWD_DELTA = False
    for delta in (False, True):
        for g, w in zip(grads[(delta, "auto")], grads[(delta, "plain")]):
            assert g.shape == w.shape
            _close(g, w, dtype, "grad")


# x [M, C] of the MLP of each Swin-B stage at batch 32 (both encoders see
# the same), a ragged M, and a C and hidden that are no multiples of 64;
# then the edges of the GEMM tile: C = 100 (bf16 rows of x and w1 off 16
# bytes: the element-by-element copies), an odd hidden (fc1's unpaired
# bf16 store, and g's rows off 16 bytes for fc2), one row, and M = 1568 at
# C = 512, where f32's fc1 takes the 64-row tile (as fc2 does at stage2)
MLP_SHAPES = [(100352, 128, 512), (25088, 256, 1024), (6272, 512, 2048),
              (1568, 1024, 4096), (1000, 96, 200), (777, 100, 400),
              (300, 64, 255), (1, 128, 512), (1568, 512, 2048)]
MLP_IDS = ["stage0", "stage1", "stage2", "stage3", "ragged", "c100",
           "odd_hidden", "m1", "m1568_bm64"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,c,hidden", MLP_SHAPES, ids=MLP_IDS)
def test_mlp_kernel_matches_plain(cuda, m, c, hidden, dtype):
    """Kernel #15 against its plain version (the same erf approximation):
    f32 atol and rtol 2e-4, bf16 atol 3e-2 and rtol 1e-2; against the
    exact-GELU chain at the same bars; equal bits on a second run; one
    launch counted per call; gradients are the plain chain's."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.mlp import (
        mlp_fused,
        mlp_fused_fwd,
        mlp_kernel_supported,
        mlp_ref,
    )

    rng = np.random.default_rng(m)
    dt = getattr(torch, dtype)
    arrays = (rng.standard_normal((m, c)),
              rng.standard_normal((hidden, c)) * c ** -0.5,
              rng.standard_normal(hidden) * 0.1,
              rng.standard_normal((c, hidden)) * hidden ** -0.5,
              rng.standard_normal(c) * 0.1)
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda, dt)
            for a in arrays]
    assert mlp_kernel_supported(m, c, hidden, dt)
    before = kernels.launch_counts["mlp_fused"]
    with torch.no_grad():
        got = mlp_fused_fwd(*args)
        again = mlp_fused_fwd(*args)
        want = mlp_fused_fwd(*args, impl="plain")
        exact = mlp_ref(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["mlp_fused"] == before + 2
    assert got.dtype == dt and got.shape == want.shape
    assert torch.equal(got, again)
    _close(got, want, dtype, "fwd")
    _close(got, exact, dtype, "fwd")

    grads = {}
    for op in (mlp_fused, mlp_ref):
        leaves = [a.clone().requires_grad_(True) for a in args]
        op(*leaves).backward(torch.ones_like(got))
        grads[op] = [t.grad for t in leaves]
    for g, w in zip(grads[mlp_fused], grads[mlp_ref]):
        _close(g, w, dtype, "grad")


@pytest.mark.cuda
def test_mlp_and_projection_gemms_are_distinct_instantiations(cuda):
    """#15, #13 and #3 all run the shared GEMM tile. A call of each counts
    one launch under its own name only, and a profiler trace of each shows
    #15's fc1 and fc2 under symbols of their own epilogues (namespace
    mlp), which profile_step files under #15, #13's projection under the
    identity's, filed under #13, and #3's dx and dW products under the
    epilogues of namespace wa3, filed under #3, in both dtypes. Every
    kernel symbol a trace saw is printed, so a failure shows them."""
    from torch.profiler import ProfilerActivity, profile

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import window_attention as wa
    from gdl_tpu_torch.ops.mlp import mlp_fused_fwd
    from gdl_tpu_torch.ops.self_attention import self_attention_fused_eval
    from gdl_tpu_torch.profile_step import kind_of

    gen = torch.Generator(device=cuda).manual_seed(15)
    rand = lambda *s: torch.randn(s, generator=gen, device=cuda)  # noqa
    margs = (rand(256, 128), rand(512, 128), rand(512), rand(128, 512),
             rand(128))
    x, w = rand(2, 64, 128), rand(384, 128) * 128 ** -0.5
    # #3 on 6 windows of 50 tokens at C = 128 (4 heads): qkv, p, dout, x, w
    bargs = {dt: [t.to(dt) for t in (
        rand(6, 50, 384), torch.softmax(rand(6, 4, 50, 50), -1),
        rand(6, 50, 128), rand(6, 50, 128), rand(384, 128) * 128 ** -0.5)]
        for dt in (torch.float32, torch.bfloat16)}
    calls = {
        "mlp_fused": lambda: mlp_fused_fwd(*margs),
        "self_attention_fused_eval": lambda: self_attention_fused_eval(x, w,
                                                                       4),
        wa.BWD_FUSED_KERNEL_NAME: lambda: [
            wa.window_attention_qkv_fused_bwd_fused(*a, 4)
            for a in bargs.values()],
    }
    gemms = {}
    with torch.no_grad():
        for name, call in calls.items():
            call()  # built, loaded and warm before the trace
            torch.cuda.synchronize()
            before = dict(kernels.launch_counts)
            # twice in the trace: a trace once kept only #13's attention
            # kernel, without the projection launched just before it as
            # the trace's first kernel
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                call()
                torch.cuda.synchronize()
            after = dict(kernels.launch_counts)
            seen = sorted({e.key for e in prof.key_averages()})
            print(name, "traced:", seen)
            calls_made = 2 * (2 if name == wa.BWD_FUSED_KERNEL_NAME else 1)
            assert {k for k in calls if after[k] != before[k]} == {name}, \
                (name, seen)
            assert after[name] - before[name] == calls_made, (name, seen)
            gemms[name] = {k for k in seen if "gemm_tile_kernel" in k}
    mlp_gemms = gemms["mlp_fused"]
    sa_gemms = gemms["self_attention_fused_eval"]
    wa3_gemms = gemms[wa.BWD_FUSED_KERNEL_NAME]
    assert len(mlp_gemms) == 2 and len(sa_gemms) == 1, gemms
    assert len(wa3_gemms) == 4, gemms  # dx and dW, in two dtypes
    assert not (mlp_gemms & sa_gemms or mlp_gemms & wa3_gemms
                or sa_gemms & wa3_gemms), gemms
    assert {kind_of(k) for k in mlp_gemms} == {"mlp_fused (#15)"}, gemms
    assert any("Fc1" in k for k in mlp_gemms), gemms
    assert any("Fc2" in k for k in mlp_gemms), gemms
    assert "#13" in kind_of(next(iter(sa_gemms))), gemms
    assert {kind_of(k) for k in wa3_gemms} == {
        "window_attention_bwd_fused (#3)"}, gemms
    assert sum("wa3::Dx" in k for k in wa3_gemms) == 2, gemms
    assert sum("wa3::DwPart" in k for k in wa3_gemms) == 2, gemms


# ---- kernel #3's products on the GEMM tile's second and third layouts -----

# (bw, N, C, heads) through #3's own entry: the four Swin-B stages at
# batch 32, then the tile's edges: 1000 tokens (20 windows of 50: a ragged
# M, and by the split rule runs of 384 tokens with a ragged last one of
# 232), C = 100 (two heads of 50: bf16 rows of dqkv, x and W off 16 bytes,
# the element-by-element copies; 777 tokens in runs of 320), C = 1 (one
# head of 1: N = 1, f32 rows off 16 bytes too), one token
PRODUCT_SHAPES = [(2048, 49, 128, 4), (512, 49, 256, 8), (128, 49, 512, 16),
                  (32, 49, 1024, 32), (20, 50, 96, 3), (21, 37, 100, 2),
                  (6, 50, 1, 1), (1, 1, 64, 2)]
PRODUCT_IDS = ["stage0", "stage1", "stage2", "stage3", "ragged_split",
               "c100", "n1", "one_token"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,n,c,heads", PRODUCT_SHAPES, ids=PRODUCT_IDS)
def test_gemm_tile_layouts_match_matmul(cuda, bw, n, c, heads, dtype):
    """#3's products on the GEMM tile, through #3's own launches, with #4's
    dqkv (the same device code, so the same bits as #3's workspace, which
    is checked) as the matmul operand: dx = dqkv·W (A along K, B = W
    [3C, C] along N) against torch.matmul in the same dtype at the forward
    bar; each f32 partial of dW = dqkvᵀ·x (both operands along M and N),
    unrounded, against the f32 product of its run of tokens, within 2e-4
    of the largest |value| in both dtypes (a rounding to bf16 would be 4e-3
    off); their sum likewise against the whole product; the op's dx and
    dW are these; equal bits on a second run."""
    from gdl_tpu_torch.ops import window_attention as wa

    rng = np.random.default_rng(bw * n + c)
    dt = getattr(torch, dtype)
    tokens = bw * n
    scores = rng.standard_normal((bw, heads, n, n))
    p = np.exp(scores - scores.max(-1, keepdims=True))
    qkv, p, dout, x, w = [torch.from_numpy(a.astype(np.float32)).to(cuda, dt)
                          for a in (
        rng.standard_normal((bw, n, 3 * c)), p / p.sum(-1, keepdims=True),
        rng.standard_normal((bw, n, c)), rng.standard_normal((bw, n, c)),
        rng.standard_normal((3 * c, c)) * c ** -0.5)]
    scale = (c // heads) ** -0.5
    kc = wa._fused_bwd_split(tokens, c)
    with torch.no_grad():
        ws, dx, parts, _, _ = wa._launch_bwd_fused_parts(qkv, p, dout, x, w,
                                                         heads, scale)
        _, dx2, parts2, _, _ = wa._launch_bwd_fused_parts(qkv, p, dout, x, w,
                                                          heads, scale)
        op = wa.window_attention_qkv_fused_bwd_fused(qkv, p, dout, x, w,
                                                     heads)
        dqkv, _ = window_attention_qkv_fused_bwd(qkv, p, dout, heads)
        dqkv = dqkv.reshape(tokens, 3 * c)
        want_dx = torch.matmul(dqkv, w)
        f32 = (dqkv.float(), x.reshape(tokens, c).float())
        want_parts = [torch.matmul(f32[0][k:k + kc].t(), f32[1][k:k + kc])
                      for k in range(0, tokens, kc)]
        want_dw = torch.matmul(f32[0].t(), f32[1])
    torch.cuda.synchronize()
    assert torch.equal(ws.reshape(tokens, 3 * c), dqkv)
    assert dx.dtype == dt and tuple(dx.shape) == (bw, n, c)
    assert parts.dtype == torch.float32
    assert tuple(parts.shape) == (len(want_parts), 3 * c, c)
    assert torch.equal(dx, dx2) and torch.equal(parts, parts2)
    assert torch.equal(op[0], dx)
    assert torch.equal(op[1], parts.sum(0).to(dt))
    _close(dx.reshape(tokens, c), want_dx, dtype, "fwd")
    for got, want in zip(parts, want_parts):
        _close(got, want, "float32", "grad")
    _close(parts.sum(0), want_dw, "float32", "grad")


def _bits(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes."""
    t = t.detach().contiguous()
    t = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def _tile_digests(cuda) -> dict:
    """The bits of #13's, #10's and #15's instantiations of the GEMM tile
    on fixed inputs (numpy seeds): #13's eval output, #10's out, qkv (its
    projection) and p, and #15's output at stage 2 (f32 fc2 on the 64-row
    tile), M = 1568 at C = 512 (f32 fc1 on it), C = 100 (rows off 16
    bytes) and an odd hidden; both dtypes. Name -> SHA-256."""
    from gdl_tpu_torch.ops import self_attention as sa
    from gdl_tpu_torch.ops.mlp import mlp_fused_fwd

    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        x, w, _ = _sa_inputs(cuda, 8, 196, 512, dtype, seed=1310)
        with torch.no_grad():
            out["13_eval_" + dtype] = _bits(sa.self_attention_fused_eval(
                x, w, 8))
            for name, t in zip(("out", "qkv", "p"),
                               sa.self_attention_fused_fwd(x, w, 8)):
                out[f"10_{name}_{dtype}"] = _bits(t)
            for m, c, hidden in ((6272, 512, 2048), (1568, 512, 2048),
                                 (777, 100, 400), (300, 64, 255)):
                rng = np.random.default_rng(m + c + hidden)
                arrays = (rng.standard_normal((m, c)),
                          rng.standard_normal((hidden, c)) * c ** -0.5,
                          rng.standard_normal(hidden) * 0.1,
                          rng.standard_normal((c, hidden)) * hidden ** -0.5,
                          rng.standard_normal(c) * 0.1)
                args = [torch.from_numpy(a.astype(np.float32)).to(cuda, dt)
                        for a in arrays]
                out[f"15_{m}_{c}_{hidden}_{dtype}"] = _bits(
                    mlp_fused_fwd(*args))
    return out


# _tile_digests as the tree gave them before #3's layouts and f32 partial
# store were added to the tile (the parent commit's kernels, run on an
# NVIDIA H100 80GB HBM3 by this file's _tile_digests)
TILE_DIGESTS_BEFORE = {
    "10_out_bfloat16":
        "8da876e277de4982d8967b59b61477b704f2caa81e5bd33fd8bdf831d59bd2d7",
    "10_out_float32":
        "bdf1883b0ab1937e43d1d7f29d45e89399405d86b0568a1697f739bc9bcef288",
    "10_p_bfloat16":
        "11ef4ff637475dcd9be75d7588ae810f3dbaed01d01d00f775b09d5917d5c8e0",
    "10_p_float32":
        "95efabddfdc8698bc2dbe00075e3c7705f0183fb10a8af8862cbaa49ba5af1b4",
    "10_qkv_bfloat16":
        "16197adb9a3e0a296a6ff8ac53d1afc01247d64e2808a114aeaab638a38762bc",
    "10_qkv_float32":
        "48f59b82c5d0c6b4256041ef95f718f0550f78e5a823c390c8e65a33fe0d0bc2",
    "13_eval_bfloat16":
        "cd69569b6f21a620523094cd4cb8b73c777ccaac3d769297f7a69047a8a8d016",
    "13_eval_float32":
        "1c00502c1050accec177c00008df9e3fc7c80f5a3c26d4754c9b875a35699612",
    "15_1568_512_2048_bfloat16":
        "bd9455517de644950e956876c8f51631fd67d9c5ef18869f6c12534c77545f60",
    "15_1568_512_2048_float32":
        "b3e1d06b0c9621c8c7b3f3953c716f9ace2cfedc4dfcead02b3c7991e2545034",
    "15_300_64_255_bfloat16":
        "f0764ced057018bd1a61af7b5869e9d0cf9def4178b507c6b37272b162ac938a",
    "15_300_64_255_float32":
        "3f9e034cc466338e11fdfebb810cb68d5ca9024b3e6b7d208a655709c0815011",
    "15_6272_512_2048_bfloat16":
        "3e4da79881fc4a46d0aad50cf5301982fad8de82988c89e70089dd7d92549086",
    "15_6272_512_2048_float32":
        "8f17abbe42d3b00552ec303a79e72f99437c1677c5091ef8f26668dd819b56f7",
    "15_777_100_400_bfloat16":
        "750bb257ee4c55bd86d28f6ce7630d7c285c45cc722f56e961fa7a1819073ae2",
    "15_777_100_400_float32":
        "ded6524ec8eda385a1b688dfce6e5a08486855b687fa7f84e2e589c989cf7843",
}


@pytest.mark.cuda
def test_tile_instantiations_of_13_10_15_keep_their_bits(cuda):
    """#13's, #10's and #15's instantiations of the GEMM tile give the
    same bits as before the tile took #3's layouts and partial store."""
    got = _tile_digests(cuda)
    assert set(got) == set(TILE_DIGESTS_BEFORE)
    changed = sorted(k for k in got if got[k] != TILE_DIGESTS_BEFORE[k])
    assert not changed, changed


def _rows_digests(cuda) -> dict:
    """The bits of the row tile's forward kernels on fixed inputs (numpy
    and torch seeds): #10's out, qkv, p and keep bytes, #12's out, p and
    keep bytes on #10's qkv, each with no dropout, a mask read from
    memory and a mask drawn in the kernel, and #13's out; at N = 196, a
    ragged N = 197 and N = 1000 at d = 128; both dtypes. Name -> SHA-256."""
    from gdl_tpu_torch.ops import self_attention as sa
    from gdl_tpu_torch.ops.dropout import fold_seed_words

    out = {}
    for dtype in ("float32", "bfloat16"):
        for b, n, c, heads in ((8, 196, 512, 8), (3, 197, 512, 8),
                               (1, 1000, 256, 2)):
            x, w, _ = _sa_inputs(cuda, b, n, c, dtype, seed=1400 + n)
            tag = f"{n}_{dtype}"
            with torch.no_grad():
                out["13_out_" + tag] = _bits(
                    sa.self_attention_fused_eval(x, w, heads))
                for mode in ("none", "hbm", "kernel"):
                    words = fold_seed_words(
                        torch.Generator(device=cuda).manual_seed(n), cuda)
                    drop = sa.make_dropout(
                        x, heads, 0.1, mode != "none",
                        "kernel" if mode == "none" else mode,
                        seed_words=words)
                    got = sa.self_attention_fused_fwd(x, w, heads, drop=drop,
                                                      return_keep=True)
                    for name, t in zip(("out", "qkv", "p", "keep"), got):
                        if t is not None:  # keep: bytes, hashed as int32
                            out[f"10_{name}_{mode}_{tag}"] = _bits(
                                t.int() if name == "keep" else t)
                    got = sa.self_attention_qkv_fwd(got[1], heads, drop=drop,
                                                    return_keep=True)
                    for name, t in zip(("out", "p", "keep"), got):
                        if t is not None:
                            out[f"12_{name}_{mode}_{tag}"] = _bits(
                                t.int() if name == "keep" else t)
    return out


# _rows_digests as the parent tree's kernels gave them (run on an NVIDIA
# H100 80GB HBM3 by this file's _rows_digests), before the row tile took
# #11's backward mode
ROWS_DIGESTS_BEFORE = {
    "10_keep_kernel_1000_bfloat16":
        "73aba23235a8b72fa3486cdf18cd7b9989ca9a6f673bfc0454d6a75c19cd4427",
    "10_keep_kernel_1000_float32":
        "73aba23235a8b72fa3486cdf18cd7b9989ca9a6f673bfc0454d6a75c19cd4427",
    "10_keep_kernel_196_bfloat16":
        "43776ae4bd780ab53249dd01ab694e9d28251c431528012d87932d4d72008240",
    "10_keep_kernel_196_float32":
        "43776ae4bd780ab53249dd01ab694e9d28251c431528012d87932d4d72008240",
    "10_keep_kernel_197_bfloat16":
        "0559302311258cf8da2389b80df8918d7a8b564b6650b88b447db2ee8c65ab57",
    "10_keep_kernel_197_float32":
        "0559302311258cf8da2389b80df8918d7a8b564b6650b88b447db2ee8c65ab57",
    "10_out_hbm_1000_bfloat16":
        "e9a6e807a34f092f3dee8469d627716b3c4cbdfbac16c9a60fcdfd2c46a0fa2c",
    "10_out_hbm_1000_float32":
        "eff8d4b18c4566851a04a0f5b74aaff5d8df20fcefa9bfe3729f938bbee7077e",
    "10_out_hbm_196_bfloat16":
        "d1056b69839eaab2e6fd3e77cef0168c35f267b42898bd76ced6bbd5f409018a",
    "10_out_hbm_196_float32":
        "254e258be87c3ae4da22a1c6646858c60e9025041bd78aadba3855044e8c61c0",
    "10_out_hbm_197_bfloat16":
        "fb339b1042ea31c04dfb443823ec84af5daa81f25191f4f05260242bbcdaa7a9",
    "10_out_hbm_197_float32":
        "0d21c87403a337dd00855ae4212d14fb744074945545bcee6426019e1f5282f7",
    "10_out_kernel_1000_bfloat16":
        "85b58f3ab86c1a391b286fda5fff649c2e3fdce3e3dbdf8b18f4c6089813a893",
    "10_out_kernel_1000_float32":
        "eff8d4b18c4566851a04a0f5b74aaff5d8df20fcefa9bfe3729f938bbee7077e",
    "10_out_kernel_196_bfloat16":
        "5290525f8a7c16a76a805e04e54cb7cfecaf551dd34f28dde28b8d64dad02c37",
    "10_out_kernel_196_float32":
        "254e258be87c3ae4da22a1c6646858c60e9025041bd78aadba3855044e8c61c0",
    "10_out_kernel_197_bfloat16":
        "54630538f5a4ecd8af3df5d846e9ff99e9848d6c9eee441f6b5488da17051ec2",
    "10_out_kernel_197_float32":
        "0d21c87403a337dd00855ae4212d14fb744074945545bcee6426019e1f5282f7",
    "10_out_none_1000_bfloat16":
        "067fa46d0e290360a04f107f8fcc3628ff76d6cb0a3eccee3fbae635a817bdf9",
    "10_out_none_1000_float32":
        "7815a757793b085e349e1d5dc59a14bbf39ea7371b5e6e4cc9012853f437bb7b",
    "10_out_none_196_bfloat16":
        "bf9215f2f983d92504cbfdd57057f1577e0d995aef2b312e11fbb9a4bc78b648",
    "10_out_none_196_float32":
        "791507848b2edc03ea3e74ef47bbc553d0e25cb45fb6a887e97d83b08b8d23a3",
    "10_out_none_197_bfloat16":
        "384bfee9ed1bc1ea69bb4f33408268bd5f69f822dc1a00d333669f5e40a5f20d",
    "10_out_none_197_float32":
        "f51c9c30e4a77ddff801e755b1eab1cc489c90d59825c8df713971b291fe7d96",
    "10_p_hbm_1000_bfloat16":
        "37170cf03ca2816a2a8e30226fe2f9b9845af3311b3a3c47d1c74ed14c070fdb",
    "10_p_hbm_1000_float32":
        "a7faaf2d2f7f3b3a9862539ed0e21e1ea27243aaf4af80250d1d591c66c2ee53",
    "10_p_hbm_196_bfloat16":
        "44768d97f0ae79ef902a3f3b06c8e09d4b387512cc88c4f0086b2cbfa6b25f4d",
    "10_p_hbm_196_float32":
        "00e0955799a6b21ab35c0679e83aeb4a2ecf8dd606c3719596d817b6c5ce4150",
    "10_p_hbm_197_bfloat16":
        "ae75fca76eefe6f8aa866df395a5dcea01aa00e1faf49ef81e9d986f1b28fb2b",
    "10_p_hbm_197_float32":
        "865f73fbffc11059d26d12ba6aca1940af10c08114a10bddf79f00ecb52bbd2f",
    "10_p_kernel_1000_bfloat16":
        "37170cf03ca2816a2a8e30226fe2f9b9845af3311b3a3c47d1c74ed14c070fdb",
    "10_p_kernel_1000_float32":
        "a7faaf2d2f7f3b3a9862539ed0e21e1ea27243aaf4af80250d1d591c66c2ee53",
    "10_p_kernel_196_bfloat16":
        "44768d97f0ae79ef902a3f3b06c8e09d4b387512cc88c4f0086b2cbfa6b25f4d",
    "10_p_kernel_196_float32":
        "00e0955799a6b21ab35c0679e83aeb4a2ecf8dd606c3719596d817b6c5ce4150",
    "10_p_kernel_197_bfloat16":
        "ae75fca76eefe6f8aa866df395a5dcea01aa00e1faf49ef81e9d986f1b28fb2b",
    "10_p_kernel_197_float32":
        "865f73fbffc11059d26d12ba6aca1940af10c08114a10bddf79f00ecb52bbd2f",
    "10_p_none_1000_bfloat16":
        "37170cf03ca2816a2a8e30226fe2f9b9845af3311b3a3c47d1c74ed14c070fdb",
    "10_p_none_1000_float32":
        "a7faaf2d2f7f3b3a9862539ed0e21e1ea27243aaf4af80250d1d591c66c2ee53",
    "10_p_none_196_bfloat16":
        "44768d97f0ae79ef902a3f3b06c8e09d4b387512cc88c4f0086b2cbfa6b25f4d",
    "10_p_none_196_float32":
        "00e0955799a6b21ab35c0679e83aeb4a2ecf8dd606c3719596d817b6c5ce4150",
    "10_p_none_197_bfloat16":
        "ae75fca76eefe6f8aa866df395a5dcea01aa00e1faf49ef81e9d986f1b28fb2b",
    "10_p_none_197_float32":
        "865f73fbffc11059d26d12ba6aca1940af10c08114a10bddf79f00ecb52bbd2f",
    "10_qkv_hbm_1000_bfloat16":
        "1228e7828fd44bb5452880454c22e74fd52c202903c652ad7adb1ba82d4e199d",
    "10_qkv_hbm_1000_float32":
        "457bae420d40b8ad3eb25a055e8ffdf1918761c10ef9ccb9be1234de6ca4677b",
    "10_qkv_hbm_196_bfloat16":
        "3f9c54c3c7c5441e7b7fbfafd650d454e4b39a809aa2d7e37e3b7380f47cd9ea",
    "10_qkv_hbm_196_float32":
        "0eea220e669d4cd4e9efee29252498a4976b70c8863751bb862ff489968d2ba0",
    "10_qkv_hbm_197_bfloat16":
        "1f3157cbc21aaf14d852a26eace77f85384720b8cea511bba86062fb7a12a26d",
    "10_qkv_hbm_197_float32":
        "216a38ad9a387c063a65e168b354e13a8abbae28d1bbd260ba54e66e5b9406c4",
    "10_qkv_kernel_1000_bfloat16":
        "1228e7828fd44bb5452880454c22e74fd52c202903c652ad7adb1ba82d4e199d",
    "10_qkv_kernel_1000_float32":
        "457bae420d40b8ad3eb25a055e8ffdf1918761c10ef9ccb9be1234de6ca4677b",
    "10_qkv_kernel_196_bfloat16":
        "3f9c54c3c7c5441e7b7fbfafd650d454e4b39a809aa2d7e37e3b7380f47cd9ea",
    "10_qkv_kernel_196_float32":
        "0eea220e669d4cd4e9efee29252498a4976b70c8863751bb862ff489968d2ba0",
    "10_qkv_kernel_197_bfloat16":
        "1f3157cbc21aaf14d852a26eace77f85384720b8cea511bba86062fb7a12a26d",
    "10_qkv_kernel_197_float32":
        "216a38ad9a387c063a65e168b354e13a8abbae28d1bbd260ba54e66e5b9406c4",
    "10_qkv_none_1000_bfloat16":
        "1228e7828fd44bb5452880454c22e74fd52c202903c652ad7adb1ba82d4e199d",
    "10_qkv_none_1000_float32":
        "457bae420d40b8ad3eb25a055e8ffdf1918761c10ef9ccb9be1234de6ca4677b",
    "10_qkv_none_196_bfloat16":
        "3f9c54c3c7c5441e7b7fbfafd650d454e4b39a809aa2d7e37e3b7380f47cd9ea",
    "10_qkv_none_196_float32":
        "0eea220e669d4cd4e9efee29252498a4976b70c8863751bb862ff489968d2ba0",
    "10_qkv_none_197_bfloat16":
        "1f3157cbc21aaf14d852a26eace77f85384720b8cea511bba86062fb7a12a26d",
    "10_qkv_none_197_float32":
        "216a38ad9a387c063a65e168b354e13a8abbae28d1bbd260ba54e66e5b9406c4",
    "12_keep_kernel_1000_bfloat16":
        "73aba23235a8b72fa3486cdf18cd7b9989ca9a6f673bfc0454d6a75c19cd4427",
    "12_keep_kernel_1000_float32":
        "73aba23235a8b72fa3486cdf18cd7b9989ca9a6f673bfc0454d6a75c19cd4427",
    "12_keep_kernel_196_bfloat16":
        "43776ae4bd780ab53249dd01ab694e9d28251c431528012d87932d4d72008240",
    "12_keep_kernel_196_float32":
        "43776ae4bd780ab53249dd01ab694e9d28251c431528012d87932d4d72008240",
    "12_keep_kernel_197_bfloat16":
        "0559302311258cf8da2389b80df8918d7a8b564b6650b88b447db2ee8c65ab57",
    "12_keep_kernel_197_float32":
        "0559302311258cf8da2389b80df8918d7a8b564b6650b88b447db2ee8c65ab57",
    "12_out_hbm_1000_bfloat16":
        "e9a6e807a34f092f3dee8469d627716b3c4cbdfbac16c9a60fcdfd2c46a0fa2c",
    "12_out_hbm_1000_float32":
        "eff8d4b18c4566851a04a0f5b74aaff5d8df20fcefa9bfe3729f938bbee7077e",
    "12_out_hbm_196_bfloat16":
        "d1056b69839eaab2e6fd3e77cef0168c35f267b42898bd76ced6bbd5f409018a",
    "12_out_hbm_196_float32":
        "254e258be87c3ae4da22a1c6646858c60e9025041bd78aadba3855044e8c61c0",
    "12_out_hbm_197_bfloat16":
        "fb339b1042ea31c04dfb443823ec84af5daa81f25191f4f05260242bbcdaa7a9",
    "12_out_hbm_197_float32":
        "0d21c87403a337dd00855ae4212d14fb744074945545bcee6426019e1f5282f7",
    "12_out_kernel_1000_bfloat16":
        "85b58f3ab86c1a391b286fda5fff649c2e3fdce3e3dbdf8b18f4c6089813a893",
    "12_out_kernel_1000_float32":
        "eff8d4b18c4566851a04a0f5b74aaff5d8df20fcefa9bfe3729f938bbee7077e",
    "12_out_kernel_196_bfloat16":
        "5290525f8a7c16a76a805e04e54cb7cfecaf551dd34f28dde28b8d64dad02c37",
    "12_out_kernel_196_float32":
        "254e258be87c3ae4da22a1c6646858c60e9025041bd78aadba3855044e8c61c0",
    "12_out_kernel_197_bfloat16":
        "54630538f5a4ecd8af3df5d846e9ff99e9848d6c9eee441f6b5488da17051ec2",
    "12_out_kernel_197_float32":
        "0d21c87403a337dd00855ae4212d14fb744074945545bcee6426019e1f5282f7",
    "12_out_none_1000_bfloat16":
        "067fa46d0e290360a04f107f8fcc3628ff76d6cb0a3eccee3fbae635a817bdf9",
    "12_out_none_1000_float32":
        "7815a757793b085e349e1d5dc59a14bbf39ea7371b5e6e4cc9012853f437bb7b",
    "12_out_none_196_bfloat16":
        "bf9215f2f983d92504cbfdd57057f1577e0d995aef2b312e11fbb9a4bc78b648",
    "12_out_none_196_float32":
        "791507848b2edc03ea3e74ef47bbc553d0e25cb45fb6a887e97d83b08b8d23a3",
    "12_out_none_197_bfloat16":
        "384bfee9ed1bc1ea69bb4f33408268bd5f69f822dc1a00d333669f5e40a5f20d",
    "12_out_none_197_float32":
        "f51c9c30e4a77ddff801e755b1eab1cc489c90d59825c8df713971b291fe7d96",
    "12_p_hbm_1000_bfloat16":
        "37170cf03ca2816a2a8e30226fe2f9b9845af3311b3a3c47d1c74ed14c070fdb",
    "12_p_hbm_1000_float32":
        "a7faaf2d2f7f3b3a9862539ed0e21e1ea27243aaf4af80250d1d591c66c2ee53",
    "12_p_hbm_196_bfloat16":
        "44768d97f0ae79ef902a3f3b06c8e09d4b387512cc88c4f0086b2cbfa6b25f4d",
    "12_p_hbm_196_float32":
        "00e0955799a6b21ab35c0679e83aeb4a2ecf8dd606c3719596d817b6c5ce4150",
    "12_p_hbm_197_bfloat16":
        "ae75fca76eefe6f8aa866df395a5dcea01aa00e1faf49ef81e9d986f1b28fb2b",
    "12_p_hbm_197_float32":
        "865f73fbffc11059d26d12ba6aca1940af10c08114a10bddf79f00ecb52bbd2f",
    "12_p_kernel_1000_bfloat16":
        "37170cf03ca2816a2a8e30226fe2f9b9845af3311b3a3c47d1c74ed14c070fdb",
    "12_p_kernel_1000_float32":
        "a7faaf2d2f7f3b3a9862539ed0e21e1ea27243aaf4af80250d1d591c66c2ee53",
    "12_p_kernel_196_bfloat16":
        "44768d97f0ae79ef902a3f3b06c8e09d4b387512cc88c4f0086b2cbfa6b25f4d",
    "12_p_kernel_196_float32":
        "00e0955799a6b21ab35c0679e83aeb4a2ecf8dd606c3719596d817b6c5ce4150",
    "12_p_kernel_197_bfloat16":
        "ae75fca76eefe6f8aa866df395a5dcea01aa00e1faf49ef81e9d986f1b28fb2b",
    "12_p_kernel_197_float32":
        "865f73fbffc11059d26d12ba6aca1940af10c08114a10bddf79f00ecb52bbd2f",
    "12_p_none_1000_bfloat16":
        "37170cf03ca2816a2a8e30226fe2f9b9845af3311b3a3c47d1c74ed14c070fdb",
    "12_p_none_1000_float32":
        "a7faaf2d2f7f3b3a9862539ed0e21e1ea27243aaf4af80250d1d591c66c2ee53",
    "12_p_none_196_bfloat16":
        "44768d97f0ae79ef902a3f3b06c8e09d4b387512cc88c4f0086b2cbfa6b25f4d",
    "12_p_none_196_float32":
        "00e0955799a6b21ab35c0679e83aeb4a2ecf8dd606c3719596d817b6c5ce4150",
    "12_p_none_197_bfloat16":
        "ae75fca76eefe6f8aa866df395a5dcea01aa00e1faf49ef81e9d986f1b28fb2b",
    "12_p_none_197_float32":
        "865f73fbffc11059d26d12ba6aca1940af10c08114a10bddf79f00ecb52bbd2f",
    "13_out_1000_bfloat16":
        "d919795b18885927d21b481e6458ece430de531632e9b40cef94162084174401",
    "13_out_1000_float32":
        "bdf2b6d3676d0d41df96f87816e0f580de6aa3ee674ac4b5fd4739e401a539eb",
    "13_out_196_bfloat16":
        "094f629ad3b70f04c9902b0bac44c700a94af243773bae611f9c55e7891fb510",
    "13_out_196_float32":
        "2cf6666ebd05300ae13556fe49f9e77b3c9aab592a8aa94e63cb9dec1c191087",
    "13_out_197_bfloat16":
        "2c6469c45e2dcfef82ae8560b1ded95c07f7dab4e0851c5b27e2b7e7360758a4",
    "13_out_197_float32":
        "f0cce5bd9d35578845b7ebafe79ebe17fd7dcb625704b00d61dd8dc4dcbe22b1",
}


@pytest.mark.cuda
def test_row_tile_forwards_keep_their_bits(cuda):
    """#10, #12 and #13 give the same bits as before the row tile's body
    took the backward mode of #11's part A."""
    got = _rows_digests(cuda)
    assert set(got) == set(ROWS_DIGESTS_BEFORE)
    changed = sorted(k for k in got if got[k] != ROWS_DIGESTS_BEFORE[k])
    assert not changed, changed


@pytest.mark.cuda
def test_mlp_kernel_refuses_what_it_cannot_take(cuda):
    """Operands of mixed dtype raise; a C above 1024 is outside the
    supported set and runs the dense chain without a launch."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.mlp import mlp_fused, mlp_fused_fwd

    z = lambda *s: torch.zeros(*s, device=cuda)  # noqa: E731
    with pytest.raises(ValueError, match="w1"):
        mlp_fused_fwd(z(4, 8), z(16, 8).bfloat16(), z(16), z(8, 16), z(8))
    before = kernels.launch_counts["mlp_fused"]
    out = mlp_fused(z(4, 1088), z(64, 1088), z(64), z(1088, 64), z(1088))
    assert tuple(out.shape) == (4, 1088)
    assert kernels.launch_counts["mlp_fused"] == before


# ---------------------------------------------------------------------------
# the last rows: kernels #6, #7 (window_attention_qkv's other arguments),
# #8, #9 (q, k, v [B, H, N, D]) and #12 (self_attention_qkv)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,c,heads,res,window", FLAG_SHAPES, ids=FLAG_IDS)
def test_rows_kernels_match_plain_and_transposed(cuda, bw, c, heads, res,
                                                 window, dtype):
    """Kernel #6 (transposed=False): forward out and p, backward dqkv and
    dbias against the plain versions; out, p and dqkv BIT-EQUAL to #5's
    and #4's (the same device code per head), dbias within the gradient
    bar (other runs of windows per partial); equal bits on a rerun; one
    launch counted per call."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.window_attention import window_attention_qkv_fwd

    _, bias_t, mask_t, _, qkv, p, dout = _saved(cuda, bw, c, heads, res,
                                                window, dtype)
    names = ("window_attention_qkv_savep_rows",
             "window_attention_qkv_bwd_rows")
    with torch.no_grad():
        before = dict(kernels.launch_counts)
        got = window_attention_qkv_fwd(qkv, bias_t, mask_t, heads,
                                       transposed=False)
        again = window_attention_qkv_fwd(qkv, bias_t, mask_t, heads,
                                         transposed=False)
        gb = window_attention_qkv_fused_bwd(qkv, p, dout, heads,
                                            transposed=False)
        ab = window_attention_qkv_fused_bwd(qkv, p, dout, heads,
                                            transposed=False)
        counts = dict(kernels.launch_counts)
        want = window_attention_qkv_fwd(qkv, bias_t, mask_t, heads,
                                        impl="plain")
        wb = window_attention_qkv_fused_bwd(qkv, p, dout, heads,
                                            impl="plain")
        t5 = window_attention_qkv_fwd(qkv, bias_t, mask_t, heads)
        t4 = window_attention_qkv_fused_bwd(qkv, p, dout, heads)
    torch.cuda.synchronize()
    assert [counts[k] - before[k] for k in names] == [2, 2]
    for g, a, w, t in zip(got, again, want, t5):
        assert torch.equal(g, a) and torch.equal(g, t)
        _close(g, w, dtype, "fwd")
    assert torch.equal(gb[0], ab[0]) and torch.equal(gb[1], ab[1])
    assert torch.equal(gb[0], t4[0])
    for g, w, t in zip(gb, wb, t4):
        _close(g, w, dtype, "grad")
        _close(g, t, dtype, "grad")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,c,heads,res,window", FLAG_SHAPES, ids=FLAG_IDS)
def test_recompute_kernels_match_plain(cuda, bw, c, heads, res, window,
                                       dtype):
    """Kernel #7 (save_p=False): the forward's out bit-equal to #5's and
    within the forward bar of the plain version; the backward, which
    computes p again, against its plain version and, in f32, against #4
    from the saved p; equal bits on a rerun."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import window_attention as wa

    _, bias_t, mask_t, _, qkv, p, dout = _saved(cuda, bw, c, heads, res,
                                                window, dtype)
    names = ("window_attention_qkv_fwd", "window_attention_qkv_bwd_recompute")
    with torch.no_grad():
        before = dict(kernels.launch_counts)
        out = wa.window_attention_qkv_recompute_fwd(qkv, bias_t, mask_t,
                                                    heads)
        gb = wa.window_attention_qkv_recompute_bwd(qkv, bias_t, mask_t, dout,
                                                   heads)
        ab = wa.window_attention_qkv_recompute_bwd(qkv, bias_t, mask_t, dout,
                                                   heads)
        counts = dict(kernels.launch_counts)
        want = wa.window_attention_qkv_recompute_fwd(qkv, bias_t, mask_t,
                                                     heads, impl="plain")
        wb = wa.window_attention_qkv_recompute_bwd(qkv, bias_t, mask_t, dout,
                                                   heads, impl="plain")
        t5 = wa.window_attention_qkv_fwd(qkv, bias_t, mask_t, heads)[0]
        t4 = window_attention_qkv_fused_bwd(qkv, p, dout, heads)
    torch.cuda.synchronize()
    assert [counts[k] - before[k] for k in names] == [1, 2]
    assert torch.equal(out, t5)
    _close(out, want, dtype, "fwd")
    assert torch.equal(gb[0], ab[0]) and torch.equal(gb[1], ab[1])
    for g, w, t in zip(gb, wb, t4):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w, dtype, "grad")
        if dtype == "float32":
            _close(g, t, dtype, "grad")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_op_variants_launch_their_kernels(cuda, dtype):
    """window_attention_qkv's three argument combinations on the card:
    each launches its own forward and backward once, BWD_DELTA reaches
    only the default one, and the gradients match the plain op."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import window_attention as wa

    _, bias_t, mask_t, _, qkv, _, dout = _saved(cuda, 128, 512, 16, 14, 7,
                                                dtype)
    want = {(True, True): ("window_attention_qkv_savep",
                           "window_attention_qkv_fused_bwd_delta"),
            (True, False): ("window_attention_qkv_savep_rows",
                            "window_attention_qkv_bwd_rows"),
            (False, True): ("window_attention_qkv_fwd",
                            "window_attention_qkv_bwd_recompute"),
            (False, False): ("window_attention_qkv_fwd",
                             "window_attention_qkv_bwd_recompute")}
    try:
        wa.BWD_DELTA = True
        for (save_p, transposed), names in want.items():
            grads = {}
            for impl in ("auto", "plain"):
                leaves = [qkv.clone().requires_grad_(True),
                          bias_t.clone().requires_grad_(True)]
                before = dict(kernels.launch_counts)
                out = wa.window_attention_qkv(
                    leaves[0], leaves[1], mask_t, 16, save_p=save_p,
                    transposed=transposed, impl=impl)
                out.backward(dout)
                ran = {k: v - before[k] for k, v in
                       kernels.launch_counts.items() if v != before[k]}
                assert ran == ({} if impl == "plain"
                               else {k: 1 for k in names}), ran
                grads[impl] = [t.grad for t in leaves]
            for g, w in zip(grads["auto"], grads["plain"]):
                _close(g, w, dtype, "grad")
    finally:
        wa.BWD_DELTA = False


def _bhnd(cuda, b, c, heads, res, window, dtype):
    """q, k, v [B, H, N, D] from a seeded qkv, bias, mask."""
    x, _, _, bias = _inputs(b, c, heads, seed=res + 2, window=window)
    n, d = window * window, c // heads
    rng = np.random.default_rng(res + 3)
    qkv = rng.standard_normal((b, n, 3, heads, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(
        qkv[:, :, i].transpose(0, 2, 1, 3))).to(cuda, getattr(torch, dtype))
        for i in range(3))
    mask_t = (torch.from_numpy(shift_attn_mask(res, res, window,
                                               window // 2)).to(cuda)
              if res > window else None)
    return q, k, v, torch.from_numpy(bias).to(cuda), mask_t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,c,heads,res,window", FLAG_SHAPES, ids=FLAG_IDS)
def test_bhnd_kernels_match_plain(cuda, bw, c, heads, res, window, dtype):
    """Kernels #8 and #9 on q, k, v [B, H, N, D]: against
    window_attention_ref, bit-equal to each other, to a rerun and to #5 on
    the same values in the qkv layout; the dispatcher with use_pallas
    launches #9."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import window_attention as wa

    q, k, v, bias_t, mask_t = _bhnd(cuda, bw, c, heads, res, window, dtype)
    names = ("window_attention_bhnd", "window_attention_packed")
    with torch.no_grad():
        before = dict(kernels.launch_counts)
        g8 = wa.window_attention_bhnd(q, k, v, bias_t, mask_t)
        a8 = wa.window_attention_bhnd(q, k, v, bias_t, mask_t)
        g9 = wa.window_attention_packed(q, k, v, bias_t, mask_t)
        d9 = wa.window_attention(q, k, v, bias_t, mask_t, use_pallas=True)
        counts = dict(kernels.launch_counts)
        want = wa.window_attention_ref(q, k, v, bias_t, mask_t)
        plain = wa.window_attention(q, k, v, bias_t, mask_t)
        b, h, n, d = q.shape
        qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], 2)
        t5 = wa.window_attention_qkv_fwd(qkv.reshape(b, n, 3 * h * d).
                                         contiguous(), bias_t, mask_t, h)[0]
    torch.cuda.synchronize()
    assert [counts[k] - before[k] for k in names] == [2, 2]
    assert torch.equal(plain, want)
    for got in (a8, g9, d9):
        assert torch.equal(got, g8)
    assert torch.equal(g8.transpose(1, 2).reshape(b, n, h * d), t5)
    _close(g8, want, dtype, "fwd")


@pytest.mark.cuda
def test_bhnd_kernels_take_any_window_count_or_refuse(cuda):
    """#8 takes B that nW does not divide (window i takes mask[i % nW]);
    #9 raises there, as gdl_tpu's packed kernel does; both refuse
    autograd and a mismatched k."""
    from gdl_tpu_torch.ops import window_attention as wa

    q, k, v, bias_t, mask_t = _bhnd(cuda, 6, 64, 2, 14, 7, "float32")
    with torch.no_grad():
        got = wa.window_attention_bhnd(q, k, v, bias_t, mask_t)
        want = wa.window_attention_ref(q, k, v, bias_t, mask_t)
        _close(got, want, "float32", "fwd")
        with pytest.raises(ValueError, match="not a multiple of nW"):
            wa.window_attention_packed(q, k, v, bias_t, mask_t)
        with pytest.raises(ValueError, match="k: expected"):
            wa.window_attention_bhnd(q, k[:, :1], v, bias_t, None)
    for op in (wa.window_attention_bhnd, wa.window_attention_packed):
        with pytest.raises(RuntimeError, match="no backward"):
            op(q.clone().requires_grad_(True), k, v, bias_t, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", ["none", "hbm", "kernel"])
@pytest.mark.parametrize("b,n,c,heads", SA_SHAPES, ids=SA_IDS)
def test_self_attention_qkv_kernel_matches_plain(cuda, b, n, c, heads,
                                                 dropout, dtype):
    """Kernel #12 on the qkv kernel #10 projected: out and p bit-equal to
    #10's (the same tile kernel), within the forward bar of the plain
    version, with and without the keep mask written out (the bits the
    plain generator draws); the op's dqkv (through #11) against the plain
    op."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.dropout import fold_seed_words
    from gdl_tpu_torch.ops import self_attention as sa

    x, w, g = _sa_inputs(cuda, b, n, c, dtype, seed=n + c + 2)
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    words = fold_seed_words(gen, cuda)
    drop = sa.make_dropout(x, heads, 0.3, dropout != "none",
                           "kernel" if dropout == "none" else dropout,
                           seed_words=words)
    name = "self_attention_qkv_fwd"
    with torch.no_grad():
        o10, qkv, p10 = sa.self_attention_fused_fwd(x, w, heads, drop=drop)
        before = kernels.launch_counts[name]
        got = sa.self_attention_qkv_fwd(qkv, heads, drop=drop,
                                        return_keep=True)
        bare = sa.self_attention_qkv_fwd(qkv, heads, drop=drop)
        assert kernels.launch_counts[name] == before + 2
        want = sa.self_attention_qkv_fwd(qkv, heads, drop=drop, impl="plain",
                                         return_keep=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], o10) and torch.equal(got[1], p10)
    assert torch.equal(bare[0], got[0]) and torch.equal(bare[1], got[1])
    for a, r in zip(got[:2], want[:2]):
        torch.testing.assert_close(a.float(), r.float(), **SA_FWD_TOL[dtype])
    if dropout == "kernel":
        assert torch.equal(got[2], want[2])
    else:
        assert got[2] is None and want[2] is None
    grads = {}
    for impl in ("auto", "plain"):
        leaf = qkv.clone().requires_grad_(True)
        out = sa.self_attention_qkv(
            leaf.reshape(b, n, 3, c), heads, dropout_rate=0.3,
            seed_words=words, train=dropout != "none",
            dropout_impl="kernel" if dropout == "none" else dropout,
            mask=drop.mask, impl=impl)
        out.backward(g)
        grads[impl] = leaf.grad
    _grad_close(grads["auto"], grads["plain"], dtype)


# ---------------------------------------------------------------------------
# kernels #2 and #1: the qkv projection on the GEMM tile (epilogue
# wa2::ProjBias), then #5's and #7's attention body on the written qkv
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted",
                                                        "shifted"])
@pytest.mark.parametrize("bw,c,heads,res,window", TRAIN_SHAPES,
                         ids=TRAIN_IDS)
def test_forward_kernels_2_and_1_are_projection_then_attention(
        cuda, bw, c, heads, res, window, shifted, dtype):
    """At the four batch-32 stage shapes and the odd one, with and without
    a shift mask (stage 3's window covers its map; its mask is the
    7-token shift's all the same): #2's qkv against torch.matmul(x, wᵀ) + b
    at test_savep_kernel_matches_plain's forward bar; #2's out and p
    BIT-EQUAL to #5's on the qkv #2 wrote; #1's out BIT-EQUAL to #2's on
    the same inputs and to a rerun of #1. One launch counted a call."""
    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops.window_attention import window_attention_qkv_fwd

    args, bias_t, _ = _train_case(cuda, bw, c, heads, res, window, dtype)
    mask_t = (torch.from_numpy(shift_attn_mask(res, res, window,
                                               window // 2)).to(cuda)
              if shifted else None)
    x, w, b = args
    names = ("window_attention_qkv_fused_savep",
             "window_attention_qkv_fused_eval", "window_attention_qkv_savep")
    before = dict(kernels.launch_counts)
    with torch.no_grad():
        out2, qkv2, p2 = window_attention_qkv_fused_fwd(*args, bias_t, mask_t,
                                                        heads)
        out5, p5 = window_attention_qkv_fwd(qkv2, bias_t, mask_t, heads)
        out1 = window_attention_qkv_fused_eval(*args, bias_t, mask_t, heads)
        again1 = window_attention_qkv_fused_eval(*args, bias_t, mask_t,
                                                 heads)
        want_qkv = torch.matmul(x, w.t()) + b
    torch.cuda.synchronize()
    assert [kernels.launch_counts[k] - before[k] for k in names] == [1, 2, 1]
    assert qkv2.dtype == x.dtype and qkv2.shape == want_qkv.shape
    _close(qkv2, want_qkv, dtype, "fwd")
    assert torch.equal(out2, out5) and torch.equal(p2, p5)
    assert torch.equal(out1, out2) and torch.equal(out1, again1)


def _kernel3_digests(cuda) -> dict:
    """The bits of #3's outputs (dx, dW, db, dbias: its attention stage,
    its two instantiations of the GEMM tile and the partial sums) on fixed
    inputs (numpy seeds) at Swin-B stages 1 and 3 at batch 32, shifted,
    and at 20 windows of 50 tokens (a ragged M and last dW split); both
    dtypes. Name -> SHA-256."""
    from gdl_tpu_torch.ops import window_attention as wa

    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for bw, n, c, heads, res in ((512, 49, 256, 8, 28),
                                     (32, 49, 1024, 32, 7),
                                     (20, 50, 96, 3, 0)):
            rng = np.random.default_rng(bw + n + c)
            scores = rng.standard_normal((bw, heads, n, n))
            p = np.exp(scores - scores.max(-1, keepdims=True))
            qkv, p, dout, x, w = [
                torch.from_numpy(a.astype(np.float32)).to(cuda, dt)
                for a in (rng.standard_normal((bw, n, 3 * c)),
                          p / p.sum(-1, keepdims=True),
                          rng.standard_normal((bw, n, c)),
                          rng.standard_normal((bw, n, c)),
                          rng.standard_normal((3 * c, c)) * c ** -0.5)]
            with torch.no_grad():
                got = wa.window_attention_qkv_fused_bwd_fused(qkv, p, dout, x,
                                                              w, heads)
            for name, t in zip(("dx", "dW", "db", "dbias"), got):
                out[f"3_{bw}_{c}_{name}_{dtype}"] = _bits(t)
    return out


# _kernel3_digests as the kernels gave them (run on an NVIDIA H100 80GB
# HBM3 by this file's _kernel3_digests) once #3's attention stage moved
# onto the tensor-core backward body (window_attention_bwd.cuh), whose
# sums take another order than the first design's; recorded before
# that from the tree before #2's and #1's projection joined the tile
KERNEL3_DIGESTS_BEFORE = {
    "3_20_96_dW_bfloat16":
        "1191f25c9d19ca9ad2af5cb8460e8ac41ad29f32e073766d176865ab09ec2e44",
    "3_20_96_dW_float32":
        "0655d45af3e886703bf2c1cfef7063750b7268d964a3a947dfef1a45194e0244",
    "3_20_96_db_bfloat16":
        "2354ddc4120847f30d04133d3207a470242f48a4e4c3c111f929f95f9ebc1c96",
    "3_20_96_db_float32":
        "d09d7dcd567bacc0530801efd2406c95b6b2476714154d16ddf96b56d183c75b",
    "3_20_96_dbias_bfloat16":
        "92d88cde7da99897798e1ce26fcbfb59c638a95850064f6a55f4fe0d00af4a89",
    "3_20_96_dbias_float32":
        "99b80f9aa736237026126406b01e35ad4a063c4d688e8e540f7e58a6cacb832a",
    "3_20_96_dx_bfloat16":
        "596ddde2723dcef11e28576bee1c4e0ec97e9c956112d1a1b26c124978a2c5f7",
    "3_20_96_dx_float32":
        "ff5c792b6331427d3ca51fa678e520b6c8105f21334b0762ef9f982e7672b917",
    "3_32_1024_dW_bfloat16":
        "5d16f279a4dee6c1d205c674c7ff89c236d75fee1af6a69938be555442292b37",
    "3_32_1024_dW_float32":
        "09c742ce71b4127d91e59a267791d8d482e054ac61ac609badc215efd9e36546",
    "3_32_1024_db_bfloat16":
        "3b2c1b4a23842d2335855a89c56c5d2c8e034b8dfd04ea375acf8c569ad45322",
    "3_32_1024_db_float32":
        "2e31bb9d423aa8f50b8d0d643559dcd43c05c3fd3ecce6bbc1b3efd49429af95",
    "3_32_1024_dbias_bfloat16":
        "7c486c6b8c9d3abb84e503d9761826261157492f8654cb79bd68b0356191e78f",
    "3_32_1024_dbias_float32":
        "2a3f4219c84be339473e9069f70121a5dc5697e4090464cd4e058740dc518349",
    "3_32_1024_dx_bfloat16":
        "2d7a8abc709006bd3e51804c2acb33b3dd22311110be00f01aa70e18cb500916",
    "3_32_1024_dx_float32":
        "d0bae81ab5dbc85a21ed8728f499f1ce49cc7ecbf0f43613075a9ae20b666040",
    "3_512_256_dW_bfloat16":
        "75afbe66bac0d5697a1e78b35051d6987e134ff04ef5ea407836f315ded4cac6",
    "3_512_256_dW_float32":
        "b5269ee8bd10da739b761501be0c80ec5c26b94cdfcd61122f7cc301a7b74f76",
    "3_512_256_db_bfloat16":
        "da1fc7c0c89aa56882ce7f6e5b435721bcc050f98b92c3178e95c8d430165429",
    "3_512_256_db_float32":
        "fcbdf26189db98950d204080a9aa6e714b8676995b261cabe20b483440c46aa6",
    "3_512_256_dbias_bfloat16":
        "f5cbe5cdc302e933dfe60d1e6b57c1c7070b7d3c624f61c61ad2a04395d4dfe8",
    "3_512_256_dbias_float32":
        "2f18e7f7feec916fa3350c3a664ab8e92e35cd21ae4fa9643d018536313c9a2c",
    "3_512_256_dx_bfloat16":
        "13b88849736566610635bade1c5564c5f5bd803f2afb659b3886e0f787947ff0",
    "3_512_256_dx_float32":
        "a85f2ca3933f6ed83edeb3234a576c3e3e965d82927189e4869e72a938920754",
}


@pytest.mark.cuda
def test_tile_instantiations_of_3_keep_their_bits(cuda):
    """#3's products on the GEMM tile (and the rest of #3) keep the bits
    recorded once its attention stage took the tensor-core backward body
    (they kept them, before that, when #2's and #1's projection took the
    tile)."""
    got = _kernel3_digests(cuda)
    assert set(got) == set(KERNEL3_DIGESTS_BEFORE)
    changed = sorted(k for k in got if got[k] != KERNEL3_DIGESTS_BEFORE[k])
    assert not changed, changed


@pytest.mark.cuda
def test_projection_of_2_and_1_is_filed_under_its_own_row(cuda):
    """A profiler trace of #2 and of #1 shows the projection as the GEMM
    tile with the wa2::ProjBias epilogue, which profile_step files under
    "window_attention_proj (#1, #2)" and not under the self-attention
    row, and the attention as wa_fwd_kernel under the window-attention
    row; in both dtypes. Every kernel symbol a trace saw is printed.

    The tracer has been seen to drop a call's records (an "Activity
    Buffer Request" in their place): a first trace of its own starts the
    tracer first, and a trace that lacks the record of either kernel is
    taken again, at most twice; the last one is held to the asserts."""
    from torch.profiler import ProfilerActivity, profile

    from gdl_tpu_torch.profile_step import kind_of

    def traced(op, *a):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            op(*a)
            op(*a)
            torch.cuda.synchronize()
        return sorted({e.key for e in prof.key_averages()})

    for dtype in ("float32", "bfloat16"):
        args, bias_t, mask_t = _train_case(cuda, 128, 512, 16, 14, 7, dtype)
        for op in (window_attention_qkv_fused_fwd,
                   window_attention_qkv_fused_eval):
            with torch.no_grad():
                op(*args, bias_t, mask_t, 16)  # built, loaded and warm
                torch.cuda.synchronize()
                traced(op, *args, bias_t, mask_t, 16)  # the tracer started
                for _ in range(3):
                    seen = traced(op, *args, bias_t, mask_t, 16)
                    if (any("gemm_tile_kernel" in k for k in seen)
                            and any("wa_fwd_kernel" in k for k in seen)):
                        break
            print(op.__name__, dtype, "traced:", seen)
            gemms = [k for k in seen if "gemm_tile_kernel" in k]
            attn = [k for k in seen if "wa_fwd_kernel" in k]
            assert len(gemms) == 1 and "wa2::" in gemms[0], seen
            assert "ProjBias" in gemms[0], seen
            assert kind_of(gemms[0]) == "window_attention_proj (#1, #2)"
            assert len(attn) == 1, seen
            assert "#1, #2" in kind_of(attn[0]), seen


# --- the forward body (window_attention_fwd.cuh): #1, #2, #5, #6's and #7's
# forward, #8 and #9 ---------------------------------------------------------

# (bw, n, c, heads, nw): the four batch-32 Swin-B stage shapes (nW of their
# shift masks; stage 3's window covers its map), 50 tokens (a ragged last
# key tile), head dim 12 (bf16 rows of 24 bytes: 8-byte pieces), head dim 7
# (14 bytes: element by element), 64 tokens at head dim 64, and one token
FWD_BODY_SHAPES = [(2048, 49, 128, 4, 64), (512, 49, 256, 8, 16),
                   (128, 49, 512, 16, 4), (32, 49, 1024, 32, 1),
                   (10, 50, 64, 2, 2), (10, 49, 24, 2, 2), (6, 9, 14, 2, 2),
                   (8, 64, 128, 2, 4), (4, 1, 32, 1, 1)]
FWD_BODY_IDS = ["stage0", "stage1", "stage2", "stage3", "n50", "d12", "d7",
                "n64", "n1"]


def _fwd_body_inputs(cuda, bw, n, c, heads, nw, dt):
    """Seeded x, w, b, qkv in dt; bias and a 0 / -100 mask (or None) in
    float32."""
    rng = np.random.default_rng(bw * n + c + heads)

    def dev(a, to=dt):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(cuda, to)

    x = dev(rng.standard_normal((bw, n, c)))
    w = dev(rng.standard_normal((3 * c, c)) * c ** -0.5)
    b = dev(rng.standard_normal(3 * c) * 0.1)
    qkv = dev(rng.standard_normal((bw, n, 3 * c)))
    bias = dev(rng.standard_normal((heads, n, n)) * 0.5, torch.float32)
    mask = (dev(np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0),
                torch.float32) if nw > 1 else None)
    return x, w, b, qkv, bias, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,n,c,heads,nw", FWD_BODY_SHAPES,
                         ids=FWD_BODY_IDS)
def test_fwd_body_launchers_write_exactly_their_outputs(cuda, bw, n, c,
                                                        heads, nw, dtype):
    """The forward entries on the one body, called at their C entries:
    #5 (and #6's forward, the same entry), #7's forward, #2 and #1 (the
    projection into a qkv workspace, then the body) and #8 (and #9, the
    same entry) on q, k, v [B, H, N, D], with blocks of 3 windows of a
    mask class (ragged runs) and p at an element offset of 1 (its slabs'
    alignment moves). out, p and qkv, prefilled with NaN at the front of
    larger NaN buffers, come out finite and leave the buffers' tails NaN;
    out and p hold to the plain forward at TRAIN_FWD_TOL; #7's, #8's and
    #1's out and #2's out and p are BIT-EQUAL to #5's on the same qkv
    (#2's and #1's: on the qkv #2 wrote), and so is #5 with one window a
    block: the run of windows sets no bits; equal bits on a rerun."""
    import ctypes

    from gdl_tpu_torch import kernels
    from gdl_tpu_torch.ops import window_attention as wa

    dt = getattr(torch, dtype)
    code = {"float32": 0, "bfloat16": 1}[dtype]
    d = c // heads
    scale = d ** -0.5
    nwk = nw if nw > 1 else 1
    x, w, b, qkv, bias, mask = _fwd_body_inputs(cuda, bw, n, c, heads, nw, dt)
    q, k, v = (t.contiguous() for t in qkv.reshape(bw, n, 3, heads, d)
               .permute(2, 0, 3, 1, 4))
    train = kernels.load("window_attention_train")
    evl = kernels.load("window_attention_eval")
    bhnd = kernels.load("window_attention_bhnd")
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    def guarded(shape, offset=0):
        size = int(np.prod(shape))
        buf = torch.full((offset + size + 4096,), float("nan"), dtype=dt,
                         device=cuda)
        return buf[offset:offset + size].view(shape), buf[offset + size:]

    def launch(kind, wpb=3, src=qkv):
        out, out_tail = guarded((bw, n, c))
        p, p_tail = guarded((bw, heads, n, n), offset=1)
        ws, ws_tail = guarded((bw, n, 3 * c))
        shape = (bw, n, c, heads, d, nwk, wpb)
        if kind == "5":
            err = train.gdl_wa_qkv_savep_launch(
                ptr(src), ptr(bias), ptr(mask), ptr(out), ptr(p), *shape,
                scale, code, stream)
        elif kind == "7":
            err = train.gdl_wa_qkv_fwd_launch(
                ptr(src), ptr(bias), ptr(mask), ptr(out), *shape, scale,
                code, stream)
        elif kind == "2":
            err = train.gdl_wa_savep_launch(
                ptr(x), ptr(w), ptr(b), ptr(bias), ptr(mask), ptr(out),
                ptr(ws), ptr(p), *shape, scale, code, stream)
        elif kind == "1":
            err = evl.gdl_wa_eval_launch(
                ptr(x), ptr(w), ptr(b), ptr(bias), ptr(mask), ptr(ws),
                ptr(out), *shape, scale, code, stream)
        else:
            out, out_tail = guarded((bw, heads, n, d))
            err = bhnd.gdl_wa_bhnd_launch(
                ptr(q), ptr(k), ptr(v), ptr(bias), ptr(mask), ptr(out), bw,
                n, heads, d, nwk, wpb, scale, code, stream)
            out = out.transpose(1, 2).reshape(bw, n, c)
        assert err == 0, (kind, err)
        torch.cuda.synchronize()
        wrote = [(out, out_tail)]
        if kind in ("5", "2"):
            wrote.append((p, p_tail))
        if kind in ("2", "1"):
            wrote.append((ws, ws_tail))
        for t, tail in wrote:
            assert bool(torch.isfinite(t.float()).all()), kind
            assert bool(torch.isnan(tail.float()).all()), kind
        return out, p, ws

    with torch.no_grad():
        got = {kind: launch(kind) for kind in ("5", "7", "2", "1", "8")}
        again = {kind: launch(kind) for kind in got}
        one = launch("5", wpb=1)
        on_2 = launch("5", src=got["2"][2])
        out_w, p_w = wa.window_attention_qkv_train_ref(qkv, bias, mask,
                                                       heads, scale)
    for kind in got:
        assert torch.equal(got[kind][0], again[kind][0]), kind
    _close(got["5"][0], out_w, dtype, "fwd")
    _close(got["5"][1], p_w, dtype, "fwd")
    assert torch.equal(got["5"][1], again["5"][1])
    assert torch.equal(one[0], got["5"][0]) and torch.equal(one[1],
                                                            got["5"][1])
    for kind in ("7", "8"):
        assert torch.equal(got[kind][0], got["5"][0]), kind
    assert torch.equal(got["2"][0], on_2[0])
    assert torch.equal(got["2"][1], on_2[1])
    assert torch.equal(got["1"][0], got["2"][0])
    assert torch.equal(got["1"][2], got["2"][2])


def _fwd_digests(cuda) -> dict:
    """The bits of the forward body's outputs (#5's out and p, #7's out,
    #2's out, qkv and p, #1's out, #8's out) on fixed inputs (numpy seeds)
    at Swin-B stage 1 at batch 32 with its shift mask's 16 classes, stage 3
    without a mask, and 20 windows of 50 tokens at head dim 12 with 4
    classes, both dtypes, through the ops. Name -> SHA-256."""
    from gdl_tpu_torch.ops import window_attention as wa

    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for bw, n, c, heads, nw in ((512, 49, 256, 8, 16),
                                    (32, 49, 1024, 32, 1),
                                    (20, 50, 24, 2, 4)):
            x, w, b, qkv, bias, mask = _fwd_body_inputs(cuda, bw, n, c, heads,
                                                        nw, dt)
            d = c // heads
            q, k, v = (t.contiguous() for t in qkv.reshape(bw, n, 3, heads, d)
                       .permute(2, 0, 3, 1, 4))
            with torch.no_grad():
                got = {
                    "5": wa.window_attention_qkv_fwd(qkv, bias, mask, heads),
                    "7": (wa.window_attention_qkv_recompute_fwd(
                        qkv, bias, mask, heads),),
                    "2": wa.window_attention_qkv_fused_fwd(x, w, b, bias,
                                                           mask, heads),
                    "1": (wa.window_attention_qkv_fused_eval(
                        x, w, b, bias, mask, heads),),
                    "8": (wa.window_attention_bhnd(q, k, v, bias, mask),)}
            for kind, ts in got.items():
                for i, t in enumerate(ts):
                    out[f"{kind}_{bw}_{c}_{i}_{dtype}"] = _bits(t)
    return out


# _fwd_digests as the forward body gave them (run on an NVIDIA H100 80GB
# HBM3 by this file's _fwd_digests) once every forward ran on the
# tensor-core body of window_attention_fwd.cuh
FWD_DIGESTS = {
    "1_20_24_0_bfloat16":
        "8d162b699ff7bbe7402d7ad557007a953724ecca982aa6b2c3131dd3a32da776",
    "1_20_24_0_float32":
        "fb2515a728861a2a25b0e7dfb036980c8d6ff0cf2ee3b531bb1c54301156cc36",
    "1_32_1024_0_bfloat16":
        "040be336088a2b8834cdc73e7aa5560cc361e5d5f1a82f409236ffcd854a336e",
    "1_32_1024_0_float32":
        "485f31d952667f2a271c584485070a9a9ffe2e7876b0a7517eeaceaef5d8e1b6",
    "1_512_256_0_bfloat16":
        "c62afd4098922a9cc47bbd8d893b07d8b59ea299c26ef3f18e239909b7e43628",
    "1_512_256_0_float32":
        "0d0c470ea9721800fe9ef6c6fd46c78f48f980138818a13fdf6b876763b73a98",
    "2_20_24_0_bfloat16":
        "8d162b699ff7bbe7402d7ad557007a953724ecca982aa6b2c3131dd3a32da776",
    "2_20_24_0_float32":
        "fb2515a728861a2a25b0e7dfb036980c8d6ff0cf2ee3b531bb1c54301156cc36",
    "2_20_24_1_bfloat16":
        "2742ca04e813f92a82507e4ea1ffe9ae90d776b1afeff1ac0fb9902f3a0a7371",
    "2_20_24_1_float32":
        "f3128d7635337d5066d1e498173ef4f1f81e14ee4fa63483f8b46297b68e8c4e",
    "2_20_24_2_bfloat16":
        "24b94c63c681d42c1bdd981d47d1117ad14e2fc58e9fe07e50ddf6a7087b10fb",
    "2_20_24_2_float32":
        "151ca519b9354ee35ac8effd0273282fc5547e9781ce89ab90cc3a111f50a4e8",
    "2_32_1024_0_bfloat16":
        "040be336088a2b8834cdc73e7aa5560cc361e5d5f1a82f409236ffcd854a336e",
    "2_32_1024_0_float32":
        "485f31d952667f2a271c584485070a9a9ffe2e7876b0a7517eeaceaef5d8e1b6",
    "2_32_1024_1_bfloat16":
        "2b70cf2544d8b55290c0607fed0fbdd9e6036c7ebccb783302350de0d63bd295",
    "2_32_1024_1_float32":
        "ae87795a52c1a4cb8696a161ead4a5e0925249a0972a992ae4d087dac110560a",
    "2_32_1024_2_bfloat16":
        "ee67ede9bc6cd587c53f317b465a994427a8e0f362060f0f488c57140208fd64",
    "2_32_1024_2_float32":
        "e64032c3dd989ac314517ab72594182d15764a012b8080b1e3274b78d72c2d72",
    "2_512_256_0_bfloat16":
        "c62afd4098922a9cc47bbd8d893b07d8b59ea299c26ef3f18e239909b7e43628",
    "2_512_256_0_float32":
        "0d0c470ea9721800fe9ef6c6fd46c78f48f980138818a13fdf6b876763b73a98",
    "2_512_256_1_bfloat16":
        "9c9d5e6c861922b1eb18baf62852efd91a4eaa756dac71c09bea7bb989885390",
    "2_512_256_1_float32":
        "3a39fec5c06cfdb36661e361b25b6d2bbfbed4ec3278ef53611626dc5d8afa48",
    "2_512_256_2_bfloat16":
        "0fbf77bec72da37c27205f5b97b2633f51d37de00256e014b428634a850b7501",
    "2_512_256_2_float32":
        "18c8409d8b262013d76087bfd0974d962b817252782f7a16f670118313f43329",
    "5_20_24_0_bfloat16":
        "820da1ad16bd67c05917ae5418bedb1dd43a5d484aa54dfecb1ec4c15d633694",
    "5_20_24_0_float32":
        "54394fb187c002e30064a64f3d87e2c4bea738906be7474e42d6936e4f90b0e7",
    "5_20_24_1_bfloat16":
        "5a24297d66174b9f5a807929925daa466d516e2fd86b7059b8f4914cb7461082",
    "5_20_24_1_float32":
        "9c9261571ce276272fa2c7c44b57c5e8ee54225ac801f0de30599641b19d22ba",
    "5_32_1024_0_bfloat16":
        "3b6f2916f7bb0e5e6d8f5ae1762e2c7722974ba7386816932d471153a5c9d786",
    "5_32_1024_0_float32":
        "66fd455277f39207b8dc5b0d2f150cfea2f92d09a5fe0c81559e4146bf0e4937",
    "5_32_1024_1_bfloat16":
        "779f31197f2eb50dcf926869edbc278ce2d87807b2a31e13c03fe54634672efd",
    "5_32_1024_1_float32":
        "47bfd8d28985b587100f3937db040722e6c2160e4816b0f265aaa39c4896c44e",
    "5_512_256_0_bfloat16":
        "5d736c52b1ffbe0416afc5e780e509749f4086e11ea5c33d3ba5ca2b24183102",
    "5_512_256_0_float32":
        "3a6a538e21f6c48c7463b31630da62c45e00a7247a3e9de22cb262d0f7311ffb",
    "5_512_256_1_bfloat16":
        "450791c34125026ca4e43c4c528e8b2fd8c2694dca7c129741ddcfa6df9bd6ef",
    "5_512_256_1_float32":
        "7ea8465c01436230d8ef8f5027b2beefb3b5241d4ed062ca8e9ac25bf9599907",
    "7_20_24_0_bfloat16":
        "820da1ad16bd67c05917ae5418bedb1dd43a5d484aa54dfecb1ec4c15d633694",
    "7_20_24_0_float32":
        "54394fb187c002e30064a64f3d87e2c4bea738906be7474e42d6936e4f90b0e7",
    "7_32_1024_0_bfloat16":
        "3b6f2916f7bb0e5e6d8f5ae1762e2c7722974ba7386816932d471153a5c9d786",
    "7_32_1024_0_float32":
        "66fd455277f39207b8dc5b0d2f150cfea2f92d09a5fe0c81559e4146bf0e4937",
    "7_512_256_0_bfloat16":
        "5d736c52b1ffbe0416afc5e780e509749f4086e11ea5c33d3ba5ca2b24183102",
    "7_512_256_0_float32":
        "3a6a538e21f6c48c7463b31630da62c45e00a7247a3e9de22cb262d0f7311ffb",
    "8_20_24_0_bfloat16":
        "5812beb606a3dc160f70a842dead2ceae93a9fbb8152a80db270a435f131bd4e",
    "8_20_24_0_float32":
        "ea43634d5a193223d7c133d0bf1bf71193c76d7701cd49f3057839c54467e91e",
    "8_32_1024_0_bfloat16":
        "1fe05b5c32adfafecede41021591a3d499e3146b8de0fffa0859bddad4856d8e",
    "8_32_1024_0_float32":
        "2bb051db25772723dfcec35ed13f14fba687c34e12b9d34cd0ea3b82307b66a2",
    "8_512_256_0_bfloat16":
        "ce43a0009bc35d3c0f203b3f10e4d2500339e3540b32dd382b905c46311b2434",
    "8_512_256_0_float32":
        "a5dc17c0c3a466d8fede11e1b847f13c584e099f6b34e943ba12c875d27f22cd",
}


@pytest.mark.cuda
def test_forward_body_keeps_its_bits(cuda):
    """The forwards keep the bits recorded from the tensor-core forward
    body, so that a later change to the body or its grid shows."""
    got = _fwd_digests(cuda)
    assert set(got) == set(FWD_DIGESTS)
    changed = sorted(k for k in got if got[k] != FWD_DIGESTS[k])
    assert not changed, changed


def _opcheck_cases(dev):
    """Operands of the three serving kernels' operators at the shapes a
    batch-16 Swin-B request (stage 0 of #1 with its shift mask, stage 3
    of #15) and a batch-64 mmformer_n forward give them."""
    g = torch.Generator().manual_seed(19)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    x, w, b, bias = _inputs(16 * 64, 128, 4, seed=19)
    mask = shift_attn_mask(56, 56, 7, 3)
    wa = (torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev),
          torch.from_numpy(b).to(dev), torch.from_numpy(bias).to(dev),
          torch.from_numpy(mask).float().to(dev), 4, 32 ** -0.5)
    sa = (r(64, 196, 512), r(3 * 512, 512, scale=512 ** -0.5), 8, 0.125)
    mlp = (r(16 * 49, 1024), r(4096, 1024, scale=1024 ** -0.5),
           r(4096, scale=0.1), r(1024, 4096, scale=4096 ** -0.5),
           r(1024, scale=0.1))
    return {"wa_qkv_fused_eval": wa, "sa_fused_eval": sa,
            "mlp_fused_fwd": mlp}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wa_qkv_fused_eval", "sa_fused_eval",
                                  "mlp_fused_fwd"])
def test_serving_operators_pass_opcheck(cuda, name):
    """#1, #13 and #15 as the operators that torch.export records:
    torch.library.opcheck (schema, fake implementation against the
    launch, dispatch under AOT autograd with dynamic shapes)."""
    import gdl_tpu_torch.ops.mlp  # noqa: F401  (registers the operators)
    import gdl_tpu_torch.ops.self_attention  # noqa: F401

    op = getattr(torch.ops.gdl_tpu_torch, name).default
    torch.library.opcheck(op, _opcheck_cases(cuda)[name])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_multi_rank_batch_norm_path_matches_batch_norm(cuda, dtype, tol):
    """The multi-rank BatchNorm's CUDA path (torch's SyncBatchNorm
    primitives, `models/layers.py`) at world size 1, where its
    all-reduces are no-ops, on a channels_last batch whose |mean| ≫ std
    as the spectrogram stem's: output, input gradient and parameter
    gradients within `tol` × each tensor's largest magnitude of a float64
    BatchNorm of the same inputs (bf16: about two units in the last
    place), and the running statistics as nn.BatchNorm2d's."""
    from gdl_tpu_torch.models.layers import GlobalBatchNorm2d

    g = torch.Generator().manual_seed(23)
    x = (torch.randn(8, 16, 12, 10, generator=g) * 0.5 + 20.0).to(
        cuda, dtype).contiguous(memory_format=torch.channels_last)
    gy = torch.randn(x.shape, generator=g).to(cuda, dtype)
    weight = torch.rand(16, generator=g) + 0.5
    bias = torch.randn(16, generator=g)

    xd = x.double().requires_grad_()
    wd = weight.to(cuda, torch.float64).requires_grad_()
    bd = bias.to(cuda, torch.float64).requires_grad_()
    var, mean = torch.var_mean(xd, (0, 2, 3), correction=0, keepdim=True)
    yd = ((xd - mean) * torch.rsqrt(var + 1e-5) * wd.view(1, -1, 1, 1)
          + bd.view(1, -1, 1, 1))
    yd.backward(gy.double())

    ref = torch.nn.BatchNorm2d(16).to(cuda).train()
    ref(x)
    bn = GlobalBatchNorm2d(16)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    bn = bn.to(cuda).train()
    xi = x.clone().requires_grad_()
    y = bn.global_forward(xi)
    y.backward(gy)
    assert y.dtype == dtype and xi.grad.dtype == dtype
    for name, got, want in (("y", y, yd), ("dx", xi.grad, xd.grad),
                            ("dweight", bn.weight.grad, wd.grad),
                            ("dbias", bn.bias.grad, bd.grad)):
        err = float((got.double() - want).abs().max())
        assert err <= tol * float(want.abs().max()), (name, err)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        torch.testing.assert_close(getattr(bn, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-5, msg=name)
