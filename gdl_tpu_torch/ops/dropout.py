"""Dropout masks from a counter-based generator. Port of
`gdl_tpu/ops/dropout.py` (`prng_dropout_mask`, Pallas body `_mask_kernel`).

gdl_tpu draws its masks from the TPU's own in-kernel generator, whose
bits are implementation-defined. The port draws them from Philox4x32-10
(`kernels/philox.cuh`), keyed by two seed words and the flat element
index alone: element e of a mask takes word e % 4 of
philox(counter=(lo32(e // 4), hi32(e // 4), 0, 0), key=seed words) and is
kept iff that word, as an unsigned integer, is below
min(round((1 - rate)·2³²), 2³² − 1): gdl_tpu's keep rule. Mask values
are exactly 0 and 1/(1 − rate) rounded to the mask's dtype.

`philox_u32` is the generator in torch integer arithmetic (the 32×32→64
bit products are split so that int64 never overflows). It runs on any
device and is bit-equal to the CUDA code, so the kernels (this module's
#14 and the fused self-attention's in-kernel dropout) are held to it bit
for bit, and the CPU tests run it.

`prng_dropout_mask` launches `kernels/dropout_mask.cu` when its seed
words lie on a CUDA device and runs the plain version when they lie on
the CPU; impl="plain" runs the plain version anywhere. Nothing falls
back. The multiply `x * mask` stays outside the kernel, as in gdl_tpu;
autograd keeps the mask for the backward.

Counter layout. Every generator here takes `offset`: an element offset
(a multiple of 4) or a layout (offset, seg_elems, seg_stride), all three
multiples of 4. Element e of the mask is element
offset + (e // seg_elems)·seg_stride + e % seg_elems of the stream, word
s % 4 of group s / 4 for that stream element s; a Philox group never
straddles two segments. One segment (seg_stride == seg_elems; an int
offset is one) is elements offset, offset + 1, ... of the stream. A rank
of a data-parallel run passes where its rows lie in the global tensor
(`parallel.distributed.element_layout`): one segment for a [B...] tensor,
and for `passes` stacked batches [passes·b, ...] one segment a pass (pass
p's b rows are rows p·B + k·b ... of the one-process [passes·B] stack on
rank k), so its mask is its rows of the mask one process draws for the
global batch, without drawing the rest. Offset 0 is the mask of before.

Seed words. `fold_seed_words(generator, device)` draws two int32 words
from the explicit generator as a [2] tensor on the generator's own
device and hands them to the kernels as a device pointer: a call site
costs no device-to-host copy, and every call draws new words, so every
site and every step gets its own mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Union

import torch

from gdl_tpu_torch import kernels
from gdl_tpu_torch.parallel.distributed import element_layout
from gdl_tpu_torch.utils.profiling import annotate

KERNEL_NAME = "prng_dropout_mask"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """The u32 threshold of keep probability 1 − rate (exact to 2⁻³²)."""
    return min(int(round((1.0 - rate) * 2 ** 32)), 2 ** 32 - 1)


def fold_seed_words(generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
    """Two fresh int32 seed words, a [2] tensor on `device`, drawn from
    `generator` (None: torch's default generator of `device`). They are
    drawn on the generator's device; if that is not `device` they are
    copied there (host to device at most, never back)."""
    device = torch.device(device)
    src = generator.device if generator is not None else device
    words = torch.randint(-2 ** 31, 2 ** 31, (2,), generator=generator,
                          device=src, dtype=torch.int64).to(torch.int32)
    return words if words.device == device else words.to(device)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi32, lo32) of a·b for a 32-bit constant a and b in [0, 2³²),
    int64 throughout without overflow."""
    t1 = a * (b >> 16)      # < 2^48
    t0 = a * (b & 0xFFFF)   # < 2^48
    s = ((t1 & 0xFFFF) << 16) + (t0 & _U32)  # < 2^33
    return (t1 >> 16) + (t0 >> 32) + (s >> 32), s & _U32


def check_offset(offset: int) -> int:
    """`offset` as an int, raising unless it is a multiple of 4 (a whole
    Philox group) and not negative."""
    offset = int(offset)
    if offset < 0 or offset % 4:
        raise ValueError(f"element offset must be a non-negative multiple "
                         f"of 4, got {offset}")
    return offset


class Layout(NamedTuple):
    """Where a mask's elements lie in the generator's stream: element e
    draws stream element offset + (e // seg_elems)·seg_stride
    + e % seg_elems. seg_elems == seg_stride is one segment."""
    offset: int = 0
    seg_elems: int = 0
    seg_stride: int = 0


def check_layout(offset: Union[int, Sequence[int]]) -> Layout:
    """An element offset or an (offset, seg_elems, seg_stride) triple as
    a `Layout`, one segment as (offset, 0, 0); raising unless every part
    is a whole number of Philox groups and the segments do not overlap."""
    if isinstance(offset, (tuple, list)):
        offset, seg_elems, seg_stride = (int(v) for v in offset)
    else:
        seg_elems = seg_stride = 0
    offset = check_offset(offset)
    if seg_elems == seg_stride:
        return Layout(offset)
    if seg_elems <= 0 or seg_elems % 4 or seg_stride % 4:
        raise ValueError(f"seg_elems and seg_stride must be positive "
                         f"multiples of 4, got {seg_elems}, {seg_stride}")
    if seg_stride < seg_elems:
        raise ValueError(f"seg_stride {seg_stride} < seg_elems {seg_elems}: "
                         f"the segments would overlap")
    return Layout(offset, seg_elems, seg_stride)


def philox_u32(seed_words: torch.Tensor, n: int,
               offset: Union[int, Sequence[int]] = 0) -> torch.Tensor:
    """The n words of the stream of `seed_words` ([2] integer tensor; the
    low 32 bits of each count) that a mask of n elements at `offset` (an
    element offset or a layout, `check_layout`) draws, as int64 values in
    [0, 2³²) on the seed words' device."""
    dev = seed_words.device
    key = seed_words.to(torch.int64) & _U32
    k0, k1 = key[0], key[1]
    lay = check_layout(offset)
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=dev)
    if lay.seg_elems:  # local group → stream group
        per = lay.seg_elems // 4
        groups = groups // per * (lay.seg_stride // 4) + groups % per
    groups = groups + lay.offset // 4
    c0, c1 = groups & _U32, groups >> 32
    c2 = torch.zeros_like(groups)
    c3 = torch.zeros_like(groups)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return torch.stack([c0, c1, c2, c3], dim=1).reshape(-1)[:n]


def philox_keep_mask(seed_words: torch.Tensor, shape: Sequence[int],
                     rate: float, offset: Union[int, Sequence[int]] = 0
                     ) -> torch.Tensor:
    """The bool keep mask of `shape` (row-major element order), at
    `offset` (an element offset or a layout) of the stream."""
    n = math.prod(shape)
    return (philox_u32(seed_words, n, offset)
            < keep_threshold(rate)).reshape(tuple(shape))


def prng_dropout_mask_ref(seed_words: torch.Tensor, shape: Sequence[int],
                          rate: float, dtype: torch.dtype = torch.float32,
                          offset: Union[int, Sequence[int]] = 0
                          ) -> torch.Tensor:
    """Plain PyTorch version of the mask generator."""
    keep = philox_keep_mask(seed_words, shape, rate, offset)
    kept = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32,
                        device=keep.device).to(dtype)
    return torch.where(keep, kept, torch.zeros((), dtype=dtype,
                                               device=keep.device))


def _launch_mask(seed_words, shape, rate, dtype, offset):
    with annotate(kernels.span_names[KERNEL_NAME]):
        if dtype not in _DTYPE_CODES:
            raise ValueError(f"kernel takes float32 or bfloat16, got {dtype}")
        if (seed_words.dtype != torch.int32 or tuple(seed_words.shape) != (2,)
                or not seed_words.is_contiguous()):
            raise ValueError(
                "seed_words must be a contiguous int32 tensor [2]")
        lay = check_layout(offset)
        lib = kernels.load("dropout_mask")
        out = torch.empty(tuple(shape), dtype=dtype, device=seed_words.device)
        stream = torch.cuda.current_stream(seed_words.device).cuda_stream
        err = lib.gdl_dropout_mask_launch(
            out.data_ptr(), out.numel(), *lay, seed_words.data_ptr(),
            keep_threshold(rate), 1.0 / (1.0 - rate), _DTYPE_CODES[dtype],
            stream)
        if err != 0:
            raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError {err}")
        kernels.launch_counts[KERNEL_NAME] += 1
    return out


def prng_dropout_mask(seed_words: torch.Tensor, shape: Sequence[int],
                      rate: float, dtype: torch.dtype = torch.float32,
                      impl: str = "auto",
                      offset: Union[int, Sequence[int]] = 0) -> torch.Tensor:
    """The {0, 1/(1−rate)} dropout mask of `shape` in `dtype`, on the
    seed words' device, at `offset` (an element offset or a layout) of
    the stream.
    impl="auto": the CUDA kernel for CUDA seed words (raising if it
    cannot), the plain version for CPU ones; "plain": the plain version on
    any device."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")
    if impl == "auto" and seed_words.is_cuda:
        with torch.cuda.device(seed_words.device):
            return _launch_mask(seed_words, shape, rate, dtype, offset)
    return prng_dropout_mask_ref(seed_words, shape, rate, dtype, offset)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            impl: str = "auto", passes: int = 1) -> torch.Tensor:
    """Train-time dropout: x · mask, the mask in x's dtype from fresh seed
    words of `generator`. rate 0 returns x itself. x's leading dimension
    is `passes` stacked batches: under a process group the mask is this
    rank's rows of the global batches' (`element_layout`)."""
    if rate == 0.0:
        return x
    words = fold_seed_words(generator, x.device)
    return x * prng_dropout_mask(words, x.shape, rate, x.dtype, impl,
                                 element_layout(x.numel(), passes))
