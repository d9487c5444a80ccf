"""The port's dropout-mask generator (`gdl_tpu_torch/ops/dropout.py`):
Philox4x32-10 in torch integer arithmetic against an independent
pure-Python implementation and Random123's known-answer vectors, and the
properties gdl_tpu's `prng_dropout_mask` is held to (its own bits come
from the TPU's generator and cannot be reproduced): the unsigned keep
rule, values exactly {0, 1/(1-rate)}, the keep rate, determinism per
seed, other bits for another seed or call site."""

import numpy as np
import pytest
import torch

from gdl_tpu_torch.ops import dropout as port_dropout
from gdl_tpu_torch.ops.dropout import (
    fold_seed_words,
    keep_threshold,
    philox_keep_mask,
    philox_u32,
    prng_dropout_mask,
)

M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF


def philox4x32_10(counter, key):
    """Philox4x32-10 on Python integers (Salmon et al., SC'11)."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & MASK32,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & MASK32]
        k = [(k[0] + W0) & MASK32, (k[1] + W1) & MASK32]
    return c


# Random123's kat_vectors for philox4x32 with 10 rounds
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((MASK32,) * 4, (MASK32,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_reference_implementation_meets_known_answers(counter, key, want):
    assert tuple(philox4x32_10(counter, key)) == want


def _words(k0, k1):
    """Two u32 key words as the int32 tensor the kernels take."""
    return torch.tensor([k0, k1], dtype=torch.int64).to(torch.int32)


def test_torch_generator_meets_the_zero_known_answer():
    got = philox_u32(_words(0, 0), 4).tolist()
    assert tuple(got) == KAT[0][2]


@pytest.mark.parametrize("key", [(0, 0), (MASK32, MASK32),
                                 (0xa4093822, 0x299f31d0), (1, 0x80000000)])
def test_torch_generator_equals_the_reference(key):
    """Element e is word e % 4 of philox(counter=(e // 4, 0, 0, 0), key),
    for signed and unsigned views of the key words alike."""
    n = 203  # not a multiple of 4
    got = philox_u32(_words(*key), n).tolist()
    want = []
    for g in range((n + 3) // 4):
        want += philox4x32_10((g, 0, 0, 0), key)
    assert got == want[:n]


def test_high_counter_word():
    """Groups beyond 2^32 move to the counter's second word."""
    import gdl_tpu_torch.ops.dropout as d

    key = (7, 9)
    big = (1 << 32) + 5
    groups = torch.tensor([big], dtype=torch.int64)
    c0, c1 = groups & MASK32, groups >> 32
    assert (int(c0), int(c1)) == (5, 1)
    hi, lo = d._mulhilo(M0, torch.tensor([MASK32], dtype=torch.int64))
    assert (int(hi), int(lo)) == ((M0 * MASK32) >> 32, (M0 * MASK32) & MASK32)
    assert philox4x32_10((5, 1, 0, 0), key) != philox4x32_10((5, 0, 0, 0),
                                                             key)


def test_keep_threshold_is_gdl_tpus():
    assert keep_threshold(0.1) == int(round(0.9 * 2 ** 32))
    assert keep_threshold(0.0) == 2 ** 32 - 1
    assert keep_threshold(0.5) == 2 ** 31


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_values_and_keep_rate(dtype):
    """[64·196, 512] at rate 0.1: values exactly {0, 1/(1-rate)} in the
    mask's dtype, the keep rate within 4 sigma of 0.9 (a signed compare
    would give about half of it)."""
    gen = torch.Generator().manual_seed(0)
    shape = (64 * 196, 512)
    mask = prng_dropout_mask(fold_seed_words(gen, "cpu"), shape, 0.1, dtype)
    assert mask.dtype == dtype and tuple(mask.shape) == shape
    kept = torch.tensor(1.0 / 0.9, dtype=torch.float32).to(dtype)
    values = set(mask.unique().tolist())
    assert values == {0.0, float(kept)}
    rate = float((mask != 0).float().mean())
    sigma = (0.9 * 0.1 / mask.numel()) ** 0.5
    assert abs(rate - 0.9) < 4 * sigma, rate


def test_mask_is_a_function_of_seed_words_and_flat_index():
    gen = torch.Generator().manual_seed(1)
    words = fold_seed_words(gen, "cpu")
    a = prng_dropout_mask(words, (8, 6, 32), 0.3)
    b = prng_dropout_mask(words, (8, 6, 32), 0.3)
    assert torch.equal(a, b)
    # the same stream under any shape: nothing of a tiling enters
    assert torch.equal(a.reshape(-1),
                       prng_dropout_mask(words, (48 * 32,), 0.3))
    assert torch.equal(a.reshape(-1)[:100],
                       prng_dropout_mask(words, (100,), 0.3))
    # the keep mask is the thresholded stream
    keep = philox_keep_mask(words, (8, 6, 32), 0.3)
    assert torch.equal(keep, a != 0)
    assert torch.equal(
        keep.reshape(-1),
        philox_u32(words, keep.numel()) < keep_threshold(0.3))


def test_other_seed_words_and_call_sites_give_other_bits():
    """Every call of `dropout` draws fresh words from the generator, so
    two sites (or two steps) never share a mask; the same generator
    state gives the same masks again."""
    x = torch.ones(64, 128)
    gen = torch.Generator().manual_seed(2)
    first = port_dropout.dropout(x, 0.5, gen)
    second = port_dropout.dropout(x, 0.5, gen)
    assert not torch.equal(first, second)
    gen.manual_seed(2)
    assert torch.equal(first, port_dropout.dropout(x, 0.5, gen))
    gen3 = torch.Generator().manual_seed(3)
    assert not torch.equal(first, port_dropout.dropout(x, 0.5, gen3))


def test_fold_seed_words():
    gen = torch.Generator().manual_seed(4)
    words = fold_seed_words(gen, "cpu")
    assert words.dtype == torch.int32 and tuple(words.shape) == (2,)
    assert not torch.equal(words, fold_seed_words(gen, "cpu"))
    gen.manual_seed(4)
    assert torch.equal(words, fold_seed_words(gen, "cpu"))
    assert fold_seed_words(None, "cpu").dtype == torch.int32


def test_dropout_scales_and_has_the_masks_gradient():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(16, 256, requires_grad=True)
    state = gen.get_state()
    y = port_dropout.dropout(x, 0.25, gen)
    gen.set_state(state)
    mask = prng_dropout_mask(fold_seed_words(gen, "cpu"), x.shape, 0.25)
    assert torch.equal(y, x * mask)
    y.sum().backward()
    assert torch.equal(x.grad, mask)
    np.testing.assert_allclose(float(mask.mean()), 1.0, atol=0.05)


def test_rate_zero_is_the_identity():
    x = torch.randn(4, 8)
    gen = torch.Generator().manual_seed(6)
    state = gen.get_state()
    assert port_dropout.dropout(x, 0.0, gen) is x
    assert torch.equal(gen.get_state(), state)  # nothing was drawn
    ones = prng_dropout_mask(fold_seed_words(gen, "cpu"), (1000,), 0.0)
    assert float(ones.min()) == 1.0  # 1 - 2^-32 keeps all but never-seen words


def test_arguments_are_checked():
    words = fold_seed_words(torch.Generator().manual_seed(7), "cpu")
    with pytest.raises(ValueError, match="impl must be"):
        prng_dropout_mask(words, (4,), 0.1, impl="kernel")
    with pytest.raises(ValueError, match="rate must be"):
        prng_dropout_mask(words, (4,), 1.0)
