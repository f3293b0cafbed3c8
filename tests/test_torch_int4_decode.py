"""The bit-level nibble -> bf16 decode of the tensor-core int4 kernels,
written in numpy with the kernels' own constants, over every byte value,
against ``quant.unpack_int4`` (and the JAX package's unpack in
``dequantize_weight``). On the CPU nothing else reaches this code: the
kernels run only on the card.

The CUDA source is ``lookaheaddecoding_tpu_torch/ops/csrc/quant_matmul_mma.cuh``:
``magic_pair`` (lines 92-100: the constants at 93-95), ``decode_pair``
(lines 104-114) and ``decode_tile``'s byte selectors (lines 290-291).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookaheaddecoding_tpu.ops import quant as jquant
from lookaheaddecoding_tpu_torch.ops import quant

# magic_pair's constants
MAGIC = 0x43084308      # bf16 136 in both halves; ^ 8 flips the nibble's top bit
ONE = 0x3F803F80        # bf16 1.0 in both halves
MINUS_136 = 0xC308C308  # bf16 -136 in both halves

BYTES = np.arange(256, dtype=np.uint32)          # every packed byte


def bf16_to_f32(bits):
    """bf16 bit patterns (uint32 holding 16 bits) as float32 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def f32_to_bf16_rn(x):
    """float32 -> bf16 bits, round to nearest even (what fma.rn.bf16x2
    does with its exact float32 result)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF


def fma_bf16x2(a, b, c):
    """fma.rn.bf16x2 on two packed halves: a * b + c in each half."""
    out = np.zeros_like(a)
    for shift in (0, 16):
        half = [bf16_to_f32((v >> shift) & 0xFFFF) for v in (a, b, c)]
        exact = half[0].astype(np.float64) * half[1] + half[2]
        out |= f32_to_bf16_rn(exact.astype(np.float32)) << shift
    return out


def magic_pair(d):
    """The kernel's magic_pair: d holds two packed bytes in its bytes 0 and
    2; returns the (lo, hi) bf16x2 words."""
    lo = fma_bf16x2((d & 0x000F000F) ^ MAGIC, np.full_like(d, ONE),
                    np.full_like(d, MINUS_136))
    hi = fma_bf16x2(((d >> 4) & 0x000F000F) ^ MAGIC, np.full_like(d, ONE),
                    np.full_like(d, MINUS_136))
    return lo, hi


def byte_perm(x, y, selector):
    """__byte_perm(x, y, s): byte n of the result is byte s[4n:4n+3] of the
    eight bytes {y, x} (x's bytes 0-3, then y's)."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
           [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(selector >> (4 * n)) & 7] << (8 * n) for n in range(4))


def halves(word):
    return bf16_to_f32(word & 0xFFFF), bf16_to_f32(word >> 16)


def reference_planes():
    """(lo, hi) nibble values of every byte, from quant.unpack_int4."""
    lo, hi = quant.unpack_int4(torch.from_numpy(
        BYTES.astype(np.uint8).view(np.int8)))
    return lo.numpy().astype(np.float32), hi.numpy().astype(np.float32)


def test_reference_planes_match_the_jax_unpack():
    packed = jnp.asarray(BYTES.astype(np.uint8).view(np.int8)).reshape(256, 1)
    wq = {"q4": packed, "scale": jnp.ones((1, 1), jnp.float32)}
    q = np.asarray(jquant.dequantize_weight(wq, jnp.float32)).ravel()
    lo, hi = reference_planes()
    np.testing.assert_array_equal(q[:256], lo)
    np.testing.assert_array_equal(q[256:], hi)


@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_magic_decode_of_byte_j_of_two_words(j):
    """decode_pair<DEC_MAGIC>: byte j of wa (packed row k) and of wb (row
    k + 1), every byte value in each, four bytes a word."""
    lo_ref, hi_ref = reference_planes()
    a, b = np.meshgrid(BYTES, BYTES, indexing="ij")
    a, b = a.ravel(), b.ravel()
    filler = np.uint32(0x5A)          # the other bytes of the words
    wa = np.full_like(a, 0)
    wb = np.full_like(b, 0)
    for i in range(4):
        wa |= (a if i == j else filler) << (8 * i)
        wb |= (b if i == j else filler) << (8 * i)
    lo, hi = magic_pair(byte_perm(wa, wb, j | ((j + 4) << 8)))
    lo_k, lo_k1 = halves(lo)
    hi_k, hi_k1 = halves(hi)
    np.testing.assert_array_equal(lo_k, lo_ref[a])
    np.testing.assert_array_equal(lo_k1, lo_ref[b])
    np.testing.assert_array_equal(hi_k, hi_ref[a])
    np.testing.assert_array_equal(hi_k1, hi_ref[b])


def test_magic_decode_of_a_16_byte_piece():
    """decode_tile: bytes (0, 1) and (2, 3) of a word become the pairs of
    columns (4i, 4i + 1) and (4i + 2, 4i + 3), lower column in the lower
    half."""
    lo_ref, hi_ref = reference_planes()
    rng = np.random.RandomState(0)
    words = rng.randint(0, 2**32, size=4096, dtype=np.uint64).astype(
        np.uint32)
    cols = [(words >> (8 * i)) & 0xFF for i in range(4)]
    for selector, (c0, c1) in ((0x0100, (0, 1)), (0x0302, (2, 3))):
        lo, hi = magic_pair(byte_perm(words, np.zeros_like(words), selector))
        np.testing.assert_array_equal(halves(lo)[0], lo_ref[cols[c0]])
        np.testing.assert_array_equal(halves(lo)[1], lo_ref[cols[c1]])
        np.testing.assert_array_equal(halves(hi)[0], hi_ref[cols[c0]])
        np.testing.assert_array_equal(halves(hi)[1], hi_ref[cols[c1]])


@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_shift_decode_equals_the_magic_decode(j):
    """decode_pair<DEC_SHIFT> (the shift variant's policy): each nibble
    moved to the top of the word, shifted back arithmetically, converted;
    the same exact values as the magic decode, so the same bits."""
    lo_ref, hi_ref = reference_planes()
    w = (BYTES << (8 * j)) | (np.uint32(0xA5) << (8 * ((j + 1) % 4)))
    s_lo, s_hi = 28 - 8 * j, 24 - 8 * j
    lo = ((w << np.uint32(s_lo)).astype(np.uint32).view(np.int32) >> 28)
    hi = ((w << np.uint32(s_hi)).astype(np.uint32).view(np.int32) >> 28)
    np.testing.assert_array_equal(lo.astype(np.float32), lo_ref)
    np.testing.assert_array_equal(hi.astype(np.float32), hi_ref)
    # exact in bf16: the conversion keeps every value
    for v in (lo, hi):
        bits = f32_to_bf16_rn(v.astype(np.float32))
        np.testing.assert_array_equal(bf16_to_f32(bits), v)


def test_magic_constants():
    """0x4308 is bf16 136, 0x3F80 is 1.0 and 0xC308 is -136; 128 + (n ^ 8)
    is 136 + n for every signed nibble n."""
    assert bf16_to_f32(0x4308) == 136.0
    assert bf16_to_f32(0x3F80) == 1.0
    assert bf16_to_f32(0xC308) == -136.0
    for n in range(-8, 8):
        assert bf16_to_f32(0x4300 | ((n & 15) ^ 8)) == 136.0 + n
