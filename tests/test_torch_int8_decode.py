"""The bit-level int8 -> bf16 decode of the tensor-core kernels, written in
numpy with the kernels' own constants and byte selectors, over every byte
value, against ``float(b)`` and the JAX int8 body's convert (``jnp.int8 ->
jnp.bfloat16``, ``lookaheaddecoding_tpu/ops/quant_matmul.py:282``). On the
CPU nothing else reaches this code: the kernels run only on the card.

The CUDA sources are under ``lookaheaddecoding_tpu_torch/ops/csrc/``:
``int8_pair`` (``mma_sync.cuh``, lines 78-90: the constants at 79-83), the
int8 product's B fragments (``quant_matmul_mma.cuh``, lines 208-230: the
row loads at 208-221, the selector at 228) and the attention kernel's int8
K/V tile conversion (``lookahead_attention.cu``, lines 645-646).
"""

import jax.numpy as jnp
import numpy as np
import pytest

# int8_pair's constants
LO_MAGIC = 0x43004300    # bf16 128 in both halves; | the low nibble
HI_MAGIC = 0x43084308    # bf16 136 in both halves; ^ the high nibble
SIXTEEN = 0x41804180     # bf16 16 in both halves
MINUS_2304 = 0xC510C510  # bf16 -2304 in both halves
ONE = 0x3F803F80         # bf16 1.0 in both halves

BYTES = np.arange(256, dtype=np.uint32)          # every byte
VALUES = BYTES.astype(np.uint8).view(np.int8).astype(np.float32)  # as int8


def bf16_to_f32(bits):
    """bf16 bit patterns (uint32 holding 16 bits) as float32 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def f32_to_bf16_rn(x):
    """float32 -> bf16 bits, round to nearest even (what fma.rn.bf16x2
    does with its exact result)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF


def fma_bf16x2(a, b, c):
    """fma.rn.bf16x2 on two packed halves: a * b + c in each half, exact
    (float64 holds every product and sum of these operands) and then
    rounded once."""
    out = np.zeros_like(a)
    for shift in (0, 16):
        half = [bf16_to_f32((v >> shift) & 0xFFFF) for v in (a, b, c)]
        exact = half[0].astype(np.float64) * half[1] + half[2]
        assert np.all(exact.astype(np.float32) == exact)
        out |= f32_to_bf16_rn(exact.astype(np.float32)) << shift
    return out


def int8_pair(d):
    """The kernel's int8_pair: d holds two int8 values in its bytes 0 and
    2; returns them as a bf16x2 word."""
    d = np.asarray(d, np.uint32)
    lo = (d & 0x000F000F) | LO_MAGIC
    hi = ((d >> 4) & 0x000F000F) ^ HI_MAGIC
    a = fma_bf16x2(hi, np.full_like(d, SIXTEEN), np.full_like(d, MINUS_2304))
    return fma_bf16x2(lo, np.full_like(d, ONE), a)


def byte_perm(x, y, selector):
    """__byte_perm(x, y, s): byte n of the result is byte s[4n:4n+3] of the
    eight bytes {y, x} (x's bytes 0-3, then y's)."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
           [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(selector >> (4 * n)) & 7] << (8 * n) for n in range(4))


def halves(word):
    return bf16_to_f32(word & 0xFFFF), bf16_to_f32(word >> 16)


def words_of(rows):
    """[R, W*4] uint8 bytes -> [R, W] little-endian uint32 words."""
    return np.ascontiguousarray(rows, dtype=np.uint8).view(np.uint32)


def test_jax_convert_is_the_value():
    """The JAX int8 body casts its block to x's dtype: every int8 value is
    exact in bf16."""
    conv = np.asarray(jnp.asarray(VALUES.astype(np.int8)).astype(
        jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(conv, VALUES)


@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_int8_pair_of_byte_j_of_two_words(j):
    """The B3 selector j | (j + 4) << 8 on rows k (wa) and k + 1 (wb):
    every pair of byte values, the other bytes of the words set, gives
    (float(wa byte j), float(wb byte j)) and the JAX convert's bits."""
    a, b = np.meshgrid(BYTES, BYTES, indexing="ij")
    a, b = a.ravel(), b.ravel()
    filler = np.uint32(0xA5)
    wa = np.zeros_like(a)
    wb = np.zeros_like(b)
    for i in range(4):
        wa |= (a if i == j else filler) << (8 * i)
        wb |= (b if i == j else filler) << (8 * i)
    got = int8_pair(byte_perm(wa, wb, j | ((j + 4) << 8)))
    low, high = halves(got)
    np.testing.assert_array_equal(low, VALUES[a])
    np.testing.assert_array_equal(high, VALUES[b])
    jax_bits = np.asarray(jnp.asarray(VALUES.astype(np.int8)).astype(
        jnp.bfloat16)).view(np.uint16).astype(np.uint32)
    np.testing.assert_array_equal(got & 0xFFFF, jax_bits[a])
    np.testing.assert_array_equal(got >> 16, jax_bits[b])


def test_int8_pair_ignores_bytes_1_and_3():
    """Only bytes 0 and 2 of the word are read."""
    rng = np.random.RandomState(0)
    d = rng.randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    clean = d & 0x00FF00FF
    np.testing.assert_array_equal(int8_pair(d), int8_pair(clean))


@pytest.mark.parametrize("nt8", [2, 4, 8])
def test_b_fragments_from_the_k_n_layout(nt8):
    """mma_tile_regs with DEC_INT8: lane (g, q) of a warp whose slice is
    8 * nt8 columns reads nt8 bytes of rows 2q, 2q + 1, 2q + 8, 2q + 9 of
    a k16 step at byte NT8 * g of the slice; n8 tile j's b0 must be
    (W[2q, NT8 g + j], W[2q + 1, NT8 g + j]) and b1 the same at rows
    2q + 8 and 2q + 9: the fragment layout of mma.m16n8k16 (B[k, n], k of
    the pair in the lower half), with fragment column g of tile j being
    column NT8 g + j of the slice."""
    rng = np.random.RandomState(nt8)
    width = 8 * nt8
    w = rng.randint(-128, 128, size=(16, width)).astype(np.int8)
    raw = w.view(np.uint8)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        rows = [2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9]
        piece = raw[rows][:, nt8 * g:nt8 * (g + 1)]
        if nt8 == 2:           # a 16-bit load: zero-extended
            words = piece.astype(np.uint32)[:, :1] | (
                piece.astype(np.uint32)[:, 1:2] << 8)
        else:
            words = words_of(piece)
        for j in range(nt8):
            sel = (j % 4) | ((j % 4 + 4) << 8)
            b0 = int8_pair(byte_perm(words[0, j // 4], words[1, j // 4], sel))
            b1 = int8_pair(byte_perm(words[2, j // 4], words[3, j // 4], sel))
            col = nt8 * g + j
            np.testing.assert_array_equal(
                np.concatenate([halves(b0), halves(b1)]).ravel(),
                w[[2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9], col].astype(
                    np.float32))


def test_attention_tile_conversion_of_a_16_byte_piece():
    """The attention kernel's int8 K/V tile: each word of a 16-byte piece
    becomes two bf16x2 words by the selectors 0x0100 (bytes 0, 1) and
    0x0302 (bytes 2, 3), stored in order: the 16 values of the piece, row
    order kept."""
    rng = np.random.RandomState(1)
    piece = rng.randint(0, 256, size=(512, 16)).astype(np.uint8)
    words = words_of(piece)
    out = np.zeros((512, 16), np.float32)
    for e in range(4):
        for h, sel in enumerate((0x0100, 0x0302)):
            low, high = halves(int8_pair(byte_perm(
                words[:, e], np.zeros_like(words[:, e]), sel)))
            out[:, 4 * e + 2 * h] = low
            out[:, 4 * e + 2 * h + 1] = high
    np.testing.assert_array_equal(out, piece.view(np.int8).astype(
        np.float32))


def test_int8_pair_constants():
    """The constants' values; 128 + lo and 136 + h for every nibble; every
    intermediate of the two fmas is exact in bf16."""
    assert bf16_to_f32(0x4300) == 128.0
    assert bf16_to_f32(0x4308) == 136.0
    assert bf16_to_f32(0x4180) == 16.0
    assert bf16_to_f32(0xC510) == -2304.0
    assert bf16_to_f32(0x3F80) == 1.0
    for n in range(16):
        assert bf16_to_f32(0x4300 | n) == 128.0 + n
    for h in range(-8, 8):
        m = bf16_to_f32(0x4300 | ((h & 15) ^ 8))
        assert m == 136.0 + h
        first = 16.0 * m - 2304.0
        assert first == 16 * h - 128
        assert bf16_to_f32(f32_to_bf16_rn(np.float32(first))) == first
