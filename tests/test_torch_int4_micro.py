"""The plain versions of the int4 product's two micro-benchmark variants
(``ops/int4_micro.py``) on the CPU, against the port's ``int4_matmul_ref``
and against the JAX package's ``int4_matmul`` (its Pallas kernel in
interpret mode), on the micro-benchmark's four (K, N) shapes scaled down
4x (N rounded to what the JAX kernel tiles). The CUDA kernels are held against these plain versions on the card
(test_torch_gpu.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookaheaddecoding_tpu.ops import quant as jquant
from lookaheaddecoding_tpu.ops import quant_matmul as jqm
from lookaheaddecoding_tpu_torch.ops import int4_micro as im
from lookaheaddecoding_tpu_torch.ops import quant as tquant
from lookaheaddecoding_tpu_torch.ops import quant_matmul as tqm

# (2048, 5632), (2048, 2048), (5632, 2048), (2048, 32000) over 4; K/2 = 704
# packed rows are stored as 768 by both quantizers
SHAPES = [(512, 1408), (512, 512), (1408, 512), (512, 8192)]


def case(k, n, t=8, seed=0):
    rng = np.random.RandomState(seed + k + n)
    w = rng.randn(k, n).astype(np.float32) * 0.02
    x = rng.randn(t, k).astype(np.float32)
    return x, w


def test_shift_decode_equals_the_mask_xor_decode():
    """Every byte value: (p << 28) >> 28 and p >> 4 on 32-bit words give
    the planes of ``unpack_int4``."""
    q4 = torch.arange(-128, 128, dtype=torch.int8).view(16, 16)
    lo, hi = im.unpack_int4_shift(q4)
    want_lo, want_hi = tquant.unpack_int4(q4)
    assert torch.equal(lo, want_lo.int()) and torch.equal(hi, want_hi.int())
    assert lo.min() == -8 and lo.max() == 7 and hi.min() == -8


@pytest.mark.parametrize("k,n", SHAPES)
def test_shift_ref_is_bit_equal_to_int4_matmul_ref(k, n):
    x, w = case(k, n)
    wq = tquant.quantize_weight(torch.from_numpy(w), 4)
    xt = torch.from_numpy(x)
    want = tqm.int4_matmul_ref(xt, wq["q4"], wq["scale"])
    got = im.int4_matmul_shift_ref(xt, wq["q4"], wq["scale"])
    assert torch.equal(got, want)
    before = dict(im.counts)
    via = im.int4_matmul_shift(xt, wq["q4"], wq["scale"],
                               logical_k2=tquant.logical_packed_rows(wq))
    assert torch.equal(via, want)
    assert im.counts == dict(before, plain=before["plain"] + 1)


@pytest.mark.parametrize("k,n", SHAPES + [(1280, 64)])
def test_kouter_ref_within_tolerance_of_int4_matmul_ref(k, n):
    """The K-outer sum is grouped by slabs of KOUTER_SLAB packed rows
    (K = 1408 and 1280 have three), so it differs from the one-chain sum in
    the last float32 bits: rtol 1e-5, atol 1e-5 at outputs of magnitude ~1
    from up to 1408 terms. (That a row alone gives the bits of the same row
    among 8 is a property of the kernel, held on the card.)"""
    x, w = case(k, n)
    wq = tquant.quantize_weight(torch.from_numpy(w), 4)
    xt = torch.from_numpy(x)
    want = tqm.int4_matmul_ref(xt, wq["q4"], wq["scale"])
    got = im.int4_matmul_kouter(xt, wq["q4"], wq["scale"],
                                logical_k2=tquant.logical_packed_rows(wq))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    one = im.int4_matmul_kouter_ref(xt[3:4], wq["q4"], wq["scale"])
    torch.testing.assert_close(one[0], got[3], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["shift", "kouter"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_variants_match_jax_int4_matmul(variant, k, n):
    """Against the JAX package's int4 kernel (interpret mode), each package
    on the weight its own quantizer made (test_torch_quant.py holds their
    bytes equal): rtol 2e-5, atol 2e-5, the same float32 sum in another
    order."""
    x, w = case(k, n, seed=1)
    jq = jquant.quantize_weight(jnp.asarray(w), 4)
    want = jqm.int4_matmul(jnp.asarray(x), jq["q4"], jq["scale"],
                           interpret=True)
    tq = tquant.quantize_weight(torch.from_numpy(w), 4)
    np.testing.assert_array_equal(tq["q4"].numpy(), np.asarray(jq["q4"]))
    fn = im.int4_matmul_shift if variant == "shift" else im.int4_matmul_kouter
    got = fn(torch.from_numpy(x), tq["q4"], tq["scale"],
             logical_k2=tquant.logical_packed_rows(tq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_wrappers_check_their_inputs_like_int4_matmul():
    x = torch.zeros(4, 64)
    q4 = torch.zeros(32, 16, dtype=torch.int8)
    scale = torch.ones(1, 16)
    for fn in (im.int4_matmul_shift, im.int4_matmul_kouter):
        with pytest.raises(ValueError, match="packed rows"):
            fn(x, q4[:16], scale)
        with pytest.raises(ValueError, match="int8"):
            fn(x, q4.float(), scale)
        with pytest.raises(ValueError, match="scale"):
            fn(x, q4, scale[0])
        assert fn(x, q4, scale).shape == (4, 16)


def test_counts_name_each_kouter_design():
    """The K-outer variant counts its two CUDA designs apart (bfloat16 on
    the tensor cores, float32 on FMAs), so a run can show which one it
    launched; on the CPU only the plain version is counted."""
    assert set(im.counts) == {"shift", "kouter_mma", "kouter_fma", "plain"}
    x, w = case(512, 64)
    wq = tquant.quantize_weight(torch.from_numpy(w), 4)
    before = dict(im.counts)
    im.int4_matmul_kouter(torch.from_numpy(x).bfloat16(), wq["q4"],
                          wq["scale"])
    assert im.counts == dict(before, plain=before["plain"] + 1)
