"""The plain versions of the port's quantized matrix products against the
JAX package's Pallas kernels in interpret mode, on the CPU, in float32.

On the CPU the port's wrappers run these plain versions; the CUDA kernels
are held against them on the card by test_torch_gpu.py and chip_smoke.py.
Tolerance rtol 2e-4 / atol 2e-4, as the JAX kernels' own tests: the same
float32 sum in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookaheaddecoding_tpu.ops import quant as jquant
from lookaheaddecoding_tpu.ops import quant_matmul as jqm
from lookaheaddecoding_tpu_torch.ops import quant as tquant
from lookaheaddecoding_tpu_torch.ops import quant_matmul as tqm

TOL = dict(rtol=2e-4, atol=2e-4)


def case(t, k, n, bits, seed=None):
    rng = np.random.RandomState(t if seed is None else seed)
    x = rng.randn(t, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32) * 0.2
    wq = jquant.quantize_weight(jnp.asarray(w), bits)
    tq = {key: torch.from_numpy(np.asarray(v).copy()) for key, v in wq.items()}
    return x, wq, tq


def reset_counts():
    tqm.counts.update(dict.fromkeys(tqm.counts, 0))


@pytest.mark.parametrize("t,k,n", [(1, 512, 256), (17, 512, 512),
                                   (56, 1024, 256)])
def test_int8_matmul_matches_jax_kernel(t, k, n):
    x, wq, tq = case(t, k, n, 8)
    want = jqm.int8_matmul(jnp.asarray(x), wq["q"], wq["scale"],
                           interpret=True)
    reset_counts()
    got = tqm.int8_matmul(torch.from_numpy(x), tq["q"], tq["scale"])
    assert tqm.counts == dict(dict.fromkeys(tqm.counts, 0), plain=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        got.numpy(),
        tqm.int8_matmul_ref(torch.from_numpy(x), tq["q"], tq["scale"]).numpy())


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("t,k,n", [(1, 512, 256), (17, 512, 512),
                                   (240, 1024, 256)])
def test_int4_matmul_matches_jax_kernel(t, k, n, pipeline):
    x, wq, tq = case(t, k, n, 4)
    want = jqm.int4_matmul(jnp.asarray(x), wq["q4"], wq["scale"],
                           pipeline=pipeline, interpret=True)
    reset_counts()
    got = tqm.int4_matmul(torch.from_numpy(x), tq["q4"], tq["scale"],
                          pipeline=pipeline,
                          logical_k2=tquant.logical_packed_rows(tq))
    assert tqm.counts["plain"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(),
        (torch.from_numpy(x) @ tquant.dequantize_weight(tq, torch.float32))
        .numpy(), **TOL)


@pytest.mark.parametrize("pipeline", [False, True])
def test_int4_matmul_padded_rows_matches_jax_kernel(pipeline):
    """K=5888 packs to 2944 = 128 * 23 rows, stored as 3072: the zero rows
    are accepted and x is not padded."""
    x, wq, tq = case(9, 5888, 256, 4, seed=11)
    assert tq["q4"].shape == (3072, 256)
    want = jqm.int4_matmul(jnp.asarray(x), wq["q4"], wq["scale"],
                           pipeline=pipeline, interpret=True)
    got = tqm.int4_matmul(torch.from_numpy(x), tq["q4"], tq["scale"],
                          pipeline=pipeline, logical_k2=2944)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tquant.qmatmul(torch.from_numpy(x), tq).numpy(),
        np.asarray(jquant.qmatmul(jnp.asarray(x), wq)), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_stacked_weight_indexed_by_layer(bits):
    """A stacked [L, K, N] weight pads on axis -2 and is multiplied one
    layer at a time, each layer a contiguous view."""
    rng = np.random.RandomState(5)
    k, n = 5888, 128
    w = rng.randn(2, k, n).astype(np.float32) * 0.2
    x = rng.randn(3, k).astype(np.float32)
    wq = jquant.quantize_weight(jnp.asarray(w), bits)
    tq = tquant.quantize_weight(torch.from_numpy(w), bits)
    for li in range(2):
        layer = {key: leaf[li] for key, leaf in tq.items()}
        assert all(leaf.is_contiguous() for leaf in layer.values())
        want = jquant.qmatmul(jnp.asarray(x),
                              {key: leaf[li] for key, leaf in wq.items()})
        np.testing.assert_allclose(
            tquant.qmatmul(torch.from_numpy(x), layer).numpy(),
            np.asarray(want), **TOL)


def test_bfloat16_output_dtype_and_value():
    x, wq, tq = case(5, 512, 64, 8)
    xb = torch.from_numpy(x).bfloat16()
    got = tqm.int8_matmul(xb, tq["q"], tq["scale"])
    assert got.dtype == torch.bfloat16
    want = ((xb.float() @ tq["q"].float()) * tq["scale"]).bfloat16()
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())
    got4 = tqm.int4_matmul(xb, *(case(5, 512, 64, 4)[2][k]
                                 for k in ("q4", "scale")))
    assert got4.dtype == torch.bfloat16


@pytest.mark.parametrize("logical_k2,stored,match", [
    (384, 384, "packed for K=768"),     # packed for a larger K
    (None, 384, "do not match"),        # padded rows without their count
    (256, 200, "packed for K=512"),     # fewer stored rows than the count
])
def test_int4_wrong_k_raises(logical_k2, stored, match):
    """A q4 packed for another K is refused, not multiplied against the
    wrong halves of x (the JAX package's int4_matmul_supported rule)."""
    x = torch.zeros(4, 512)
    q4 = torch.zeros(stored, 256, dtype=torch.int8)
    scale = torch.ones(1, 256)
    assert not jqm.int4_matmul_supported(512, (stored, 256),
                                         logical_k2=logical_k2)
    with pytest.raises(ValueError, match=match):
        tqm.int4_matmul(x, q4, scale, logical_k2=logical_k2)
    ok = tqm.int4_matmul(x, torch.zeros(384, 256, dtype=torch.int8), scale,
                         logical_k2=256)            # padded for this K
    assert ok.shape == (4, 256)


@pytest.mark.parametrize("bad,match", [
    (dict(x=torch.zeros(4, 512, dtype=torch.float16)), "float32 or bfloat16"),
    (dict(x=torch.zeros(2, 4, 512)), r"x \[T, K\]"),
    (dict(w=torch.zeros(512, 256)), "must be int8"),
    (dict(scale=torch.ones(256)), "scale must be float32"),
    (dict(scale=torch.ones(1, 256, dtype=torch.bfloat16)), "scale must be"),
    (dict(x=torch.zeros(4, 256)), "packed for K=512"),
])
def test_input_checks_raise(bad, match):
    args = dict(x=torch.zeros(4, 512), w=torch.zeros(512, 256, dtype=torch.int8),
                scale=torch.ones(1, 256))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        tqm.int8_matmul(args["x"], args["w"], args["scale"])
    if "x" not in bad:
        with pytest.raises(ValueError, match=match):
            tqm.int4_matmul(torch.zeros(4, 1024), args["w"], args["scale"])
    with pytest.raises(ValueError, match="even"):
        tqm.int4_matmul(torch.zeros(4, 511),
                        torch.zeros(255, 256, dtype=torch.int8),
                        torch.ones(1, 256))


@pytest.mark.parametrize("bad,match", [
    (dict(n=24), "multiple of 16"),
    (dict(transpose=True), "contiguous"),
])
def test_kernel_only_checks_raise_before_any_launch(bad, match):
    """What only the CUDA kernels refuse (a row that is not a whole number
    of 16-byte pieces, a strided weight) raises ahead of the launch."""
    n = bad.get("n", 32)
    x = torch.zeros(4, 64)
    w = torch.zeros(64, n, dtype=torch.int8)
    if bad.get("transpose"):
        w = torch.zeros(n, 64, dtype=torch.int8).T
    reset_counts()
    with pytest.raises(ValueError, match=match):
        tqm._launch("int8", x, w, torch.ones(1, n), 0)
    assert tqm.counts["int8_fma"] == 0


@pytest.mark.parametrize("mode,dtype,key", [
    ("int8", torch.bfloat16, "int8_mma"), ("int8", torch.float32, "int8_fma"),
    ("int4", torch.bfloat16, "int4_mma"), ("int4", torch.float32, "int4_fma"),
    ("int4_pipe", torch.bfloat16, "int4_pipe_mma"),
    ("int4_pipe", torch.float32, "int4_pipe_fma"),
])
def test_count_key_tells_the_two_int4_designs_apart(mode, dtype, key):
    """bfloat16 launches of every product count as the tensor-core
    kernels', float32 ones as the FMA kernels'; every key is one of
    ``counts``."""
    assert tqm.count_key(mode, dtype) == key
    assert key in tqm.counts
