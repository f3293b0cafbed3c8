"""The port's composite attention against the JAX package's Pallas kernel,
run in interpret mode on the CPU (as test_lookahead_attention.py runs it).

On the CPU the port's wrapper runs the plain version; the CUDA kernel is
held against that plain version on the card by test_torch_gpu.py and by
chip_smoke.py. Tolerance f32 atol 2e-5 / rtol 2e-4, as the JAX kernel's
own tests: the same math in another summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookaheaddecoding_tpu.models.llama import attention_xla
from lookaheaddecoding_tpu.ops.lookahead_attention import (
    lookahead_attention as jax_lookahead_attention)
from lookaheaddecoding_tpu_torch.models.llama import attention_dense
from lookaheaddecoding_tpu_torch.ops import lookahead_attention as la

TOL = dict(atol=2e-5, rtol=2e-4)
GEO = dict(level=4, window=5, guess_size=3)
S_COMPOSITE = 27          # (4-1)*5 + 4*3


def inputs(seed, s, hq, hkv, m, d=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(s, hq, d).astype(np.float32),
            rng.randn(hkv, m, d).astype(np.float32),
            rng.randn(hkv, m, d).astype(np.float32))


def both(q, k, v, kv_len, block_k=0, **kw):
    want = jax_lookahead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(kv_len),
        block_k=block_k, interpret=True, **GEO, **kw)
    la.counts.update(kernel=0, plain=0)
    got = la.lookahead_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor([kv_len], dtype=torch.int32), **GEO, **kw)
    assert la.counts == {"kernel": 0, "plain": 1}
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("block_k", [0, 64])          # single / multi block
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("kv_len", [0, 1, 37, 200])
def test_composite_matches_jax_kernel(kv_len, rep, block_k):
    q, k, v = inputs(kv_len * 10 + rep, S_COMPOSITE, 2 * rep, 2, 256)
    got, want = both(q, k, v, kv_len, block_k=block_k)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("block_k", [0, 64])
@pytest.mark.parametrize("kv_len", [0, 1, 37, 200])
def test_causal_matches_jax_kernel(kv_len, block_k):
    q, k, v = inputs(kv_len + 3, 24, 8, 2, 256)
    got, want = both(q, k, v, kv_len, block_k=block_k, causal=True)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sw", [16, 100])
@pytest.mark.parametrize("kv_len", [0, 37, 200])
def test_sliding_window_matches_jax_kernel(kv_len, sw, causal):
    q, k, v = inputs(kv_len + sw, 24 if causal else S_COMPOSITE, 8, 2, 256)
    got, want = both(q, k, v, kv_len, block_k=64, causal=causal,
                     sliding_window=sw)
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_dense_matches_attention_xla():
    q, k, v = inputs(5, 9, 8, 2, 32, d=16)
    rng = np.random.RandomState(1)
    mask = np.where(rng.rand(9, 32) < 0.7, 0.0, -np.inf).astype(np.float32)
    mask[:, 0] = 0.0
    want = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(mask))
    got = attention_dense(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bad,match", [
    (dict(q=(27, 8, 32), k=(2, 128, 32)), "head_dim"),
    (dict(q=(27, 5, 64)), "heads"),
    (dict(k=(2, 128, 32)), "mismatch"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(kv_len=torch.tensor([3])), "int32"),
])
def test_kernel_input_checks_raise(bad, match):
    """What the CUDA kernel does not take is refused before launching."""
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(bad.get("q", (27, 8, 64)), dtype=dtype)
    k = torch.zeros(bad.get("k", (2, 128, 64)), dtype=dtype)
    kv_len = bad.get("kv_len", torch.tensor([3], dtype=torch.int32))
    with pytest.raises(ValueError, match=match):
        la._check_kernel_inputs(q, k, k.clone(), kv_len)
