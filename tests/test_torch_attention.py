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


def _kernel_inputs(paged, **bad):
    """Arguments of ``_check_kernel_inputs`` for the flat or the paged
    call, with one fault from ``bad``."""
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(bad.get("q", (27, 8, 64)), dtype=dtype)
    k = torch.zeros(bad.get("k", (2, 128, 64)), dtype=bad.get("kv_dtype",
                                                              dtype))
    v = k.clone()
    lanes = 2 if paged else 1
    lens = bad.get("lens", torch.zeros(lanes, dtype=torch.int32))
    if "scales" in bad:
        k, v = ({"q": k.to(torch.int8), "s": bad["scales"]} for _ in "kv")
    if bad.get("strided"):
        q = torch.zeros(q.shape[:-1] + (128,), dtype=dtype)[..., ::2]
    if bad.get("meta"):
        lens = lens.to("meta")
    if not paged:
        return (q, k, v, lens), {}
    q = q[None].expand(2, *q.shape) if bad.get("strided") or q.dim() != 3 \
        else torch.stack([q, q])
    tables = bad.get("tables", torch.zeros(2, 4, dtype=torch.int32))
    return (q, k, v, lens, tables), {"page_size": bad.get("page_size", 32)}


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
@pytest.mark.parametrize("bad,message", [
    (dict(q=(8, 64)), "need q "),
    (dict(q=(27, 8, 32), k=(2, 128, 32)), "kernel takes head_dim in (64, 128), got 32"),
    (dict(q=(27, 5, 64)), "head dims 64/64 or heads 5/2 mismatch"),
    (dict(dtype=torch.float16), "kernel takes float32 or bfloat16 q with k/v of the same dtype"),
    (dict(kv_dtype=torch.float64), "kernel takes float32 or bfloat16 q with k/v of the same dtype"),
    (dict(scales=torch.ones(2, 128)), "int8 cache scales must be float32 [2, 128, 1]"),
    (dict(lens=torch.zeros(5, dtype=torch.int32)), "kv_len must be an int32 tensor of"),
    (dict(lens=torch.zeros(2, dtype=torch.int64)), "kv_len must be an int32 tensor of"),
    (dict(strided=True), "kernel takes contiguous q, k, v, scales, kv_len and tables"),
    (dict(meta=True), "q, k, v, scales, kv_len and tables must be on one device"),
])
def test_flat_and_paged_wrappers_refuse_with_one_message(paged, bad, message):
    """The two wrappers share their input checks: the same fault (shape,
    head_dim, heads, dtype, scales, kv_len, contiguity, device) raises the
    same message from both."""
    args, kw = _kernel_inputs(paged, **bad)
    with pytest.raises(ValueError) as err:
        la._check_kernel_inputs(*args, **kw)
    assert message in str(err.value)


def test_wrong_current_device_is_refused_by_both(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    for paged in (False, True):
        args, kw = _kernel_inputs(paged)
        with pytest.raises(ValueError, match="current CUDA device is 1"):
            la._check_kernel_inputs(*args, **kw)


@pytest.mark.parametrize("bad,match", [
    (dict(tables=torch.zeros(2, 4, dtype=torch.int64)), "tables must be int32"),
    (dict(tables=torch.zeros(3, 4, dtype=torch.int32)), "tables must be int32"),
    (dict(page_size=48), "not whole pages of 48"),
])
def test_paged_only_checks_raise(bad, match):
    args, kw = _kernel_inputs(True, **bad)
    with pytest.raises(ValueError, match=match):
        la._check_kernel_inputs(*args, **kw)
