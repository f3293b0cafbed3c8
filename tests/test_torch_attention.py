"""The port's composite attention against the JAX package's Pallas kernel,
run in interpret mode on the CPU (as test_lookahead_attention.py runs it).

On the CPU the port's wrapper runs the plain version; the CUDA kernel is
held against that plain version on the card by test_torch_gpu.py and by
chip_smoke.py. Tolerance f32 atol 2e-5 / rtol 2e-4, as the JAX kernel's
own tests: the same math in another summation order. Head dims 32, 64,
80, 96, 128 and 256, flat and paged, plain and int8 KV."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookaheaddecoding_tpu.models.llama import attention_xla
from lookaheaddecoding_tpu.ops.lookahead_attention import (
    lookahead_attention as jax_lookahead_attention,
    paged_lookahead_attention as jax_paged_attention)
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
    la.counts.update(dict.fromkeys(la.counts, 0))
    got = la.lookahead_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor([kv_len], dtype=torch.int32), **GEO, **kw)
    assert la.counts == dict(dict.fromkeys(la.counts, 0), plain=1)
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
    (dict(q=(27, 8, 40), k=(2, 128, 40)), "head_dim"),
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
    (dict(q=(27, 8, 40), k=(2, 128, 40)), "kernel takes head_dim in (32, 48, 64, 80, 96, 112, 128, 256), got 40"),
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


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "mma"),
                                        (torch.float32, "fma")])
def test_kernel_design_follows_q_dtype(dtype, name):
    """bfloat16 q runs the tensor-core design, float32 q the FMA design;
    both wrappers count each launch under its design and in all."""
    assert la.design(dtype) == name
    for tally in (la.counts, la.paged_counts):
        assert set(tally) == {"kernel", "mma", "fma", "plain"}


# --------------------------------------------------------------------------
# head_dim 256 (Gemma's): 8 query heads on one KV head, as Gemma-2B
# --------------------------------------------------------------------------

def int8_rows(x):
    """x [Hkv, M, D] quantized a row as the int8 cache stores it."""
    s = np.maximum(np.abs(x).max(axis=-1, keepdims=True) / 127.0,
                   1e-8).astype(np.float32)
    return {"q": np.clip(np.round(x / s), -127, 127).astype(np.int8), "s": s}


def as_jax(tree):
    if isinstance(tree, dict):
        return {n: jnp.asarray(a) for n, a in tree.items()}
    return jnp.asarray(tree)


def as_torch(tree):
    if isinstance(tree, dict):
        return {n: torch.from_numpy(a) for n, a in tree.items()}
    return torch.from_numpy(tree)


@pytest.mark.parametrize("m,kv_len,causal,sw,int8_kv", [
    (256, 37, False, 0, False),      # composite, the whole cache one block
    (1024, 700, False, 0, False),    # composite, M <= 1024
    (2048, 1500, False, 0, False),   # composite, M > 1024: online softmax
    (256, 100, True, 0, False),      # causal prefill
    (2048, 1200, True, 0, False),
    (256, 37, False, 0, True),       # int8 KV
    (2048, 1500, False, 0, True),
    (256, 120, False, 48, False),    # sliding window, composite and causal
    (256, 120, True, 48, True),
], ids=lambda v: str(v))
def test_head_dim_256_matches_jax_kernel(m, kv_len, causal, sw, int8_kv):
    """The port's kernel path at head_dim 256 (its plain version on the
    CPU) against JAX's Pallas kernel in interpret mode: the composite mask
    at M <= 1024 and M > 1024, causal prefill, an int8 cache and a sliding
    window. Tolerance TOL."""
    s = 24 if causal else S_COMPOSITE
    q, k, v = inputs(m + kv_len + sw, s, 8, 1, m, d=256)
    if int8_kv:
        k, v = int8_rows(k), int8_rows(v)
    kw = dict(GEO, causal=causal, sliding_window=sw)
    want = jax_lookahead_attention(jnp.asarray(q), as_jax(k), as_jax(v),
                                   jnp.int32(kv_len), interpret=True, **kw)
    before = dict(la.counts)
    got = la.lookahead_attention(torch.from_numpy(q), as_torch(k),
                                 as_torch(v),
                                 torch.tensor([kv_len], dtype=torch.int32),
                                 **kw)
    assert la.counts == dict(before, plain=before["plain"] + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,sw,int8_kv", [
    (False, 0, False), (True, 0, False), (False, 40, False), (False, 0, True),
    (True, 40, True)])
def test_head_dim_256_paged_matches_jax_kernel(causal, sw, int8_kv):
    """The paged call at head_dim 256: two lanes of different kv_len on
    shuffled pages of 128 (the JAX kernel's tiling rule), the port's plain
    version against JAX's paged Pallas kernel in interpret mode. Tolerance
    TOL."""
    rng = np.random.RandomState(11 + sw + int8_kv)
    lanes, page, nb, hkv, d = 2, 128, 3, 1, 256
    s = 24 if causal else S_COMPOSITE
    q = rng.randn(lanes, s, 8, d).astype(np.float32)
    n_pages = lanes * nb + 1
    tables = rng.permutation(n_pages)[:lanes * nb].reshape(lanes, nb)
    tables = tables.astype(np.int32)
    k = rng.randn(hkv, n_pages * page, d).astype(np.float32)
    v = rng.randn(hkv, n_pages * page, d).astype(np.float32)
    if int8_kv:
        k, v = int8_rows(k), int8_rows(v)
    kv_lens = np.array([37, page * nb - s], np.int32)
    kw = dict(GEO, page_size=page, causal=causal, sliding_window=sw)
    want = jax_paged_attention(jnp.asarray(q), as_jax(k), as_jax(v),
                               jnp.asarray(kv_lens), jnp.asarray(tables),
                               interpret=True, **kw)
    before = dict(la.paged_counts)
    got = la.paged_lookahead_attention(
        torch.from_numpy(q), as_torch(k), as_torch(v),
        torch.from_numpy(kv_lens), torch.from_numpy(tables), **kw)
    assert la.paged_counts == dict(before, plain=before["plain"] + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
@pytest.mark.parametrize("d", [32, 48, 64, 80, 96, 112, 128, 256])
def test_kernel_input_checks_take_every_kernel_head_dim(monkeypatch, paged,
                                                       d):
    """head_dim 32, 48, 64, 80, 96, 112, 128 and 256 pass the kernel's input
    checks, flat and paged, plain and int8 cache; 40 and 100 still raise
    with the one message. (CPU tensors stand in for the card's: the current
    device is made theirs.)"""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    for int8_kv in (False, True):
        bad = dict(q=(27, 8, d), k=(2, 128, d))
        if int8_kv:
            bad["scales"] = torch.ones(2, 128, 1)
        args, kw = _kernel_inputs(paged, **bad)
        if paged:
            args = (args[0].contiguous(),) + args[1:]
        la._check_kernel_inputs(*args, **kw)
    for other in (40, 100):
        args, kw = _kernel_inputs(paged, q=(27, 8, other), k=(2, 128, other))
        with pytest.raises(ValueError) as err:
            la._check_kernel_inputs(*args, **kw)
        assert (f"kernel takes head_dim in (32, 48, 64, 80, 96, 112, 128, "
                f"256), got {other}" in str(err.value))


# --------------------------------------------------------------------------
# head_dim 32, 48, 80, 96 and 112: multiples of 16 that are not all powers
# of two
# --------------------------------------------------------------------------

# (Hq, Hkv) at each head_dim: Hq * D near 2048, as chip_smoke.py times them
SMALL_HEADS = {32: (64, 8), 80: (32, 8), 96: (32, 8)}
# head_dim 48 and 112, with GQA factors 5 and 3
MORE_HEADS = {48: (40, 8), 112: (24, 8)}

FLAT_CASES = [
    (256, 37, False, 0, False),      # composite, the whole cache one block
    (2048, 1500, False, 0, False),   # composite, M > 1024: online softmax
    (256, 100, True, 0, False),      # causal prefill
    (256, 37, False, 0, True),       # int8 KV
    (256, 120, False, 48, False),    # sliding window, composite and causal
    (256, 120, True, 48, True),
]
PAGED_CASES = [(False, 0, False), (True, 0, False), (False, 40, False),
               (False, 0, True), (True, 40, True)]


@pytest.mark.parametrize("d", sorted(SMALL_HEADS))
@pytest.mark.parametrize("m,kv_len,causal,sw,int8_kv", FLAT_CASES,
                         ids=lambda v: str(v))
def test_head_dims_32_80_96_match_jax_kernel(m, kv_len, causal, sw, int8_kv,
                                            d):
    """The port's kernel path at head_dim 32, 80 and 96 (its plain version
    on the CPU) against JAX's Pallas kernel in interpret mode: composite
    at M <= 1024 and M > 1024, causal prefill, an int8 cache and a sliding
    window. Tolerance TOL."""
    _flat_matches_jax(m, kv_len, causal, sw, int8_kv, d, *SMALL_HEADS[d])


@pytest.mark.parametrize("d", sorted(MORE_HEADS))
@pytest.mark.parametrize("m,kv_len,causal,sw,int8_kv", FLAT_CASES,
                         ids=lambda v: str(v))
def test_head_dims_48_112_match_jax_kernel(m, kv_len, causal, sw, int8_kv,
                                          d):
    """The port's kernel path at head_dim 48 and 112 (its plain version on
    the CPU) against JAX's Pallas kernel in interpret mode, on the cases of
    head_dim 32, 80 and 96. Tolerance TOL."""
    _flat_matches_jax(m, kv_len, causal, sw, int8_kv, d, *MORE_HEADS[d])


def _flat_matches_jax(m, kv_len, causal, sw, int8_kv, d, hq, hkv):
    s = 24 if causal else S_COMPOSITE
    q, k, v = inputs(d + m + kv_len + sw, s, hq, hkv, m, d=d)
    if int8_kv:
        k, v = int8_rows(k), int8_rows(v)
    kw = dict(GEO, causal=causal, sliding_window=sw)
    want = jax_lookahead_attention(jnp.asarray(q), as_jax(k), as_jax(v),
                                   jnp.int32(kv_len), interpret=True, **kw)
    before = dict(la.counts)
    got = la.lookahead_attention(torch.from_numpy(q), as_torch(k),
                                 as_torch(v),
                                 torch.tensor([kv_len], dtype=torch.int32),
                                 **kw)
    assert la.counts == dict(before, plain=before["plain"] + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", sorted(SMALL_HEADS))
@pytest.mark.parametrize("causal,sw,int8_kv", PAGED_CASES)
def test_head_dims_32_80_96_paged_match_jax_kernel(causal, sw, int8_kv, d):
    """The paged call at head_dim 32, 80 and 96: two lanes of different
    kv_len on shuffled pages of 128, against JAX's paged Pallas kernel in
    interpret mode (TOL), and each lane equal to the flat call on its
    gathered cache."""
    _paged_matches_jax(causal, sw, int8_kv, d, *SMALL_HEADS[d])


@pytest.mark.parametrize("d", sorted(MORE_HEADS))
@pytest.mark.parametrize("causal,sw,int8_kv", PAGED_CASES)
def test_head_dims_48_112_paged_match_jax_kernel(causal, sw, int8_kv, d):
    """The paged call at head_dim 48 and 112, as at 32, 80 and 96: against
    JAX's paged Pallas kernel in interpret mode (TOL), each lane equal to
    the flat call on its gathered cache."""
    _paged_matches_jax(causal, sw, int8_kv, d, *MORE_HEADS[d])


def _paged_matches_jax(causal, sw, int8_kv, d, hq, hkv):
    from lookaheaddecoding_tpu_torch.core.paged import paged_gather
    rng = np.random.RandomState(d + sw + int8_kv)
    lanes, page, nb = 2, 128, 3
    s = 24 if causal else S_COMPOSITE
    q = rng.randn(lanes, s, hq, d).astype(np.float32)
    n_pages = lanes * nb + 1
    tables = rng.permutation(n_pages)[:lanes * nb].reshape(lanes, nb)
    tables = tables.astype(np.int32)
    k = rng.randn(hkv, n_pages * page, d).astype(np.float32)
    v = rng.randn(hkv, n_pages * page, d).astype(np.float32)
    if int8_kv:
        k, v = int8_rows(k), int8_rows(v)
    kv_lens = np.array([37, page * nb - s], np.int32)
    kw = dict(GEO, page_size=page, causal=causal, sliding_window=sw)
    want = jax_paged_attention(jnp.asarray(q), as_jax(k), as_jax(v),
                               jnp.asarray(kv_lens), jnp.asarray(tables),
                               interpret=True, **kw)
    tk, tv, tt = as_torch(k), as_torch(v), torch.from_numpy(tables)
    got = la.paged_lookahead_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(kv_lens), tt, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kg, vg = (paged_gather(c, tt, page) for c in (tk, tv))
    for b in range(lanes):
        def lane(tree):
            if isinstance(tree, dict):
                return {n: a[b] for n, a in tree.items()}
            return tree[b]
        flat = la.lookahead_attention(
            torch.from_numpy(q[b]), lane(kg), lane(vg),
            torch.from_numpy(kv_lens[b:b + 1]), **GEO, causal=causal,
            sliding_window=sw)
        assert torch.equal(flat, got[b]), b


ENGINE_ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=512,
                   dtype=torch.float32)


@pytest.mark.parametrize("engine", ["flat", "paged"])
@pytest.mark.parametrize("d", [32, 40, 48, 80, 96, 100, 112])
def test_engines_take_the_kernel_head_dims_on_the_card(monkeypatch, engine,
                                                       d):
    """The engines' guard without a card (CUDA made to look available):
    head_dim 32, 48, 80, 96 and 112 pass it, and the engine goes on to its
    first device allocation, which a CPU-only torch refuses; 40 and 100
    still raise the head_dim ValueError (unless attention_impl="dense")."""
    import lookaheaddecoding_tpu_torch as tlt
    cfg = tlt.LlamaConfig(**ENGINE_ARCH, head_dim_override=d)
    params = tlt.init_params(cfg, seed=0, device="cpu")
    cls = tlt.LookaheadEngine if engine == "flat" else tlt.PagedServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    lc = tlt.LookaheadConfig(level=4, window_size=5, guess_set_size=4)
    ec = tlt.EngineConfig(max_seq_len=256, prefill_chunk=16)
    if d in la.KERNEL_HEAD_DIMS:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            cls(cfg, params, lc, ec)
    else:
        with pytest.raises(ValueError, match=f"head_dim .*got {d}"):
            cls(cfg, params, lc, ec)
