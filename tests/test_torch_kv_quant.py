"""The port's quantized decode path against the JAX package's, on the CPU,
in float32, from the same numpy inputs: the int8 KV cache (write,
attention, commit), the model forward with int8, int4, fused and int8-KV
trees, and the engine end to end.

Tolerances: cache bytes and scales bit-equal; attention atol 1e-5; forward
logits atol 1e-4 / rtol 1e-4 (the same float32 math summed in another
order through two layers); engine tokens and step counts equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
from lookaheaddecoding_tpu.models import llama as jllama
from lookaheaddecoding_tpu.ops import quant as jquant
from lookaheaddecoding_tpu.ops.lookahead_attention import (
    lookahead_attention as jax_lookahead_attention)
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu_torch.core.layout import build_layout
from lookaheaddecoding_tpu_torch.models import llama as tllama
from lookaheaddecoding_tpu_torch.ops import lookahead_attention as la

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)
M = 128
META = dict(level=4, window=5, guess_size=3)
TOL = dict(atol=1e-4, rtol=1e-4)


def int8_cache(seed, hkv, m, d):
    """One layer of an int8 cache with realistic bytes and scales, as a
    numpy pair, a JAX dict and a port dict."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-127, 128, size=(hkv, m, d)).astype(np.int8)
    s = (rng.rand(hkv, m, 1).astype(np.float32) + 0.1) / 127.0
    return ({"q": jnp.asarray(q), "s": jnp.asarray(s)},
            {"q": torch.from_numpy(q.copy()), "s": torch.from_numpy(s.copy())})


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 2, 5])
@pytest.mark.parametrize("device_start", [False, True])
def test_kv_cache_write_int8_bit_equal_to_jax(start, device_start):
    """Against the jitted JAX write, which is how its engine runs it: XLA
    compiles ``amax / 127.0`` into a multiplication by float32(1/127)."""
    rng = np.random.RandomState(start)
    new = (rng.randn(3, 2, 16) * rng.rand(3, 2, 1) * 4).astype(np.float32)
    new[0, 0, :] = 0.0                                  # scale floor 1e-8
    jc = {"q": jnp.zeros((2, 8, 16), jnp.int8),
          "s": jnp.full((2, 8, 1), 1e-8, jnp.float32)}
    want = jax.jit(jllama.kv_cache_write)(jc, jnp.asarray(new),
                                          jnp.int32(start))
    tc = {"q": torch.zeros(2, 8, 16, dtype=torch.int8),
          "s": torch.full((2, 8, 1), 1e-8)}
    st = torch.tensor(start, dtype=torch.int32) if device_start else start
    out = tllama.kv_cache_write(tc, torch.from_numpy(new),
                                tllama.write_slots(st, 3, 8))
    assert out is tc                                    # written in place
    np.testing.assert_array_equal(tc["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(tc["s"].numpy(), np.asarray(want["s"]))
    deq = tc["q"][:, start:start + 3].float() * tc["s"][:, start:start + 3]
    assert (deq - torch.from_numpy(new).transpose(0, 1)).abs().max() <= \
        tc["s"].max() / 2 + 1e-6


def test_make_kv_cache_int8_equals_jax():
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    tcfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    for want, got in zip(jllama.make_kv_cache(jcfg, 32, quant="int8"),
                         tllama.make_kv_cache(tcfg, 32, "cpu", quant="int8")):
        assert set(got) == {"q", "s"}
        for key in got:
            assert got[key].numpy().dtype == np.asarray(want[key]).dtype
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    with pytest.raises(ValueError, match="unsupported kv quantization"):
        tllama.make_kv_cache(tcfg, 32, "cpu", quant="int4")


# ---------------------------------------------------------------------------
# Attention over the int8 cache
# ---------------------------------------------------------------------------

def test_attention_dense_int8_matches_attention_xla():
    rng = np.random.RandomState(5)
    q = rng.randn(9, 8, 16).astype(np.float32)
    (jk, tk), (jv, tv) = int8_cache(1, 2, 32, 16), int8_cache(2, 2, 32, 16)
    mask = np.where(rng.rand(9, 32) < 0.7, 0.0, -np.inf).astype(np.float32)
    mask[:, 0] = 0.0
    want = jllama.attention_xla(jnp.asarray(q), jk, jv, jnp.asarray(mask))
    got = tllama.attention_dense(torch.from_numpy(q), tk, tv,
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("block_k", [0, 64])          # single / multi block
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_len", [0, 37, 200])
def test_int8_cache_attention_matches_jax_kernel(kv_len, causal, block_k):
    """The plain version (what the wrapper runs on the CPU) against the JAX
    Pallas kernel's int8-KV mode in interpret mode."""
    rng = np.random.RandomState(kv_len + 7)
    s = 24 if causal else 27
    q = rng.randn(s, 8, 64).astype(np.float32)
    (jk, tk), (jv, tv) = int8_cache(3, 2, 256, 64), int8_cache(4, 2, 256, 64)
    want = jax_lookahead_attention(
        jnp.asarray(q), jk, jv, jnp.int32(kv_len), block_k=block_k,
        interpret=True, causal=causal, **META)
    la.counts.update(dict.fromkeys(la.counts, 0))
    got = la.lookahead_attention(
        torch.from_numpy(q), tk, tv, torch.tensor([kv_len], dtype=torch.int32),
        causal=causal, **META)
    assert la.counts == dict(dict.fromkeys(la.counts, 0), plain=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("bad,match", [
    (dict(v_plain=True), "both be plain or both"),
    (dict(s_dtype=torch.bfloat16), "scales must be float32"),
    (dict(s_shape=(2, 128)), "scales must be float32"),
    (dict(q_dtype=torch.float16), "dtype"),
    (dict(k_dtype=torch.float32), "dtype"),
])
def test_int8_cache_kernel_input_checks_raise(bad, match):
    q = torch.zeros(27, 8, 64, dtype=bad.get("q_dtype", torch.float32))

    def cache():
        return {"q": torch.zeros(2, 128, 64,
                                 dtype=bad.get("k_dtype", torch.int8)),
                "s": torch.ones(bad.get("s_shape", (2, 128, 1)),
                                dtype=bad.get("s_dtype", torch.float32))}
    v = torch.zeros(2, 128, 64) if bad.get("v_plain") else cache()
    with pytest.raises(ValueError, match=match):
        la._check_kernel_inputs(q, cache(), v,
                                torch.tensor([3], dtype=torch.int32))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def trees(variant, seed=0):
    """The same numpy weights as a JAX tree and, carried through
    ``params_from_numpy``, as the port's tree."""
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    tcfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    params = jlt.init_params(jcfg, jax.random.PRNGKey(seed), scale=0.5)
    if variant == "int8":
        params = jquant.quantize_params(params, 8, quantize_lm_head=True)
    elif variant == "int4":
        params = jquant.quantize_params(params, 4, quantize_lm_head=True)
    elif variant == "fused":
        params = jllama.fuse_params(params)
    elif variant == "int4_fused":
        params = jllama.fuse_params(jquant.quantize_params(params, 4))
    elif variant == "int8_fused":
        params = jquant.quantize_params(jllama.fuse_params(params), 8)
    return jcfg, params, tcfg, tlt.params_from_numpy(
        jax.device_get(params), tcfg, "cpu")


def composite_inputs(kv_len):
    lay = build_layout(tlt.LookaheadConfig(level=4, window_size=5,
                                           guess_set_size=4))
    s = lay.seq_len
    rng = np.random.RandomState(kv_len)
    tokens = rng.randint(0, ARCH["vocab_size"], size=s).astype(np.int32)
    positions = (kv_len + lay.rel_pos).astype(np.int32)
    mask = np.full((s, M), -np.inf, np.float32)
    mask[:, :kv_len] = 0.0
    mask[:, kv_len:kv_len + s] = np.where(lay.spec_mask, 0.0, -np.inf)
    rows = np.concatenate([[0], np.arange(lay.inp_start, lay.inp_stop),
                           np.arange(lay.guess_start, s)]).astype(np.int64)
    return tokens, positions, mask, rows


def filled_caches(jcfg, tcfg, kv_quant, kv_len):
    """Caches of both packages holding the same ``kv_len`` committed
    slots, written by each package's own ``kv_cache_write``."""
    rng = np.random.RandomState(kv_len + 1)
    n, hkv, d = ARCH["num_hidden_layers"], 2, 16
    new = rng.randn(2, n, max(kv_len, 1), hkv, d).astype(np.float32)
    jc = list(jllama.make_kv_cache(jcfg, M, quant=kv_quant))
    tc = tllama.make_kv_cache(tcfg, M, "cpu", quant=kv_quant)
    if kv_len:
        for which in range(2):
            layers = [jax.jit(jllama.kv_cache_write)(
                jax.tree.map(lambda a: a[li], jc[which]),
                jnp.asarray(new[which, li]), jnp.int32(0)) for li in range(n)]
            jc[which] = jax.tree.map(lambda *a: jnp.stack(a), *layers)
            for li in range(n):
                cache = tc[which]
                layer = ({k: v[li] for k, v in cache.items()}
                         if isinstance(cache, dict) else cache[li])
                tllama.kv_cache_write(layer, torch.from_numpy(new[which, li]), 0)
    return jc, tc


def assert_caches_equal(got, want, exact):
    if isinstance(got, dict):
        for key in ("q", "s"):
            g, w = got[key].numpy(), np.asarray(want[key])
            if exact:
                np.testing.assert_array_equal(g, w)
            elif key == "q":      # a value on a rounding edge may move by one
                assert np.abs(g.astype(np.int32) - w).max() <= 1
                assert (g != w).mean() < 1e-3
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant,kv_quant", [
    ("int8", None), ("int4", None), ("fused", None), ("int4_fused", None),
    ("int8_fused", None), ("plain", "int8"), ("int8", "int8")])
@pytest.mark.parametrize("kv_len", [0, 37])
def test_composite_forward_matches_jax(kv_len, variant, kv_quant):
    jcfg, jparams, tcfg, tparams = trees(variant)
    tokens, positions, mask, rows = composite_inputs(kv_len)
    jc, tc = filled_caches(jcfg, tcfg, kv_quant, kv_len)
    assert_caches_equal(tc[0], jc[0], exact=True)
    jcos, jsin = jllama.rope_tables(jcfg, M)
    tcos, tsin = tllama.rope_tables(tcfg, M, "cpu")
    jl, jk, jv = jax.jit(jllama.forward, static_argnums=(1,))(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jc[0],
        jc[1], jnp.int32(kv_len), jnp.asarray(mask), jcos, jsin,
        logits_rows=jnp.asarray(rows))
    tl, tk, tv = tllama.forward(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
        tc[0], tc[1], torch.tensor(kv_len, dtype=torch.int32), tcos, tsin,
        dict(META, kv_len=torch.tensor([kv_len], dtype=torch.int32)),
        logits_rows=torch.from_numpy(rows))
    assert tk is tc[0] and tv is tc[1]                  # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_caches_equal(tk, jk, exact=False)
    assert_caches_equal(tv, jv, exact=False)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def engines(variant, kv_quant=None, fuse=False):
    jcfg, jparams, tcfg, tparams = trees(variant)
    kw = dict(level=4, window_size=5, guess_set_size=4, pool_from_prompt=True,
              window_init="order_copy_from")
    ekw = dict(max_seq_len=256, prefill_chunk=16, dtype="float32",
               kv_quant=kv_quant, fuse_projections=fuse)
    jeng = jlt.LookaheadEngine(jcfg, jparams, jlt.LookaheadConfig(**kw),
                               jlt.EngineConfig(**ekw))
    teng = tlt.LookaheadEngine(tcfg, tparams, tlt.LookaheadConfig(**kw),
                               tlt.EngineConfig(**ekw), device="cpu")
    return jeng, teng


def prompt(seed, n=16):
    return list(np.random.RandomState(seed).randint(0, 128, size=n))


@pytest.mark.parametrize("variant,kv_quant,fuse", [
    ("int8", None, False), ("int4", None, False), ("int4", None, True),
    ("plain", "int8", False), ("int8", "int8", False)],
    ids=["int8_weights", "int4_weights", "int4_weights_fused", "int8_kv",
         "int8_weights_int8_kv"])
def test_generate_matches_jax_tokens_and_steps(variant, kv_quant, fuse):
    jeng, teng = engines(variant, kv_quant, fuse)
    if fuse:
        assert "wqkv" in teng.params["layers"]
    p = prompt(0)
    want, got = jeng.generate(p, 48), teng.generate(p, 48)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.steps == want.steps
    base = teng.generate_baseline(p, 48)
    np.testing.assert_array_equal(base.tokens, got.tokens)
    assert got.steps <= base.steps
    np.testing.assert_array_equal(jeng.generate_baseline(p, 48).tokens,
                                  base.tokens)


@pytest.mark.parametrize("variant", ["plain", "int8", "int4"])
def test_fused_equals_unfused(variant):
    _, unfused = engines(variant)
    _, fused = engines(variant, fuse=True)
    assert "w_gate_up" in fused.params["layers"]
    assert "w_gate_up" not in unfused.params["layers"]
    p = prompt(3)
    a, b = unfused.generate(p, 40), fused.generate(p, 40)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.steps == b.steps


def test_quantized_cpu_drive_through_the_ports_own_quantizer():
    """``quantize_params`` -> engine with ``device="cpu"``: token-exact
    against its own baseline, the same tokens as from the JAX-quantized
    tree (the bytes are equal), and the commit moves bytes and scales."""
    _, jq_eng = engines("int8", kv_quant="int8")
    _, _, tcfg, tparams = trees("plain")
    eng = tlt.LookaheadEngine(
        tcfg, tlt.quantize_params(tparams, bits=8, quantize_lm_head=True),
        jq_eng.lcfg, jq_eng.ecfg, device="cpu")
    p = prompt(5)
    r = eng.generate(p, 40)
    np.testing.assert_array_equal(r.tokens, eng.generate_baseline(p, 40).tokens)
    np.testing.assert_array_equal(r.tokens, jq_eng.generate(p, 40).tokens)
    assert r.steps < 40                        # some n-gram was committed
