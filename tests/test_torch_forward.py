"""The port's model forward against the JAX package's, in float32 on the
CPU, from the same numpy weights and caches.

Tolerance atol 1e-4 / rtol 1e-4 on logits and caches: the same float32
math, summed in another order by another matmul library, through two
layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
from lookaheaddecoding_tpu.models import llama as jllama
from lookaheaddecoding_tpu_torch.core.layout import build_layout
from lookaheaddecoding_tpu_torch.config import LookaheadConfig
from lookaheaddecoding_tpu_torch.models import llama as tllama

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)
M = 128
META = dict(level=4, window=5, guess_size=3)   # the composite's geometry


def models(**extra):
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32, **extra)
    tcfg = tllama.LlamaConfig(**ARCH, dtype=torch.float32, **extra)
    params = jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                            scale=0.1))
    return jcfg, params, tcfg, tllama.params_from_numpy(params, tcfg, "cpu")


def caches(seed):
    rng = np.random.RandomState(seed)
    shape = (ARCH["num_hidden_layers"], ARCH["num_key_value_heads"], M,
             ARCH["hidden_size"] // ARCH["num_attention_heads"])
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def run_both(jcfg, jparams, tcfg, tparams, tokens, positions, start, mask,
             rows, t_meta, t_impl="dense", j_impl="xla", j_meta=None):
    """JAX's forward under the additive ``mask`` (or ``j_meta``) against
    the port's under the visibility ``t_meta`` describes."""
    kc, vc = caches(start)
    jcos, jsin = jllama.rope_tables(jcfg, M)
    tcos, tsin = tllama.rope_tables(tcfg, M, "cpu")
    np.testing.assert_array_equal(tcos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(tsin.numpy(), np.asarray(jsin))
    jl, jk, jv = jllama.forward(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(kc), jnp.asarray(vc), jnp.int32(start),
        None if mask is None else jnp.asarray(mask), jcos, jsin,
        logits_rows=None if rows is None else jnp.asarray(rows),
        attn_impl=j_impl, attn_meta=j_meta)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tl, tk2, tv2 = tllama.forward(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
        tk, tv, torch.tensor(start, dtype=torch.int32), tcos, tsin,
        dict(t_meta, kv_len=torch.tensor([start], dtype=torch.int32)),
        logits_rows=None if rows is None else torch.from_numpy(rows),
        attn_impl=t_impl)
    assert tk2 is tk and tv2 is tv            # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def composite_inputs(kv_len):
    lay = build_layout(LookaheadConfig(level=4, window_size=5,
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


@pytest.mark.parametrize("extra", [{}, dict(rope_scaling=("linear", 2.0)),
                                   dict(attention_bias=True),
                                   dict(tie_word_embeddings=True)])
@pytest.mark.parametrize("kv_len", [0, 37])
def test_composite_forward_matches_jax(kv_len, extra):
    jcfg, jparams, tcfg, tparams = models(**extra)
    tokens, positions, mask, rows = composite_inputs(kv_len)
    run_both(jcfg, jparams, tcfg, tparams, tokens, positions, kv_len, mask,
             rows, META)


def test_composite_forward_kernel_path_matches_jax_pallas():
    """The port's kernel path (the plain version on the CPU) against the
    JAX Pallas path in interpret mode."""
    jcfg, jparams, tcfg, tparams = models()
    kv_len = 37
    tokens, positions, _, rows = composite_inputs(kv_len)
    run_both(jcfg, jparams, tcfg, tparams, tokens, positions, kv_len, None,
             rows, META, t_impl="kernel", j_impl="pallas",
             j_meta=dict(META, kv_len=jnp.int32(kv_len), interpret=True))


@pytest.mark.parametrize("start", [0, 20])
def test_prefill_forward_matches_jax(start):
    jcfg, jparams, tcfg, tparams = models()
    c = 16
    tokens = np.random.RandomState(start).randint(
        0, ARCH["vocab_size"], size=c).astype(np.int32)
    positions = (start + np.arange(c)).astype(np.int32)
    cols = np.arange(M)
    mask = np.where(cols[None, :] <= positions[:, None], 0.0,
                    -np.inf).astype(np.float32)
    run_both(jcfg, jparams, tcfg, tparams, tokens, positions, start, mask,
             None, dict(META, causal=True))


def test_building_blocks_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(
        tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, 1.0),
        np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, 1.0)),
        **TOL)
    xr = rng.randn(5, 3, 16).astype(np.float32)
    cos, sin = rng.randn(5, 16).astype(np.float32), rng.randn(5, 16).astype(
        np.float32)
    np.testing.assert_allclose(
        tllama.apply_rope(*(torch.from_numpy(a) for a in (xr, cos, sin))),
        np.asarray(jllama.apply_rope(*(jnp.asarray(a) for a in (xr, cos, sin)))),
        **TOL)


def test_params_from_numpy_copies_bf16_bits():
    """bf16 leaves (ml_dtypes arrays from jax.device_get) carry over bit for
    bit, in the [in, out] orientation."""
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.bfloat16)
    params = jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(1)))
    tp = tllama.params_from_numpy(
        params, tllama.LlamaConfig(**ARCH, dtype=torch.bfloat16), "cpu")
    got = tp["layers"]["wq"].view(torch.int16).numpy()
    np.testing.assert_array_equal(got, params["layers"]["wq"].view(np.int16))
    assert tp["lm_head"].shape == (64, 128)


def test_kv_cache_write_clamps_like_dynamic_update_slice():
    cache = torch.zeros(2, 10, 4)
    new = torch.arange(24, dtype=torch.float32).view(3, 2, 4)
    slots = tllama.write_slots(torch.tensor(9, dtype=torch.int32), 3, 10)
    tllama.kv_cache_write(cache, new, slots)
    want = jax.lax.dynamic_update_slice(
        jnp.zeros((2, 10, 4)), jnp.asarray(new.numpy()).transpose(1, 0, 2),
        (0, 9, 0))
    np.testing.assert_array_equal(cache.numpy(), np.asarray(want))
