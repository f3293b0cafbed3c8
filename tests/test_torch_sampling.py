"""The port's sampling functions (``lookaheaddecoding_tpu_torch/ops/
sampling.py``) against the JAX package's on the CPU, and the statistical
tests of ``tests/test_sampling.py`` on the port.

The warpers must give JAX's support and values within 1e-6. The
verification is fed JAX's own noise (its uniforms and the Gumbel vectors
``jax.random.categorical`` draws from) and must give JAX's hits, max_hit
and winner exactly. The statistical tests hold the port's sampled
distributions against the model's within the TV bounds of the JAX tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu.ops.sampling import (
    rejection_sample_verify as jax_verify, warp_logits as jax_warp)
from lookaheaddecoding_tpu_torch.core.pool import pool_lookup
from lookaheaddecoding_tpu_torch.models import llama as tllama
from lookaheaddecoding_tpu_torch.ops import sampling as ts
from lookaheaddecoding_tpu_torch.ops.philox import seed_key

GRID = [(1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.8),
        (0.9, 7, 0.85)]


def _cum_before(logits, temp, top_k):
    """JAX's cumulative probability before each token in descending order,
    for finding entries that sit within rounding of a top_p threshold."""
    x = np.asarray(jax_warp(jnp.asarray(logits), jnp.float32(temp), top_k,
                            jnp.float32(1.0)))
    order = np.argsort(-x, axis=-1, kind="stable")
    sx = np.take_along_axis(x, order, -1)
    p = np.exp(sx - sx[..., :1])
    p /= p.sum(-1, keepdims=True)
    return np.cumsum(p, -1) - p


@pytest.mark.parametrize("temp,top_k,top_p", GRID)
def test_warp_logits_matches_jax(temp, top_k, top_p):
    logits = np.random.RandomState(0).randn(3, 50).astype(np.float32) * 3
    want = np.asarray(jax_warp(jnp.asarray(logits), jnp.float32(temp), top_k,
                               jnp.float32(top_p)))
    got = ts.warp_logits(torch.from_numpy(logits), temp, top_k,
                         top_p).numpy()
    if top_p < 1.0:
        assert np.all(np.abs(_cum_before(logits, temp, top_k) - top_p) > 1e-6)
    else:       # the sort skipped when no lane asks for top-p
        np.testing.assert_array_equal(ts.warp_logits(
            torch.from_numpy(logits), temp, top_k, None).numpy(), got)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(np.where(np.isneginf(got), 0, got),
                               np.where(np.isneginf(want), 0, want),
                               atol=1e-6, rtol=0)


def test_warp_logits_per_lane_matches_jax_lane_by_lane():
    """Temperature and top_p one a lane, over lanes of several rows (the
    guess rows of a step): each lane equals JAX with its own scalars, and a
    lane at top_p 1 keeps its whole support."""
    logits = np.random.RandomState(1).randn(4, 3, 40).astype(np.float32) * 3
    temps = np.array([0.6, 1.0, 1.3, 0.9], np.float32)
    tops = np.array([0.7, 1.0, 0.9, 0.5], np.float32)
    got = ts.warp_logits(torch.from_numpy(logits), torch.from_numpy(temps),
                         6, torch.from_numpy(tops)).numpy()
    for b in range(4):
        want = np.asarray(jax_warp(jnp.asarray(logits[b]),
                                   jnp.float32(temps[b]), 6,
                                   jnp.float32(tops[b])))
        np.testing.assert_array_equal(np.isneginf(got[b]), np.isneginf(want))
        np.testing.assert_allclose(np.where(np.isneginf(got[b]), 0, got[b]),
                                   np.where(np.isneginf(want), 0, want),
                                   atol=1e-6, rtol=0)
    assert np.isfinite(got[1]).sum() == 3 * 6     # top-k only


def _jax_noise(key, G, GS, V):
    """The noise JAX's rejection_sample_verify draws from ``key``."""
    k_u, k_res = jax.random.split(key)
    res_keys = jax.random.split(k_res, GS)
    return (jax.random.uniform(k_u, (GS, G)),
            jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32))(
                res_keys))


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _random_case(rng, V, G, GS, kind):
    scale = {"peaked": 6.0, "flat": 0.3, "mixed": 2.0}[kind]
    probs_next = _softmax(rng.randn(V) * scale)
    guess_probs = _softmax(rng.randn(G, GS, V) * scale)
    # drafts from the likely tokens, so that acceptances happen, with
    # repeats of whole candidates and of single drafts
    top = np.argsort(-probs_next)[:4]
    tokens = rng.choice(top, size=(G, GS)).astype(np.int32)
    if G > 1 and rng.rand() < 0.5:
        tokens[1] = tokens[0]
    valid = rng.rand(G) < 0.8
    return probs_next, guess_probs, tokens, valid


def _check_against_jax(cases, seed):
    """Cases of one shape, each through JAX's rejection_sample_verify with
    its own key (one vmapped call) and through the port's core function
    with that key's noise (one batched call). Returns the hits counts."""
    probs_next, guess_probs, tokens, valid = (
        np.stack([c[j] for c in cases]) for j in range(4))
    G, GS = tokens.shape[1:]
    V = probs_next.shape[-1]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(cases))
    want = jax.jit(jax.vmap(jax_verify))(
        jnp.asarray(probs_next), jnp.asarray(guess_probs),
        jnp.asarray(tokens), jnp.asarray(valid), keys)
    u, g = jax.vmap(lambda k: _jax_noise(k, G, GS, V))(keys)
    got = ts.rejection_sample_verify_core(
        *(torch.from_numpy(np.array(x)) for x in (
            probs_next, guess_probs, tokens, valid, u, g)))
    np.testing.assert_array_equal(got.hits.numpy(), np.asarray(want.hits))
    np.testing.assert_array_equal(got.max_hit.numpy(),
                                  np.asarray(want.max_hit))
    np.testing.assert_array_equal(got.winner.numpy(),
                                  np.asarray(want.winner))
    return np.asarray(want.max_hit)


@pytest.mark.parametrize("kind", ["peaked", "flat", "mixed"])
def test_verify_matches_jax_with_jax_noise(kind):
    """80 random cases a kind (240 in all), in four shapes: duplicate
    candidates and drafts, invalid candidates, peaked and flat
    distributions."""
    rng = np.random.RandomState({"peaked": 0, "flat": 1, "mixed": 2}[kind])
    max_hits = []
    for seed, (V, G, GS) in enumerate(((8, 1, 2), (16, 3, 3), (50, 5, 4),
                                       (12, 4, 6))):
        max_hits.append(_check_against_jax(
            [_random_case(rng, V, G, GS, kind) for _ in range(20)], seed))
    max_hits = np.concatenate(max_hits)
    assert (max_hits > 0).any()     # some cases took the acceptance path


def test_verify_matches_jax_on_duplicate_and_invalid_candidates():
    """Every candidate the same n-gram, a draft repeated inside one
    position's candidates, and a lane whose candidates are all invalid."""
    rng = np.random.RandomState(5)
    V, GS = 12, 3
    probs_next = _softmax(rng.randn(V) * 2)
    guess_probs = _softmax(rng.randn(4, GS, V) * 2)
    top = int(np.argmax(probs_next))
    same = np.full((4, GS), top, np.int32)
    repeat = np.array([[top, 1, 2], [top, 1, 3], [top, 1, 2], [5, 5, 5]],
                      np.int32)
    for seed, (tokens, valid) in enumerate((
            (same, np.ones(4, bool)), (repeat, np.array([1, 0, 1, 1], bool)),
            (repeat, np.zeros(4, bool)))):
        _check_against_jax([(probs_next, guess_probs, tokens, valid)] * 20,
                           seed)


def test_verify_batched_equals_lane_by_lane():
    """B lanes in one call give each lane's single-lane result."""
    rng = np.random.RandomState(6)
    V, G, GS, B = 16, 4, 3, 5
    cases = [_random_case(rng, V, G, GS, "mixed") for _ in range(B)]
    u = torch.from_numpy(rng.rand(B, GS, G).astype(np.float32))
    g = ts.gumbel(torch.from_numpy(rng.rand(B, GS, V).astype(np.float32)))
    batched = ts.rejection_sample_verify_core(
        *(torch.from_numpy(np.stack([c[j] for c in cases])) for j in range(4)),
        u, g)
    for b, c in enumerate(cases):
        one = ts.rejection_sample_verify_core(
            *(torch.from_numpy(x)[None] for x in c), u[b:b + 1], g[b:b + 1])
        for field in ("hits", "max_hit", "winner"):
            assert torch.equal(getattr(batched, field)[b],
                               getattr(one, field)[0])


def test_verify_without_candidates_is_jax_categorical():
    """G = 0: JAX's step draws ``jax.random.categorical(key, log p)``; the
    port's core takes the same Gumbel vector as its first position's
    noise and confirms one token."""
    rng = np.random.RandomState(7)
    V, GS = 20, 4
    for k in range(30):
        probs = _softmax(rng.randn(V) * 2)
        key = jax.random.PRNGKey(k)
        want = int(jax.random.categorical(
            key, jnp.log(jnp.maximum(jnp.asarray(probs), 1e-38))))
        noise = np.zeros((GS, V), np.float32)
        noise[0] = np.asarray(jax.random.gumbel(key, (V,), jnp.float32))
        got = ts.rejection_sample_verify_core(
            torch.from_numpy(probs)[None], torch.zeros(1, 0, GS, V),
            torch.zeros(1, 0, GS, dtype=torch.int32),
            torch.zeros(1, 0, dtype=torch.bool), torch.zeros(1, GS, 0),
            torch.from_numpy(noise)[None])
        assert got.hits[0].tolist() == [want] + [0] * (GS - 1)
        assert int(got.max_hit[0]) == 0 and int(got.winner[0]) == 0


def test_sample_token_is_gumbel_max_of_the_warped_logits():
    logits = torch.from_numpy(
        np.random.RandomState(8).randn(3, 30).astype(np.float32) * 2)
    key = torch.tensor([seed_key(s) for s in (1, 2, 3)], dtype=torch.int32)
    draws = torch.tensor([0, 4, 9])
    got = ts.sample_token(logits, 0.8, 5, 0.9, key, draws)
    warped = ts.warp_logits(logits, 0.8, 5, 0.9)
    want = (warped + ts.gumbel(ts.lane_uniforms(key, draws, 30))).argmax(-1)
    assert torch.equal(got, want.int())
    assert torch.isfinite(warped.gather(1, got.long()[:, None])).all()


# ---------------------------------------------------------------------------
# Statistical tests of tests/test_sampling.py, on the port
# ---------------------------------------------------------------------------

def test_mid_ngram_conditional_distribution_preserved():
    """tests/test_sampling.py's mid-n-gram check through the port's
    rejection_sample_verify: 20,000 lanes of one batched call, each with
    its own stream (key i, the first draw). The first-token marginal
    within TV 0.02, and the token after an accepted draft tau following
    q(. | tau) within TV 0.08."""
    V, N = 8, 20_000
    rng = np.random.RandomState(0)

    def rand_dist(peak_ix, peak):
        p = rng.rand(V).astype(np.float64) * (1 - peak)
        p[peak_ix] = 0
        p = p / p.sum() * (1 - peak)
        p[peak_ix] = peak
        return p

    probs_next = rand_dist(2, 0.35)
    probs_next[3] += probs_next[4] * 0.5
    probs_next[4] *= 0.5
    probs_next /= probs_next.sum()
    q_after2 = rand_dist(5, 0.4)
    q_after3 = rand_dist(1, 0.3)
    gp = np.zeros((3, 2, V), np.float64)
    gp[0, 0] = gp[1, 0] = q_after2
    gp[2, 0] = q_after3
    gp[:, 1] = 1.0 / V
    tokens = torch.tensor([[2, 5], [2, 6], [3, 1]], dtype=torch.int32)
    key = torch.tensor([seed_key(i) for i in range(N)], dtype=torch.int32)
    res = ts.rejection_sample_verify(
        torch.tensor(probs_next, dtype=torch.float32).expand(N, V),
        torch.tensor(gp, dtype=torch.float32).expand(N, 3, 2, V),
        tokens.expand(N, 3, 2), torch.ones(N, 3, dtype=torch.bool), key,
        torch.zeros(N, dtype=torch.int64))
    hits, max_hit = res.hits.numpy(), res.max_hit.numpy()
    emp0 = np.bincount(hits[:, 0], minlength=V) / N
    assert 0.5 * np.abs(emp0 - probs_next).sum() < 0.02
    for tau in (2, 3):
        assert np.all(max_hit[hits[:, 0] == tau] >= 1)
    for tau, q in ((2, q_after2), (3, q_after3)):
        sel = hits[:, 0] == tau
        assert sel.sum() > 2000, (tau, sel.sum())
        emp1 = np.bincount(hits[sel, 1], minlength=V) / sel.sum()
        assert 0.5 * np.abs(emp1 - q).sum() < 0.08, (tau, emp1, q)
    assert np.all(max_hit[~np.isin(hits[:, 0], [2, 3])] == 0)


def _tiny_port_engine(pool_from_prompt):
    jcfg = jlt.LlamaConfig(
        vocab_size=64, hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, dtype=jnp.float32)
    tree = jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                          scale=0.6))
    tcfg = tlt.LlamaConfig(
        vocab_size=64, hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, dtype=torch.float32)
    params = tlt.params_from_numpy(tree, tcfg, "cpu")
    eng = tlt.LookaheadEngine(
        tcfg, params,
        tlt.LookaheadConfig(level=4, window_size=5, guess_set_size=4,
                            pool_from_prompt=pool_from_prompt),
        tlt.EngineConfig(max_seq_len=256, prefill_chunk=16), device="cpu")
    return eng, tcfg, params


def _next_token_probs(tcfg, params, prompt):
    """The model's softmax after ``prompt``, by a causal forward."""
    k, v = tllama.make_kv_cache(tcfg, 64, "cpu")
    cos, sin = tllama.rope_tables(tcfg, 64, "cpu")
    T = len(prompt)
    with torch.inference_mode():
        logits, _, _ = tllama.forward(
            params, tcfg, torch.tensor(prompt), torch.arange(T), k, v, 0,
            cos, sin, dict(level=4, window=5, guess_size=3, causal=True,
                           kv_len=torch.tensor([0], dtype=torch.int32)))
    return torch.softmax(logits[-1], -1).numpy()


@pytest.mark.parametrize("guesses_active", [False, True])
def test_first_token_marginal_matches_model_distribution(guesses_active):
    """The first sampled token over 400 seeds follows the model's softmax
    (TV < 0.35, the JAX test's bound), with no candidates, and with
    verification candidates active at the first step (a repetitive prompt
    seeds the pool)."""
    eng, tcfg, params = _tiny_port_engine(guesses_active)
    prompt = ([5, 9, 13] * 4 if guesses_active else [3, 9, 27, 14, 9, 3])
    if guesses_active:
        out_buf, P, fill = eng._host_args(prompt, 1)
        with torch.inference_mode():
            st = eng._prepare(out_buf, P, 0, fill)
        _, valid = pool_lookup(st.pool, torch.tensor([prompt[-1]]))
        assert bool(valid.any())
    counts = np.zeros(tcfg.vocab_size)
    for seed in range(400):
        r = eng.generate_sample(prompt, 1, tlt.SamplingConfig(), seed=seed)
        counts[r.new_tokens[0]] += 1
    target = _next_token_probs(tcfg, params, prompt)
    tv = 0.5 * np.abs(counts / 400 - target).sum()
    assert tv < 0.35, tv
