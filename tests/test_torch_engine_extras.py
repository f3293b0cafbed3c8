"""The port's flat-engine entry points beyond ``generate`` on the CPU in
float32: ``generate_sample``, ``generate_stream``, ``generate_batch`` and
prefix caching (``precompute_prefix``, ``prefix=``, ``return_prefix=``).

Greedy paths are held against the JAX package's engine on the same numpy
weights: tokens and step counts equal (the window is seeded with
``order_copy_from``, since ``copy_from`` draws from each framework's own
generator). Sampling paths draw from torch generators, so they are held
against the port itself: a stream against the one-shot call, a batch lane
against its lone call, a prefix run against the full prefill; near-zero
temperature against greedy; every token inside the warped support.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu.core import pool as jpool
from lookaheaddecoding_tpu_torch.core import pool as tpool
from lookaheaddecoding_tpu_torch.models import llama as tllama
from lookaheaddecoding_tpu_torch.ops.sampling import warp_logits

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)


def engines(kv_quant=None, **lkw):
    """The JAX and the port engine on the same weights."""
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    tree = jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                          scale=0.5))
    tcfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    kw = dict(level=4, window_size=5, guess_set_size=4, pool_from_prompt=True,
              window_init="order_copy_from", **lkw)
    ekw = dict(max_seq_len=256, prefill_chunk=16, kv_quant=kv_quant)
    jeng = jlt.LookaheadEngine(jcfg, tree, jlt.LookaheadConfig(**kw),
                               jlt.EngineConfig(dtype="float32", **ekw))
    teng = tlt.LookaheadEngine(tcfg, tlt.params_from_numpy(tree, tcfg, "cpu"),
                               tlt.LookaheadConfig(**kw),
                               tlt.EngineConfig(**ekw), device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def pair():
    return engines()


@pytest.fixture(scope="module")
def eng(pair):
    return pair[1]


def prompt(seed, n):
    return list(np.random.RandomState(seed).randint(0, 128, size=n))


SYSTEM = prompt(7, 40)         # crosses prefill chunks of 16


def suffixed(n, seed):
    return SYSTEM + prompt(seed, n)


def drain(gen):
    """A stream's chunks and its StopIteration value."""
    chunks = []
    while True:
        try:
            chunks.append(next(gen))
        except StopIteration as stop:
            return chunks, stop.value


# ---------------------------------------------------------------------------
# Greedy against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lookahead", [True, False])
@pytest.mark.parametrize("steps_per_yield", [1, 3])
def test_stream_matches_jax(pair, lookahead, steps_per_yield):
    jeng, teng = pair
    p = prompt(2, 10)
    want = list(jeng.generate_stream(p, 30, lookahead=lookahead,
                                     steps_per_yield=steps_per_yield))
    got = list(teng.generate_stream(p, 30, lookahead=lookahead,
                                    steps_per_yield=steps_per_yield))
    assert [c.tolist() for c in got] == [c.tolist() for c in want]
    if not lookahead and steps_per_yield == 1:
        assert all(len(c) == 1 for c in got)     # one token an AR step


def test_batch_matches_jax_with_staggered_finishes(pair):
    """Lanes of different prompt lengths, one with an early EOS: tokens and
    steps of each lane equal JAX's generate_batch and the lone call."""
    jeng, teng = pair
    rng = np.random.RandomState(7)
    prompts = [list(rng.randint(0, 128, size=n)) for n in (10, 14, 8)]
    eos = int(teng.generate(prompts[1], 30, seed=1).new_tokens[5])
    want = jeng.generate_batch(prompts, 30, eos_token_id=eos)
    got = teng.generate_batch(prompts, 30, eos_token_id=eos)
    assert len(got) == 3
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.steps == w.steps
        lone = teng.generate(prompts[i], 30, eos_token_id=eos, seed=i)
        np.testing.assert_array_equal(g.tokens, lone.tokens)
    assert got[1].num_generated == 6


def test_batch_with_prefix_matches_jax(pair):
    jeng, teng = pair
    prompts = [suffixed(n, 300 + n) for n in (7, 12, 9)]
    want = jeng.generate_batch(prompts, 16, seeds=[50, 51, 52],
                               prefix=jeng.precompute_prefix(SYSTEM))
    got = teng.generate_batch(prompts, 16, seeds=[50, 51, 52],
                              prefix=teng.precompute_prefix(SYSTEM))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.steps == w.steps


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_prefix_matches_jax_and_full_prefill(kv_quant):
    jeng, teng = engines(kv_quant=kv_quant)
    jpc, tpc = jeng.precompute_prefix(SYSTEM), teng.precompute_prefix(SYSTEM)
    assert tpc.length == jpc.length == len(SYSTEM)
    for seed, n_suf in ((1, 9), (2, 17)):
        p = suffixed(n_suf, seed)
        for name in ("generate", "generate_baseline"):
            want = getattr(jeng, name)(p, 32, prefix=jpc)
            got = getattr(teng, name)(p, 32, prefix=tpc)
            np.testing.assert_array_equal(got.tokens, want.tokens)
            assert got.steps == want.steps
            np.testing.assert_array_equal(
                got.tokens, getattr(teng, name)(p, 32).tokens)


def test_conversation_turns_match_jax(pair):
    """return_prefix chains turns (the warm pool carried): each turn equals
    JAX's chained turn, with its steps, and the full-prompt run."""
    jeng, teng = pair
    turn1 = SYSTEM + prompt(31, 8)
    j1 = jeng.generate(turn1, 16, return_prefix=True)
    t1 = teng.generate(turn1, 16, return_prefix=True)
    np.testing.assert_array_equal(t1.tokens, j1.tokens)
    assert t1.prefix.length == j1.prefix.length
    np.testing.assert_array_equal(t1.prefix.tokens,
                                  t1.tokens[:t1.prefix.length])
    turn2 = list(t1.tokens) + prompt(32, 7)
    j2 = jeng.generate(turn2, 16, prefix=j1.prefix, return_prefix=True)
    t2 = teng.generate(turn2, 16, prefix=t1.prefix, return_prefix=True)
    np.testing.assert_array_equal(t2.tokens, j2.tokens)
    assert t2.steps == j2.steps
    np.testing.assert_array_equal(t2.tokens, teng.generate(turn2, 16).tokens)
    turn3 = list(t2.tokens) + prompt(33, 5)
    np.testing.assert_array_equal(
        teng.generate(turn3, 12, prefix=t2.prefix).tokens,
        jeng.generate(turn3, 12, prefix=j2.prefix).tokens)
    # the AR baseline carries the same chain
    rb = teng.generate_baseline(turn1, 16, return_prefix=True)
    turn2b = list(rb.tokens) + prompt(32, 7)
    np.testing.assert_array_equal(
        teng.generate_baseline(turn2b, 16, prefix=rb.prefix).tokens,
        teng.generate_baseline(turn2b, 16).tokens)


def test_stream_return_prefix_chains_turns(pair):
    jeng, teng = pair
    turn1 = SYSTEM + prompt(41, 8)
    chunks, px = drain(teng.generate_stream(turn1, 16, return_prefix=True))
    jchunks, jpx = drain(jeng.generate_stream(turn1, 16, return_prefix=True))
    conv = turn1 + np.concatenate(chunks).tolist()
    assert conv == turn1 + np.concatenate(jchunks).tolist()
    assert px.length == jpx.length
    np.testing.assert_array_equal(px.tokens, conv[:px.length])
    turn2 = conv + prompt(42, 6)
    np.testing.assert_array_equal(
        np.concatenate(list(teng.generate_stream(turn2, 12, prefix=px))),
        np.concatenate(list(teng.generate_stream(turn2, 12))))


def test_prompt_equal_to_prefix_and_chunk_overlap(eng):
    """The prompt is the prefix itself; a suffix shorter than the prefill
    chunk (the aligned last chunk rewrites prefix rows, in the copy)."""
    pc = eng.precompute_prefix(SYSTEM)
    for p in (SYSTEM, suffixed(3, 5)):
        np.testing.assert_array_equal(eng.generate(p, 20, prefix=pc).tokens,
                                      eng.generate(p, 20).tokens)


def test_fill_pool_with_prompt_matches_jax():
    """The device fill of the port against JAX's: keys, n-grams, ages and
    clock equal on every key row."""
    rng = np.random.RandomState(0)
    for level, g, vocab in ((4, 3, 10), (3, 4, 16), (5, 2, 6)):
        prompt_ = rng.randint(0, vocab, size=40)
        buf = np.zeros(64, np.int32)
        buf[:len(prompt_)] = prompt_
        jp = jpool.fill_pool_with_prompt(
            jpool.pool_init(vocab, g, level - 1), jnp.asarray(buf),
            jnp.int32(len(prompt_)), level)
        tp = tpool.fill_pool_with_prompt(
            tpool.pool_init(vocab, g, level - 1, device="cpu"),
            torch.from_numpy(buf), len(prompt_), level)
        np.testing.assert_array_equal(tp.values.numpy()[:vocab],
                                      np.asarray(jp.values)[:vocab])
        np.testing.assert_array_equal(tp.age.numpy()[:vocab],
                                      np.asarray(jp.age)[:vocab])
        assert int(tp.clock) == int(jp.clock)


# ---------------------------------------------------------------------------
# Sampling, the port against itself
# ---------------------------------------------------------------------------

def test_near_zero_temperature_matches_greedy(eng):
    p = prompt(0, 16)
    greedy = eng.generate(p, 48)
    for seed in (0, 1, 2):
        s = eng.generate_sample(p, 48, tlt.SamplingConfig(temperature=0.01),
                                seed=seed)
        np.testing.assert_array_equal(s.tokens, greedy.tokens)


def test_sampling_seeds_differ(eng):
    p = prompt(2, 10)
    a = eng.generate_sample(p, 32, tlt.SamplingConfig(), seed=0)
    b = eng.generate_sample(p, 32, tlt.SamplingConfig(), seed=1)
    assert not np.array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(
        a.tokens, eng.generate_sample(p, 32, tlt.SamplingConfig(),
                                      seed=0).tokens)


@pytest.mark.parametrize("always_fwd_one", [True, False])
def test_sampled_tokens_lie_in_warped_support(always_fwd_one):
    """Each emitted token lies in the top-k/top-p support of the model's
    conditional at its position, by a teacher-forced causal forward."""
    _, teng = engines(always_fwd_one=always_fwd_one)
    p = prompt(1, 12)
    cfg = tlt.SamplingConfig(temperature=0.8, top_k=8, top_p=0.95)
    toks = teng.generate_sample(p, 40, cfg, seed=3).tokens
    T = len(toks)
    mcfg = teng.mcfg
    k, v = tllama.make_kv_cache(mcfg, 128, "cpu")
    cos, sin = tllama.rope_tables(mcfg, 128, "cpu")
    with torch.inference_mode():
        logits, _, _ = tllama.forward(
            teng.params, mcfg, torch.from_numpy(toks.astype(np.int64)),
            torch.arange(T), k, v, 0, cos, sin,
            dict(level=4, window=5, guess_size=3, causal=True,
                 kv_len=torch.tensor([0], dtype=torch.int32)))
        warped = warp_logits(logits, cfg.temperature, cfg.top_k,
                             cfg.top_p).numpy()
    for i in range(len(p), T):
        assert not np.isneginf(warped[i - 1, toks[i]]), i


@pytest.mark.parametrize("steps_per_yield", [1, 3])
def test_sampling_stream_matches_oneshot(eng, steps_per_yield):
    p = prompt(2, 10)
    cfg = tlt.SamplingConfig(temperature=0.9, top_k=20, top_p=0.95)
    one = eng.generate_sample(p, 40, cfg, seed=7)
    chunks = list(eng.generate_stream(p, 40, seed=7, sampling=cfg,
                                      steps_per_yield=steps_per_yield))
    np.testing.assert_array_equal(np.concatenate(chunks), one.new_tokens)
    assert len(chunks) > 1
    np.testing.assert_array_equal(
        np.concatenate(list(eng.generate_stream(p, 40, steps_per_yield=3))),
        eng.generate(p, 40).new_tokens)


def test_sampling_batch_lane_equals_lone_call(eng):
    """Per-lane seeds, temperatures and top_ps: lane i equals the lone
    generate_sample with its seed and its own warpers; a lane's top_p
    applies though the config's is 1.0."""
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(0, 128, size=n)) for n in (10, 14, 8)]
    cfg = tlt.SamplingConfig(temperature=0.9, top_k=16)
    temps, tops = [0.7, 1.0, 1.3], [1.0, 0.8, 0.9]
    batch = eng.generate_batch(prompts, 30, sampling=cfg, seeds=[5, 6, 7],
                               temperatures=temps, top_ps=tops)
    for i, b in enumerate(batch):
        lone = eng.generate_sample(
            prompts[i], 30, tlt.SamplingConfig(temps[i], cfg.top_k, tops[i]),
            seed=5 + i)
        np.testing.assert_array_equal(b.tokens, lone.tokens)
        assert b.steps == lone.steps
    plain = eng.generate_batch(prompts, 30, sampling=cfg, seeds=[5, 6, 7],
                               temperatures=temps)
    assert not np.array_equal(plain[1].tokens, batch[1].tokens)


def test_batch_runs_one_forward_a_step_for_all_lanes(eng, monkeypatch):
    """generate_batch's decode is one batched forward a step: fewer
    forwards than the lanes' steps summed (what lane-by-lane steps would
    take), each over every lane, and at least the slowest lane's steps."""
    calls = []
    forward_paged = tllama.forward_paged

    def counting(params, cfg, tokens, *args, **kw):
        calls.append(tokens.shape[0])
        return forward_paged(params, cfg, tokens, *args, **kw)
    monkeypatch.setattr(tllama, "forward_paged", counting)
    prompts = [prompt(s, n) for s, n in ((11, 12), (12, 20), (13, 9))]
    res = eng.generate_batch(prompts, 24, sampling=tlt.SamplingConfig(),
                             seeds=[1, 2, 3])
    steps = [r.steps for r in res]
    assert set(calls) == {3}
    assert max(steps) <= len(calls) < sum(steps), (len(calls), steps)


def test_sampling_with_prefix_matches_full_prefill_and_keeps_it(eng):
    """generate_sample, generate_stream and generate_batch with a prefix
    equal the same calls without it, and after every use the prefix's
    tensors are bit for bit what precompute_prefix returned."""
    pc = eng.precompute_prefix(SYSTEM)
    before = [t.clone() for t in (pc.k_cache, pc.v_cache)]
    cfg = tlt.SamplingConfig(temperature=0.8)
    for seed, n_suf in ((9, 10), (4, 3)):
        p = suffixed(n_suf, seed)
        np.testing.assert_array_equal(
            eng.generate_sample(p, 20, cfg, seed=seed, prefix=pc).tokens,
            eng.generate_sample(p, 20, cfg, seed=seed).tokens)
        np.testing.assert_array_equal(
            np.concatenate(list(eng.generate_stream(p, 16, sampling=cfg,
                                                    prefix=pc, seed=seed))),
            np.concatenate(list(eng.generate_stream(p, 16, sampling=cfg,
                                                    seed=seed))))
    prompts = [suffixed(n, n) for n in (4, 9)]
    for a, b in zip(eng.generate_batch(prompts, 16, sampling=cfg, prefix=pc),
                    eng.generate_batch(prompts, 16, sampling=cfg)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for t, b in zip((pc.k_cache, pc.v_cache), before):
        assert torch.equal(t, b)
    assert pc.pool is None


def test_sampling_conversation_keeps_the_carried_prefix(eng):
    """A sampled turn's return_prefix reused twice: both reuses equal, and
    its caches and warm pool are unchanged by them."""
    cfg = tlt.SamplingConfig(temperature=0.8)
    r1 = eng.generate_sample(SYSTEM + prompt(51, 6), 16, cfg, seed=1,
                             return_prefix=True)
    px = r1.prefix
    kept = [t.clone() for t in (px.k_cache, px.v_cache, px.pool.values,
                                px.pool.age, px.pool.clock)]
    turn2 = list(r1.tokens) + prompt(52, 5)
    a = eng.generate_sample(turn2, 16, cfg, seed=2, prefix=px)
    b = eng.generate_sample(turn2, 16, cfg, seed=2, prefix=px)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    for t, k in zip((px.k_cache, px.v_cache, px.pool.values, px.pool.age,
                     px.pool.clock), kept):
        assert torch.equal(t, k)


def test_extras_refuse_bad_arguments(eng):
    """JAX's raises, and a paged prefix given to the flat engine."""
    p = prompt(0, 10)
    cfg = tlt.SamplingConfig()
    with pytest.raises(ValueError, match="at least one prompt"):
        eng.generate_batch([], 8)
    with pytest.raises(ValueError, match="seeds must match"):
        eng.generate_batch([p, p], 8, seeds=[1])
    with pytest.raises(ValueError, match="need sampling"):
        eng.generate_batch([p], 8, temperatures=[0.5])
    with pytest.raises(ValueError, match="must match prompts"):
        eng.generate_batch([p, p], 8, sampling=cfg, top_ps=[0.9])
    with pytest.raises(ValueError, match="top_p"):
        eng.generate_batch([p], 8, sampling=cfg, top_ps=[1.5])
    with pytest.raises(ValueError, match="temperature"):
        eng.generate_batch([p], 8, sampling=cfg, temperatures=[0.0])
    pc = eng.precompute_prefix(SYSTEM)
    with pytest.raises(ValueError, match="does not start with"):
        eng.generate_batch([suffixed(4, 1), p], 8, prefix=pc)
    with pytest.raises(ValueError, match="does not start with"):
        eng.generate(p, 8, prefix=pc)
    with pytest.raises(ValueError, match="lookahead"):
        next(eng.generate_stream(p, 8, lookahead=False, sampling=cfg))
    with pytest.raises(ValueError, match="steps_per_yield"):
        next(eng.generate_stream(p, 8, steps_per_yield=0))
    with pytest.raises(ValueError, match="PrefixCache"):
        eng.generate(p, 8, prefix=tlt.PagedPrefix(np.array(p[:4]), (0,), 4))
    with pytest.raises(ValueError, match="empty prefix"):
        eng.precompute_prefix([])
    with pytest.raises(ValueError, match="leaves no room"):
        eng.precompute_prefix(list(range(100)) * 3)
