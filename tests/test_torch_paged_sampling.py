"""The port's PagedServingEngine in sampling mode on the CPU, in float32,
against the port's flat ``generate_sample``: the same seed and warpers give
the same tokens (the paged lanes draw from their own generators exactly as
the flat call does). Ports of ``tests/test_paged.py``'s sampling tests and
its sampling fuzz; sampled tokens come from torch generators, so they are
not compared with the JAX package's. A request's ``top_p`` is applied when
the engine's is 1.0 (the reference drops it there)."""

import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu_torch as tlt

# tiny models gain nothing from intra-op threads, and several test workers
# each with a full thread pool contend for the same cores
torch.set_num_threads(1)

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)


def model():
    cfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    return cfg, tlt.init_params(cfg, seed=0, scale=0.5, device="cpu")


def engines(sampling, num_lanes=2, page_size=64, steps_per_sync=1,
            kv_quant=None, **lkw):
    cfg, params = model()
    lc = tlt.LookaheadConfig(**dict(dict(level=4, window_size=5,
                                         guess_set_size=4,
                                         pool_from_prompt=True), **lkw))
    ec = tlt.EngineConfig(max_seq_len=256, prefill_chunk=16,
                          kv_quant=kv_quant)
    flat = tlt.LookaheadEngine(cfg, params, lc, ec, device="cpu")
    paged = tlt.PagedServingEngine(cfg, params, lc, ec, num_lanes=num_lanes,
                                   page_size=page_size, sampling=sampling,
                                   steps_per_sync=steps_per_sync,
                                   device="cpu")
    return flat, paged


def prompts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, 128, size=int(rng.randint(8, 30))))
            for _ in range(n)]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_sampling_matches_flat(kv_quant):
    """Same seed, same tokens and steps as the flat generate_sample, with
    more requests than lanes."""
    scfg = tlt.SamplingConfig(temperature=0.8, top_k=16)
    flat, paged = engines(scfg, kv_quant=kv_quant)
    ps = prompts(3)
    results = {r.request_id: r for r in paged.run([
        tlt.Request(prompt=p, max_new_tokens=24, seed=i, request_id=i)
        for i, p in enumerate(ps)])}
    for i, p in enumerate(ps):
        rf = flat.generate_sample(p, 24, scfg, seed=i)
        np.testing.assert_array_equal(results[i].tokens, rf.tokens)
        assert results[i].steps == rf.steps
    assert paged.alloc.used_pages == 0


def test_paged_sampling_with_prefix_matches_flat():
    scfg = tlt.SamplingConfig(temperature=0.8, top_k=16)
    flat, paged = engines(scfg, page_size=64)
    system = list(np.random.RandomState(5).randint(0, 128, size=40))
    px = paged.precompute_prefix(system)
    for seed, n in ((3, 8), (4, 20)):
        p = system + list(np.random.RandomState(6 + n).randint(0, 128,
                                                               size=n))
        np.testing.assert_array_equal(
            paged.generate(p, 20, seed=seed, prefix=px).tokens,
            flat.generate_sample(p, 20, scfg, seed=seed).tokens)
    paged.release_prefix(px)
    assert paged.alloc.used_pages == 0


def test_request_top_p_applies_when_the_engine_has_none():
    """Reference fault C.3.1 is not copied: with the engine's top_p at 1.0
    a request's top_p=0.5 is applied (it equals the flat call at top_p 0.5
    and differs from the one at 1.0), and a request's temperature too."""
    scfg = tlt.SamplingConfig(temperature=1.0)
    flat, paged = engines(scfg, steps_per_sync=2)
    p = prompts(1, seed=9)[0]
    res = {r.request_id: r for r in paged.run([
        tlt.Request(prompt=p, max_new_tokens=32, seed=4, request_id="topp",
                    top_p=0.5),
        tlt.Request(prompt=p, max_new_tokens=32, seed=4, request_id="plain"),
        tlt.Request(prompt=p, max_new_tokens=32, seed=4, request_id="temp",
                    temperature=0.6)])}
    want = flat.generate_sample(p, 32, tlt.SamplingConfig(1.0, top_p=0.5),
                                seed=4)
    np.testing.assert_array_equal(res["topp"].tokens, want.tokens)
    np.testing.assert_array_equal(
        res["plain"].tokens, flat.generate_sample(p, 32, scfg, seed=4).tokens)
    np.testing.assert_array_equal(
        res["temp"].tokens,
        flat.generate_sample(p, 32, tlt.SamplingConfig(0.6), seed=4).tokens)
    assert not np.array_equal(res["topp"].tokens, res["plain"].tokens)


def test_request_sampling_knobs_are_validated():
    flat, paged = engines(tlt.SamplingConfig(temperature=0.8))
    res = {r.request_id: r for r in paged.run([
        tlt.Request(prompt=[1, 2, 3], max_new_tokens=4, request_id=i, **kw)
        for i, kw in enumerate((dict(temperature=0.0), dict(top_p=1.5),
                                dict(top_p=0.0), {}))])}
    assert "temperature" in res[0].error
    assert "top_p" in res[1].error and "top_p" in res[2].error
    assert res[3].error is None and res[3].num_generated == 4


def test_sampling_stream_and_conversation_match_flat():
    """A streaming request's chunks and a carried second turn, each equal
    to the flat generate_sample (the second turn with the flat turn's own
    prefix: the carried warm pool proposes other drafts than a cold one,
    and in sampling the drafts decide which draws are spent)."""
    scfg = tlt.SamplingConfig(temperature=0.9, top_p=0.95)
    flat, paged = engines(scfg, page_size=32, steps_per_sync=2)
    p = prompts(1, seed=3)[0]
    chunks = []
    r1 = paged.run([tlt.Request(prompt=p, max_new_tokens=20, seed=1,
                                on_tokens=chunks.append,
                                return_prefix=True)])[0]
    one = flat.generate_sample(p, 20, scfg, seed=1, return_prefix=True)
    np.testing.assert_array_equal(r1.tokens, one.tokens)
    np.testing.assert_array_equal(np.concatenate([p] + chunks), one.tokens)
    assert r1.prefix.length == one.prefix.length
    turn2 = list(r1.tokens) + [7, 8, 9]
    r2 = paged.generate(turn2, 16, seed=2, prefix=r1.prefix)
    np.testing.assert_array_equal(
        r2.tokens, flat.generate_sample(turn2, 16, scfg, seed=2,
                                        prefix=one.prefix).tokens)
    paged.release_prefix(r1.prefix)
    assert paged.alloc.used_pages == 0


@pytest.mark.parametrize("trial", range(3))
def test_paged_sampling_fuzz_matches_flat(trial):
    """Random warpers, layouts, page sizes and per-request seeds and
    top_ps through the paged scheduler against sequential
    generate_sample."""
    rng = np.random.RandomState(200 + trial)
    scfg = tlt.SamplingConfig(
        temperature=float(rng.uniform(0.5, 1.3)),
        top_k=int(rng.choice([0, 8, 32])),
        top_p=float(rng.choice([1.0, 0.9])))
    flat, paged = engines(scfg, page_size=int(rng.choice([32, 64])),
                          window_size=4,
                          guess_set_size=int(rng.randint(0, 5)),
                          always_fwd_one=bool(rng.randint(2)))
    reqs, singles = [], []
    for i in range(3):
        p = list(rng.randint(0, 128, size=int(rng.randint(4, 30))))
        n_new = int(rng.randint(4, 30))
        top_p = float(rng.choice([scfg.top_p, 0.8]))
        singles.append(flat.generate_sample(
            p, n_new, tlt.SamplingConfig(scfg.temperature, scfg.top_k, top_p),
            seed=10 + i))
        reqs.append(tlt.Request(prompt=p, max_new_tokens=n_new, seed=10 + i,
                                request_id=i, top_p=top_p))
    by_id = {r.request_id: r for r in paged.run(reqs)}
    for i, s in enumerate(singles):
        np.testing.assert_array_equal(
            by_id[i].tokens, s.tokens,
            err_msg=f"trial={trial} {scfg} req={i}")
        assert by_id[i].steps == s.steps
    assert paged.alloc.used_pages == 0
