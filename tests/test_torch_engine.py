"""The port's engine end to end on the CPU, in float32, against the JAX
package's engine on the same numpy weights, and against its own AR
baseline. Tokens and step counts must be equal: the window is seeded
with ``order_copy_from`` wherever steps are compared, since the default
``copy_from`` draws from each framework's own generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)


def weights(seed=0, **extra):
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32, **extra)
    params = jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(seed),
                                            scale=0.5))
    tcfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32, **extra)
    return jcfg, params, tcfg, tlt.params_from_numpy(params, tcfg, "cpu")


def engines(level=4, window=5, guess=4, max_seq=256, jax_impl="xla",
            port_impl="dense", seed=0, model_extra=None, **lkw):
    jcfg, jparams, tcfg, tparams = weights(seed, **(model_extra or {}))
    kw = dict(level=level, window_size=window, guess_set_size=guess, **lkw)
    ekw = dict(max_seq_len=max_seq, prefill_chunk=16, dtype="float32")
    jeng = jlt.LookaheadEngine(
        jcfg, jparams, jlt.LookaheadConfig(attention_impl=jax_impl, **kw),
        jlt.EngineConfig(**ekw))
    teng = tlt.LookaheadEngine(
        tcfg, tparams, tlt.LookaheadConfig(attention_impl=port_impl, **kw),
        tlt.EngineConfig(**ekw), device="cpu")
    return jeng, teng


def prompt(seed, n):
    return list(np.random.RandomState(seed).randint(0, 128, size=n))


@pytest.mark.parametrize("impls", [("xla", "dense"), ("pallas", "kernel")])
@pytest.mark.parametrize("pool_from_prompt", [False, True])
def test_generate_matches_jax_tokens_and_steps(impls, pool_from_prompt):
    """JAX at "xla" against the port's dense path; JAX's Pallas kernel in
    interpret mode against the port's kernel path (its plain version on
    the CPU)."""
    jeng, teng = engines(jax_impl=impls[0], port_impl=impls[1],
                         pool_from_prompt=pool_from_prompt,
                         window_init="order_copy_from")
    p = prompt(0, 20)
    want, got = jeng.generate(p, 64), teng.generate(p, 64)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.steps == want.steps
    assert got.steps < 64             # some guesses were accepted


@pytest.mark.parametrize("lkw", [
    dict(always_fwd_one=False, pool_from_prompt=True),
    dict(pool_key_len=2, pool_from_prompt=True, pool_hash_size=97),
    dict(guess=0),
    dict(model_extra=dict(sliding_window=48), pool_from_prompt=True),
], ids=["afo0", "bigram", "no_guess", "sliding_window"])
def test_variants_match_jax_and_baseline(lkw):
    lkw = dict(lkw, window_init="order_copy_from")
    jeng, teng = engines(**lkw)
    p = prompt(4, 30)
    want, got = jeng.generate(p, 48), teng.generate(p, 48)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    if lkw.get("always_fwd_one", True):   # afo0 refills from each RNG
        assert got.steps == want.steps
    np.testing.assert_array_equal(teng.generate_baseline(p, 48).tokens,
                                  got.tokens)


def test_capacity_stop_matches_jax():
    """max_new past the cache: both stop at the KV budget, same tokens."""
    jeng, teng = engines(max_seq=64, window_init="order_copy_from")
    p = prompt(2, 20)
    want, got = jeng.generate(p, 200), teng.generate(p, 200)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.steps == want.steps and got.num_generated < 200
    np.testing.assert_array_equal(
        teng.generate_baseline(p, 200).tokens,
        jeng.generate_baseline(p, 200).tokens)


@pytest.mark.parametrize("window_init", ["copy_from", "random_set",
                                         "copy_from_last", "order_copy_from"])
@pytest.mark.parametrize("pool_from_prompt", [False, True])
def test_generate_equals_baseline(window_init, pool_from_prompt):
    _, teng = engines(window_init=window_init,
                      pool_from_prompt=pool_from_prompt)
    p = prompt(0, 20)
    base = teng.generate_baseline(p, 64)
    lade = teng.generate(p, 64, seed=3)
    assert base.num_generated == 64 and base.steps == 64
    np.testing.assert_array_equal(lade.tokens, base.tokens)
    assert lade.steps <= base.steps


def test_compression_above_one_on_repetitive_model():
    _, teng = engines(level=5, window=6, guess=6)
    r = teng.generate(prompt(1, 16), 100)
    assert r.num_generated == 100
    assert r.compression_ratio > 1.0


def test_eos_stops_generation():
    _, teng = engines()
    p = prompt(0, 12)
    gen = teng.generate(p, 80).new_tokens
    eos = int(gen[10])
    first = int(np.argmax(gen == eos))
    np.testing.assert_array_equal(teng.generate(p, 80, eos_token_id=eos)
                                  .new_tokens, gen[:first + 1])
    np.testing.assert_array_equal(teng.generate_baseline(
        p, 80, eos_token_id=eos).new_tokens, gen[:first + 1])
    eos_b = int(gen[5])
    first_b = min(first, int(np.argmax(gen == eos_b)))
    np.testing.assert_array_equal(teng.generate(
        p, 80, eos_token_id=[eos, eos_b]).new_tokens, gen[:first_b + 1])


def test_short_prompts_and_trimmed_overshoot():
    _, teng = engines(pool_from_prompt=True)
    np.testing.assert_array_equal(teng.generate([5], 32).tokens,
                                  teng.generate_baseline([5], 32).tokens)
    assert teng.generate(prompt(3, 10), 17).num_generated == 17


@pytest.mark.parametrize("call,match", [
    (lambda e: e.generate([], 8), "empty prompt"),
    (lambda e: e.generate(list(range(240)), 8), "exceeds max_seq_len"),
    (lambda e: e.generate([1, 2], 0), "max_new_tokens"),
    (lambda e: e.generate_baseline([1, 2], 0), "max_new_tokens"),
    (lambda e: e.generate([1, 128], 4), r"\[0, 128\)"),
    (lambda e: e.generate([1, 2], 4, eos_token_id=[1, 2, 3, 4, 5]), "eos"),
])
def test_error_probes_raise(call, match):
    """The JAX engine's probes (empty prompt, oversized prompt,
    max_new_tokens < 1) raise ValueError the same way; the port also
    refuses token ids outside the vocabulary, which would be a device-side
    assert on CUDA."""
    jeng, teng = engines()
    with pytest.raises(ValueError, match=match):
        call(teng)
    if match in ("empty prompt", "exceeds max_seq_len", "max_new_tokens",
                 "eos"):
        with pytest.raises(ValueError, match=match):
            call(jeng)


def test_engine_needs_cuda_unless_cpu_is_asked(monkeypatch):
    _, _, tcfg, tparams = weights()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlt.LookaheadEngine(tcfg, tparams)
    eng = tlt.LookaheadEngine(tcfg, tparams, device="cpu")
    assert eng.lcfg.attention_impl == "dense"     # "auto" on the CPU


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_card_never_falls_back_to_the_dense_path(monkeypatch, impl):
    """On a CUDA device "auto" means the kernel: a head_dim the kernel does
    not take raises (as for an explicit "kernel") instead of running the
    plain version on the card. The check comes before any device work."""
    _, _, tcfg, tparams = weights()               # head_dim 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="head_dim"):
        tlt.LookaheadEngine(tcfg, tparams,
                            tlt.LookaheadConfig(attention_impl=impl))


@pytest.mark.parametrize("impls", [("xla", "dense"), ("pallas", "kernel")])
def test_head_dim_256_matches_jax_tokens_and_steps(impls):
    """Gemma's head_dim 256 with Hq * D (1024) unlike the hidden width
    (64): JAX at "xla" against the port's dense path, JAX's Pallas kernel
    in interpret mode against the port's kernel path. Equal tokens and
    steps, some guesses accepted."""
    jeng, teng = engines(jax_impl=impls[0], port_impl=impls[1],
                         pool_from_prompt=True, window_init="order_copy_from",
                         model_extra={"head_dim_override": 256})
    p = prompt(2, 30)
    want, got = jeng.generate(p, 64), teng.generate(p, 64)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.steps == want.steps
    assert got.steps < 64
    np.testing.assert_array_equal(teng.generate_baseline(p, 64).tokens,
                                  got.tokens)


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_card_takes_head_dim_256(monkeypatch, impl):
    """On a CUDA device head_dim 256 passes the kernel's guard: the engine
    goes on to its first device allocation, which a CPU-only torch refuses
    (no head_dim ValueError)."""
    _, _, tcfg, tparams = weights(head_dim_override=256)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tlt.LookaheadEngine(tcfg, tparams,
                            tlt.LookaheadConfig(attention_impl=impl))


@pytest.mark.parametrize("ecfg,match", [
    (dict(max_seq_len=32), "max_seq_len"),
    (dict(max_seq_len=64, prefill_chunk=128), "prefill_chunk"),
])
def test_build_checks(ecfg, match):
    _, _, tcfg, tparams = weights()
    with pytest.raises(ValueError, match=match):
        tlt.LookaheadEngine(tcfg, tparams, tlt.LookaheadConfig(),
                            tlt.EngineConfig(**ecfg), device="cpu")
