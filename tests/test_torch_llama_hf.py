"""The port's model-coverage layer against the JAX package's and against
in-process ``transformers`` models (no download: every HF model is built
from a config with random weights, as tests/test_llama_vs_hf.py does).

- ``LlamaConfig.from_hf`` equals JAX's field by field (except ``dtype``)
  for each family and rope scaling;
- ``rope_inv_freq`` and ``rope_tables`` equal JAX's bit for bit (numpy in
  both); ``rope_rows_dynamic`` is within 1e-6 of JAX's (both take
  correctly rounded float32 powers, which XLA's pow misses by an ulp in a
  few arguments in a thousand);
- the port's ``forward`` on ``convert_hf_model``'s weights gives HF's
  logits within tests/test_model_families.py's tolerance (atol 3e-4, rtol
  3e-3: float32 in another order through two layers) and JAX's within
  1e-5 (the same float32 arithmetic, with the rotations as the only
  operands that may differ by an ulp);
- engines with dynamic-NTK and llama3 rope are token-exact against their
  baselines and JAX's ``generate`` (tokens and steps);
- dynamic-NTK refuses prefix caching with JAX's message.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
from lookaheaddecoding_tpu.models import llama as jllama
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu_torch.models import llama as tllama

transformers = pytest.importorskip("transformers")

HF_TOL = dict(atol=3e-4, rtol=3e-3)
JAX_TOL = dict(atol=1e-5, rtol=1e-5)
NEG = float("-inf")

LLAMA3_RS = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
             "high_freq_factor": 4.0, "original_max_position_embeddings": 64}
YARN_RS = {"rope_type": "yarn", "factor": 4.0,
           "original_max_position_embeddings": 64}
SCALINGS = {
    "none": None,
    "default": {"rope_type": "default"},
    "linear": {"rope_type": "linear", "factor": 2.0},
    "dynamic": {"rope_type": "dynamic", "factor": 4.0},
    "llama3": LLAMA3_RS,
    "yarn": YARN_RS,
    "yarn-explicit": {**YARN_RS, "beta_fast": 16.0, "beta_slow": 2.0,
                      "attention_factor": 1.3},
    "yarn-mscale": {**YARN_RS, "mscale": 0.8, "mscale_all_dim": 0.4},
}
SMALL = dict(vocab_size=96, hidden_size=64, intermediate_size=112,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2)


def hf_config(family="llama", **kw):
    base = dict(SMALL, max_position_embeddings=256,
                attn_implementation="eager")
    base.update(kw)
    cls = {"llama": transformers.LlamaConfig,
           "mistral": transformers.MistralConfig,
           "qwen2": transformers.Qwen2Config,
           "gemma": transformers.GemmaConfig}[family]
    return cls(**base)


def hf_model(family="llama", seed=0, **kw):
    cfg = hf_config(family, **kw)
    torch.manual_seed(seed)
    cls = {"llama": transformers.LlamaForCausalLM,
           "mistral": transformers.MistralForCausalLM,
           "qwen2": transformers.Qwen2ForCausalLM,
           "gemma": transformers.GemmaForCausalLM}[family]
    return cls(cfg).eval()


def same_fields(tcfg, jcfg):
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


FAMILIES = {
    "llama-mha": ("llama", dict(num_key_value_heads=4)),
    "llama-gqa": ("llama", {}),
    "llama-tied": ("llama", dict(tie_word_embeddings=True)),
    "mistral-window": ("mistral", dict(sliding_window=8)),
    "qwen2": ("qwen2", {}),
    "gemma-head-dim-32": ("gemma", dict(head_dim=32)),
}


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_from_hf_families_equal_jax(case):
    family, kw = FAMILIES[case]
    cfg = hf_config(family, **kw)
    tcfg = tlt.LlamaConfig.from_hf(cfg, dtype=torch.float32)
    same_fields(tcfg, jlt.LlamaConfig.from_hf(cfg, dtype=jnp.float32))
    assert tcfg.dtype == torch.float32
    if family == "gemma":
        assert tcfg.head_dim == 32 and tcfg.scale_embeddings
        assert tcfg.rms_norm_offset == 1.0
        assert tcfg.hidden_act == "gelu_pytorch_tanh"
    if family == "qwen2":
        assert tcfg.attention_bias


@pytest.mark.parametrize("name", sorted(SCALINGS))
def test_from_hf_rope_scalings_equal_jax(name):
    cfg = hf_config(rope_scaling=SCALINGS[name])
    tcfg = tlt.LlamaConfig.from_hf(cfg)
    same_fields(tcfg, jlt.LlamaConfig.from_hf(cfg))
    assert tcfg.dtype == torch.bfloat16


def test_from_hf_reads_a_plain_namespace():
    """No ``transformers`` needed: Llama-3.2-1B's published config.json
    fields on a SimpleNamespace."""
    ns = types.SimpleNamespace(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
        rms_norm_eps=1e-5, rope_theta=500000.0,
        max_position_embeddings=131072, tie_word_embeddings=True,
        rope_scaling={"rope_type": "llama3", "factor": 32.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192})
    tcfg = tlt.LlamaConfig.from_hf(ns)
    same_fields(tcfg, jlt.LlamaConfig.from_hf(ns))
    assert tcfg.rope_scaling == ("llama3", (32.0, 1.0, 4.0, 8192.0))
    assert tcfg.head_dim == 64


@pytest.mark.parametrize("kind", ["longrope", "su"])
def test_unknown_rope_scaling_fails_loud(kind):
    cfg = types.SimpleNamespace(
        **SMALL, rms_norm_eps=1e-6, max_position_embeddings=256,
        rope_scaling={"rope_type": kind, "short_factor": [1.0] * 8,
                      "long_factor": [2.0] * 8,
                      "original_max_position_embeddings": 64})
    with pytest.raises(NotImplementedError, match=kind):
        tlt.LlamaConfig.from_hf(cfg)


# --------------------------------------------------------------------------
# rope helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCALINGS))
@pytest.mark.parametrize("seq_len", [None, 100, 400])
def test_rope_inv_freq_and_tables_equal_jax_bit_for_bit(name, seq_len):
    cfg = hf_config(rope_scaling=SCALINGS[name])
    tcfg = tlt.LlamaConfig.from_hf(cfg, dtype=torch.float32)
    jcfg = jlt.LlamaConfig.from_hf(cfg, dtype=jnp.float32)
    np.testing.assert_array_equal(tllama.rope_inv_freq(tcfg, seq_len),
                                  jllama.rope_inv_freq(jcfg, seq_len))
    assert tllama.rope_attention_factor(tcfg) == \
        jllama.rope_attention_factor(jcfg)
    n = seq_len or 96
    for got, want in zip(tllama.rope_tables(tcfg, n, "cpu"),
                         jllama.rope_tables(jcfg, n)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("keying", ["one-call", "scalar", "rows"])
@pytest.mark.parametrize("start", [0, 20, 60])   # below, across, above 32
def test_rope_rows_dynamic_within_1e6_of_jax(keying, start):
    cfg = hf_config(rope_scaling=SCALINGS["dynamic"],
                    max_position_embeddings=32)
    tcfg = tlt.LlamaConfig.from_hf(cfg, dtype=torch.float32)
    jcfg = jlt.LlamaConfig.from_hf(cfg, dtype=jnp.float32)
    pos = np.arange(start, start + 24, dtype=np.int32)
    seq = {"one-call": None, "scalar": start + 30, "rows": pos + 1}[keying]
    got = tllama.rope_rows_dynamic(
        tcfg, torch.from_numpy(pos),
        torch.from_numpy(seq) if isinstance(seq, np.ndarray) else seq)
    want = jllama.rope_rows_dynamic(
        jcfg, jnp.asarray(pos),
        jnp.asarray(seq) if isinstance(seq, np.ndarray) else seq)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_dynamic_rows_below_threshold_are_the_plain_tables():
    cfg = hf_config(rope_scaling=SCALINGS["dynamic"],
                    max_position_embeddings=32)
    tcfg = tlt.LlamaConfig.from_hf(cfg, dtype=torch.float32)
    plain = dataclasses.replace(tcfg, rope_scaling=None)
    cos_d, sin_d = tllama.rope_rows_dynamic(tcfg, torch.arange(16))
    cos_p, sin_p = tllama.rope_tables(plain, 16, "cpu")
    torch.testing.assert_close(cos_d, cos_p, atol=1e-6, rtol=0)
    torch.testing.assert_close(sin_d, sin_p, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# logits against HF and JAX
# --------------------------------------------------------------------------

def port_logits(tcfg, params, tokens, max_seq=128):
    """The port's forward over the whole sequence (causal, the plain
    attention), as one HF call: dynamic-NTK keyed on max(positions) + 1."""
    k, v = tllama.make_kv_cache(tcfg, max_seq, "cpu")
    cos, sin = tllama.rope_tables(tcfg, max_seq, "cpu")
    logits, _, _ = tllama.forward(
        params, tcfg, torch.as_tensor(tokens), torch.arange(len(tokens)),
        k, v, 0, cos, sin,
        dict(kv_len=torch.zeros(1, dtype=torch.int32), level=2, window=1,
             guess_size=1, causal=True,
             sliding_window=tcfg.sliding_window or 0))
    return logits.numpy()


def jax_logits(jcfg, params, tokens, max_seq=128):
    kc, vc = jllama.make_kv_cache(jcfg, max_seq)
    cos, sin = jllama.rope_tables(jcfg, max_seq)
    col = jnp.arange(max_seq)
    pos = jnp.arange(len(tokens), dtype=jnp.int32)
    vis = col[None, :] <= pos[:, None]
    if jcfg.sliding_window:
        vis &= col[None, :] > pos[:, None] - jcfg.sliding_window
    logits, _, _ = jllama.forward(
        params, jcfg, jnp.asarray(tokens, jnp.int32), pos, kc, vc,
        jnp.int32(0), jnp.where(vis, 0.0, NEG), cos, sin)
    return np.asarray(logits)


LOGIT_CASES = {
    "llama": (dict(), 17),
    "linear": (dict(rope_scaling=SCALINGS["linear"]), 11),
    "dynamic-11": (dict(rope_scaling=SCALINGS["dynamic"],
                        max_position_embeddings=32), 11),
    "dynamic-48": (dict(rope_scaling=SCALINGS["dynamic"],
                        max_position_embeddings=32), 48),
    "llama3": (dict(rope_scaling=LLAMA3_RS), 96),
    "yarn": (dict(rope_scaling=YARN_RS), 96),
    "mistral-beyond-window": (dict(family="mistral", sliding_window=8), 24),
    "qwen2": (dict(family="qwen2"), 13),
    "gemma": (dict(family="gemma", head_dim=32), 12),
}


@pytest.mark.parametrize("case", sorted(LOGIT_CASES))
def test_logits_match_hf_and_jax(case):
    kw, n = LOGIT_CASES[case]
    kw = dict(kw)
    hf = hf_model(kw.pop("family", "llama"), seed=len(case), **kw)
    tcfg, tparams = tlt.convert_hf_model(hf, dtype=torch.float32,
                                         device="cpu")
    jcfg, jparams = jlt.convert_hf_model(hf, dtype=jnp.float32)
    same_fields(tcfg, jcfg)
    tokens = np.random.RandomState(n).randint(0, 96, size=n)
    with torch.no_grad():
        ref = hf(torch.tensor(tokens)[None]).logits[0].numpy()
    got = port_logits(tcfg, tparams, tokens)
    np.testing.assert_allclose(got, ref, **HF_TOL)
    np.testing.assert_allclose(got, jax_logits(jcfg, jparams, tokens),
                               **JAX_TOL)


def test_converted_tree_equals_jax_tree():
    """convert_hf_model's tree: JAX's names, layouts (the transposes) and
    the Qwen2 biases, equal values, on the requested device and dtype."""
    hf = hf_model("qwen2", seed=5)
    tcfg, tparams = tlt.convert_hf_model(hf, dtype=torch.float32,
                                         device="cpu")
    _, jparams = jlt.convert_hf_model(hf, dtype=jnp.float32)
    jtree = jax.device_get(jparams)
    assert set(tparams) == set(jtree)
    assert set(tparams["layers"]) == set(jtree["layers"])
    assert {"bq", "bk", "bv"} <= set(tparams["layers"])
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(tparams[name].numpy(), jtree[name])
    for name, leaf in tparams["layers"].items():
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
        np.testing.assert_array_equal(leaf.numpy(), jtree["layers"][name])
    state = {k: v.detach().float().numpy()
             for k, v in hf.state_dict().items()}
    again = tlt.convert_hf_state_dict(state, tcfg, device="cpu")
    torch.testing.assert_close(again["layers"]["wq"],
                               tparams["layers"]["wq"], atol=0, rtol=0)


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------

LA = dict(level=4, window_size=4, guess_set_size=4, pool_from_prompt=True,
          window_init="order_copy_from")


def engine_pair(hf, max_seq=128):
    tcfg, tparams = tlt.convert_hf_model(hf, dtype=torch.float32,
                                         device="cpu")
    jcfg, jparams = jlt.convert_hf_model(hf, dtype=jnp.float32)
    ekw = dict(max_seq_len=max_seq, prefill_chunk=16)
    jeng = jlt.LookaheadEngine(jcfg, jparams, jlt.LookaheadConfig(**LA),
                               jlt.EngineConfig(dtype="float32", **ekw))
    teng = tlt.LookaheadEngine(tcfg, tparams, tlt.LookaheadConfig(**LA),
                               tlt.EngineConfig(**ekw), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("case", ["llama3", "dynamic"])
def test_engine_token_exact_against_baseline_and_jax(case):
    """llama3 rope past the original context; dynamic-NTK on a context that
    crosses max_position_embeddings (32) during the prompt and the decode.
    The port's generate equals its baseline and JAX's generate in tokens
    and steps."""
    if case == "llama3":
        hf = hf_model(rope_scaling=LLAMA3_RS, seed=6)
        p = np.random.RandomState(5).randint(0, 96, size=70)
    else:
        hf = hf_model(rope_scaling=SCALINGS["dynamic"],
                      max_position_embeddings=32, seed=7)
        p = np.random.RandomState(6).randint(0, 96, size=24)
    # a capacity above the runs' needs, so that the capacity stop (which
    # ends lookahead earlier than AR) binds neither
    jeng, teng = engine_pair(hf, max_seq=256)
    got = teng.generate(list(p), 40)
    want = jeng.generate(list(p), 40)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.steps == want.steps
    np.testing.assert_array_equal(teng.generate_baseline(list(p), 40).tokens,
                                  got.tokens)


def test_dynamic_generate_batch_equals_lone_calls():
    """generate_batch with dynamic-NTK rope (the paged step keys each row on
    its own position + 1): every lane equals its lone generate."""
    hf = hf_model(rope_scaling=SCALINGS["dynamic"],
                  max_position_embeddings=32, seed=8)
    _, teng = engine_pair(hf)
    rng = np.random.RandomState(9)
    ps = [list(rng.randint(0, 96, size=n)) for n in (24, 10, 31)]
    batch = teng.generate_batch(ps, 36)
    for p, r in zip(ps, batch):
        one = teng.generate(p, 36)
        np.testing.assert_array_equal(r.tokens, one.tokens)
        assert r.steps == one.steps


def dynamic_engines():
    hf = hf_model(rope_scaling=SCALINGS["dynamic"],
                  max_position_embeddings=32, seed=10)
    return engine_pair(hf)


def test_dynamic_prefix_refusals_carry_jax_message():
    jeng, teng = dynamic_engines()
    p = list(range(1, 20))
    with pytest.raises(ValueError) as want:
        jeng.precompute_prefix(p[:8])
    message = str(want.value)
    assert "dynamic-NTK" in message
    px = tlt.PrefixCache(tokens=np.asarray(p[:8], np.int32), k_cache=None,
                         v_cache=None, length=8)
    calls = {
        "precompute_prefix": lambda: teng.precompute_prefix(p[:8]),
        "generate(prefix)": lambda: teng.generate(p, 8, prefix=px),
        "generate(return_prefix)": lambda: teng.generate(
            p, 8, return_prefix=True),
        "generate_sample(prefix)": lambda: teng.generate_sample(
            p, 8, prefix=px),
        "generate_sample(return_prefix)": lambda: teng.generate_sample(
            p, 8, return_prefix=True),
        "generate_baseline(prefix)": lambda: teng.generate_baseline(
            p, 8, prefix=px),
        "generate_baseline(return_prefix)": lambda: teng.generate_baseline(
            p, 8, return_prefix=True),
        "generate_stream(prefix)": lambda: list(teng.generate_stream(
            p, 8, prefix=px)),
        "generate_stream(return_prefix)": lambda: list(teng.generate_stream(
            p, 8, return_prefix=True)),
        "generate_batch(prefix)": lambda: teng.generate_batch(
            [p, p], 8, prefix=px),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == message, name
    # without a prefix the dynamic engine runs every entry point
    assert teng.generate(p, 8).num_generated == 8


def test_paged_serving_still_refuses_dynamic_rope():
    hf = hf_model(rope_scaling=SCALINGS["dynamic"],
                  max_position_embeddings=32, seed=11)
    tcfg, tparams = tlt.convert_hf_model(hf, dtype=torch.float32,
                                         device="cpu")
    with pytest.raises(ValueError, match="dynamic-NTK"):
        tlt.PagedServingEngine(tcfg, tparams, tlt.LookaheadConfig(**LA),
                               tlt.EngineConfig(max_seq_len=128),
                               device="cpu")


def test_continuous_batching_with_dynamic_rope_equals_lone_calls():
    """The scheduler's lanes (the paged step) under dynamic-NTK rope."""
    _, teng = dynamic_engines()
    rng = np.random.RandomState(12)
    ps = [list(rng.randint(0, 96, size=n)) for n in (28, 9, 20)]
    res = {r.request_id: r for r in tlt.ContinuousBatchingEngine(
        teng, num_lanes=2).run([tlt.Request(prompt=p, max_new_tokens=30,
                                            request_id=i)
                                for i, p in enumerate(ps)])}
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(res[i].tokens,
                                      teng.generate(p, 30).tokens)
