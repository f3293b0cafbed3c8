"""The port's PagedServingEngine with quantized weights against the JAX
PagedServingEngine on the same quantized tree, and a differential fuzz
over random layouts against the port's own flat ``generate`` (which
test_torch_engine.py and test_torch_quant.py hold to the JAX engine).
CPU, float32; tokens and step counts must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu.core.serving import Request as JRequest

# tiny models gain nothing from intra-op threads, and several test workers
# each with a full thread pool contend for the same cores
torch.set_num_threads(1)

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)


def weights():
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    jparams = jlt.init_params(jcfg, jax.random.PRNGKey(0), scale=0.5)
    return jcfg, jparams, tlt.LlamaConfig(**ARCH, dtype=torch.float32)


@pytest.mark.parametrize("bits,fuse", [(8, False), (4, True)],
                         ids=["int8_weights", "int4_weights_fused"])
def test_quantized_weights_match_jax_paged_and_flat(bits, fuse):
    """The JAX-quantized tree (int8 LM head) carried into the port through
    ``params_from_numpy``, fused for int4: the paged engines agree, and the
    port's paged engine equals its flat engine."""
    jcfg, jparams, tcfg = weights()
    jq = jlt.quantize_params(jparams, bits=bits, quantize_lm_head=True,
                             lm_head_bits=8)
    tq = tlt.params_from_numpy(jax.device_get(jq), tcfg, "cpu")
    if fuse:
        from lookaheaddecoding_tpu.models.llama import fuse_params
        jq, tq = fuse_params(jq), tlt.fuse_params(tq)
    lkw = dict(level=4, window_size=5, guess_set_size=4,
               pool_from_prompt=True, window_init="order_copy_from")
    ekw = dict(max_seq_len=256, prefill_chunk=16, dtype="float32",
               kv_quant="int8" if bits == 8 else None)
    pkw = dict(num_lanes=2, page_size=32, steps_per_sync=2)
    jeng = jlt.PagedServingEngine(
        jcfg, jq, jlt.LookaheadConfig(attention_impl="xla", **lkw),
        jlt.EngineConfig(**ekw), **pkw)
    flat = tlt.LookaheadEngine(tcfg, tq, tlt.LookaheadConfig(**lkw),
                               tlt.EngineConfig(**ekw), device="cpu")
    paged = tlt.PagedServingEngine(tcfg, tq, tlt.LookaheadConfig(**lkw),
                                   tlt.EngineConfig(**ekw), device="cpu",
                                   **pkw)
    rng = np.random.RandomState(bits)
    reqs = [dict(prompt=list(rng.randint(0, 128, size=n)), max_new_tokens=24,
                 seed=i, request_id=i) for i, n in enumerate((12, 40, 7))]
    got = {r.request_id: r for r in paged.run(
        [tlt.Request(**kw) for kw in reqs])}
    want = {r.request_id: r for r in jeng.run(
        [JRequest(**kw) for kw in reqs])}
    for kw in reqs:
        i = kw["request_id"]
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
        assert got[i].steps == want[i].steps
        single = flat.generate(kw["prompt"], 24, seed=i)
        np.testing.assert_array_equal(got[i].tokens, single.tokens)
        assert got[i].steps == single.steps
    assert paged.alloc.used_pages == 0


@pytest.mark.parametrize("trial", range(8))
def test_config_fuzz_matches_flat(trial):
    """Random (layout, page size, lanes, steps between host reads, KV
    quantization, window seeding, key length, prompts, EOS): the paged
    scheduler reproduces the flat engine token for token and step for
    step, staggered EOS and capacity stops included, and returns every
    page."""
    rng = np.random.RandomState(100 + trial)
    level = int(rng.choice([3, 4, 5]))
    lkw = dict(level=level, window_size=int(rng.randint(2, 6)),
               guess_set_size=int(rng.randint(0, 5)),
               pool_from_prompt=bool(rng.randint(2)),
               window_init=str(rng.choice(["order_copy_from",
                                           "copy_from_last"])),
               pool_key_len=int(rng.choice([1, 2])), pool_hash_size=97)
    page = int(rng.choice([8, 24, 32, 64, 128]))
    lanes = int(rng.choice([1, 2, 3]))
    kv_quant = [None, "int8"][rng.randint(2)]
    max_seq = int(rng.choice([96, 256]))
    _, jparams, tcfg = weights()
    tparams = tlt.params_from_numpy(jax.device_get(jparams), tcfg, "cpu")
    ec = tlt.EngineConfig(max_seq_len=max_seq, prefill_chunk=16,
                          kv_quant=kv_quant)
    flat = tlt.LookaheadEngine(tcfg, tparams, tlt.LookaheadConfig(**lkw), ec,
                               device="cpu")
    paged = tlt.PagedServingEngine(
        tcfg, tparams, tlt.LookaheadConfig(**lkw), ec, num_lanes=lanes,
        page_size=page, steps_per_sync=int(rng.choice([1, 3])), device="cpu")
    reqs, singles = [], []
    for i in range(int(rng.randint(1, 6))):
        p = list(rng.randint(0, 128, size=int(rng.randint(3, 40))))
        n_new = int(rng.choice([rng.randint(1, 40), 500]))
        eos = int(rng.randint(0, 128)) if rng.randint(2) else None
        singles.append(flat.generate(p, n_new, eos_token_id=eos, seed=i))
        reqs.append(tlt.Request(prompt=p, max_new_tokens=n_new,
                                eos_token_id=eos, seed=i, request_id=i))
    by_id = {r.request_id: r for r in paged.run(reqs)}
    for i, s in enumerate(singles):
        assert by_id[i].error is None, by_id[i].error
        np.testing.assert_array_equal(
            by_id[i].tokens, s.tokens,
            err_msg=f"trial={trial} {lkw} page={page} lanes={lanes} "
                    f"kv={kv_quant} M={max_seq} req={i}")
        assert by_id[i].steps == s.steps
    assert paged.alloc.used_pages == 0
