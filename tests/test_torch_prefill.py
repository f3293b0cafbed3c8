"""The captured prefill on the CPU: the counterpart of the JAX engine's fused
prepare call (``jax.jit(self._make_fused(None))``: caches, window, pool
fill and the prefill ``fori_loop`` in one dispatch). On the card a flat
``_prepare``, with or without a prefix, is one launch of the slot's
prepare graph (``core/engine.py:_request_graph``: the prefill a WHILE
node of one chunk, its start read from device counters,
``core/step.py:prefill_chunk``); ``fused=False`` replays one captured
prefill chunk a chunk (``core/engine.py:_prefill``), and a whole
``generate_batch`` prepares its lanes inside its batch request graph.
Here the capture is
``torch_parallel_worker.faked_capture``'s (the warm run, a capture that
restores the slot, a replay that runs what the graph would), and every
graphed call is held against the same call inside ``graphs.eager()`` on
the same engine, bit for bit:

- ``_prepare`` at prompt lengths 1 (no chunk: the prefill loop runs no
  iteration), below the chunk C, C, C + 1 rows, a multiple of C and within
  a slot of the capacity: every tensor of the slot (caches, ``kv_len``,
  pool tables, window, output buffer, counters, the request's arguments)
  and its generator, then the tokens and steps of a ``generate``; the
  first graphed call captures the prepare graph, and every graphed call
  runs a prefill iteration a chunk;
- ``_prepare`` and the decode step's runner (its buffers written) read
  nothing back to the host, with a prompt, with a prefix carrying a warm
  pool (the fill merges into its rows), and on engines with an int8 KV
  cache, a sliding window and dynamic-NTK rope;
- every flat entry point that prepares a slot: a prefix
  (``start0 > 0``, the last chunk overlap-aligned), a second turn from a
  ``return_prefix`` result, a stream that runs on a second slot while the
  first is suspended, ``generate_batch``'s lanes, and engines with
  dynamic-NTK rope, an int8 KV cache and a sliding window: tokens, steps,
  every slot's tensors after the call and the prefix caches returned.

The device-start ``prefill_from`` is held against JAX's in
``tests/test_torch_engine.py``; the card runs the capture itself
(``chip_smoke.py`` phase 13, ``tests/test_torch_gpu.py``).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu_torch.core import graphs
from torch_parallel_worker import HostReads, _streams, faked_capture

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)
# S = 27 composite rows: a prompt of at most M - S + 1 = 102 tokens
LOOK = dict(level=4, window_size=5, guess_set_size=4, pool_from_prompt=True)
M, C, N_NEW = 128, 16, 12


@functools.lru_cache(maxsize=None)
def tree():
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    return jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                          scale=0.5))


def engine(kv_quant=None, **model):
    """A float32 engine on the CPU; made inside ``faked_capture`` it
    captures."""
    cfg = tlt.LlamaConfig(**dict(ARCH, **model), dtype=torch.float32)
    return tlt.LookaheadEngine(
        cfg, tlt.params_from_numpy(tree(), cfg, "cpu"),
        tlt.LookaheadConfig(**LOOK),
        tlt.EngineConfig(max_seq_len=M, prefill_chunk=C, kv_quant=kv_quant),
        device="cpu")


def prompt(seed, n):
    return list(np.random.RandomState(seed).randint(0, 128, size=n))


def chunks(prompt_len, start0=0):
    return -(-max(prompt_len - 1 - start0, 0) // C)


def prepared(eng, p):
    """Every tensor of the first slot (its stream's key and draw counter
    among them) after ``_prepare`` of ``p``."""
    out_buf, n, fill = eng._host_args(p, N_NEW)
    slot = eng._free_slot()
    with torch.inference_mode():
        eng._prepare(out_buf, n, 0, fill, slot=slot)
    return [t.clone() for t in graphs.state_tensors(slot)]


def bit_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def caches_and_slots(eng, caches):
    """``caches`` and every tensor of the engine's flat slots and lane
    slots, the pools' write-only trash rows apart (the warm step of a
    captured lookahead step runs the chain's body whatever its predicate,
    which writes them: ``test_torch_graphs.py``'s rule), and the batch
    request graph's own inputs and counters (a lane slot's uploaded
    ``args`` with its lanes' ``words``, its ``lane`` and ``prefills``),
    which only that graph writes."""
    pools = ([(s.state.pool, 0) for s in eng._slots]
             + [(s.states.pool, 1) for s in eng._lane_slots.values()])
    tables = {id(t) for pool, _ in pools for t in (pool.values, pool.age)}
    tables |= {id(t) for s in eng._lane_slots.values()
               for t in (s.args, s.words, s.lane, s.prefills)}
    out = [t for t in graphs.state_tensors((caches, eng._slots,
                                            eng._lane_slots))
           if id(t) not in tables]
    for pool, lane_axis in pools:
        out += [t[:, :-1] if lane_axis else t[:-1]
                for t in (pool.values, pool.age)]
    return out


def counted(fn):
    """(fn's result, graphs.stats of the call)."""
    graphs.reset_stats()
    out = fn()
    return out, graphs.read_stats()


@pytest.mark.parametrize("prompt_len", [1, 9, 16, 17, 18, 49, 101, 102],
                         ids=["one", "below_C", "C", "C_rows", "C_plus_1_rows",
                              "three_C_rows", "near_M", "at_M"])
def test_graphed_prepare_equals_eager(prompt_len):
    """The first slot after ``_prepare``, eager and graphed (the capturing
    call, then a replaying one), bit for bit; the first graphed call
    captures the slot's prepare graph, and each graphed call runs a
    prefill iteration a chunk (none for a prompt of one token); then
    ``generate``'s tokens and steps."""
    p = prompt(prompt_len, prompt_len)
    k = chunks(prompt_len)
    with faked_capture():
        eng = engine()
        with graphs.eager():
            want, st = counted(lambda: prepared(eng, p))
        assert st["captured"] == st["prefills"] == 0
        first, st1 = counted(lambda: prepared(eng, p))
        again, st2 = counted(lambda: prepared(eng, p))
        with graphs.eager():
            eager = eng.generate(p, N_NEW)
        graphed = eng.generate(p, N_NEW)
    assert bit_equal(first, want) and bit_equal(again, want)
    assert (st1["captured"], st1["prefills"]) == (1, k)
    assert (st2["captured"], st2["prefills"]) == (0, k)
    assert st1["replays"] == st2["replays"] == 0        # no decode step
    assert st1["requests"] == st2["requests"] == 1
    np.testing.assert_array_equal(graphed.tokens, eager.tokens)
    # near the capacity the capacity stop ends the run early
    assert graphed.steps == eager.steps


# (KV quantization, model settings, whether the prompt follows a warm prefix)
HOST_READS = {
    "prompt": (None, {}, False),
    "warm_prefix": (None, {}, True),
    "int8_kv": ("int8", {}, False),          # the quantizing cache write
    "sliding_window": (None, dict(sliding_window=48), False),
    "dynamic_ntk": (None, dict(max_position_embeddings=32,
                               rope_scaling=("dynamic", 2.0)), False),
}


@pytest.mark.parametrize("kind", list(HOST_READS))
def test_prepare_reads_nothing_back_to_the_host(kind):
    """From ``_prepare``'s start to the first decode replay no op reads a
    value back to the host (``item``, a data-dependent shape): the uploads,
    the resets or a prefix's copies, the window seeding, the fill (merged
    into a warm prefix's pool) and the prefill chunks (through the int8
    cache's quantizing write, a sliding window, dynamic-NTK rows), then
    the decode runner with the call's EOS ids and budget; on a warm
    engine, whose graphs are captured."""
    kv_quant, model, warm_prefix = HOST_READS[kind]
    p, pc = prompt(12, 50), None
    with faked_capture():
        eng = engine(kv_quant, **model)
        if warm_prefix:
            pc = eng.generate(p[:30], N_NEW, return_prefix=True).prefix
            p = list(pc.tokens) + p[30:]
        eng.generate(p, N_NEW, prefix=pc)
        out_buf, n, fill = eng._host_args(p, N_NEW, pc)
        slot = eng._free_slot()
        with torch.inference_mode(), HostReads() as mode:
            eng._prepare(out_buf, n, 0, fill, pc, slot=slot)
            eng._flat_runner(slot, "greedy", N_NEW, [3, 4])
    assert mode.seen == []


def _prefix_call(eng):
    p = prompt(3, 30)
    pc = eng.precompute_prefix(p[:20])
    r = eng.generate(p, N_NEW, prefix=pc)
    # the prefix's 20 rows, then rows [20, 29): start = min(20, 29 - 16)
    return [r], [pc.k_cache, pc.v_cache], chunks(21) + chunks(30, 20)


def _second_turn(eng):
    r1 = eng.generate(prompt(4, 20), N_NEW, return_prefix=True)
    turn2 = list(r1.tokens) + [5, 6]
    r2 = eng.generate(turn2, N_NEW, prefix=r1.prefix, return_prefix=True)
    return ([r1, r2], [r2.prefix.k_cache, r2.prefix.v_cache],
            chunks(20) + chunks(len(turn2), r1.prefix.length))


def _streams_call(eng):
    p, q = prompt(7, 35), prompt(8, 12)
    return _streams(eng, p, q), [], chunks(35) + chunks(12)


def _batch(eng):
    return (eng.generate_batch([prompt(5, 40), prompt(6, 9)], N_NEW), [],
            chunks(40) + chunks(9))


def _lone(seed, n, keep_prefix=True):
    def call(eng):
        r = eng.generate(prompt(seed, n), N_NEW, return_prefix=keep_prefix)
        return ([r], [r.prefix.k_cache, r.prefix.v_cache] if keep_prefix
                else [], chunks(n))
    return call


# (KV quantization, model settings, call -> (results, caches, chunks))
ENTRY = {
    "prefix": (None, {}, _prefix_call),
    "second_turn": (None, {}, _second_turn),
    "streams": (None, {}, _streams_call),
    "batch": (None, {}, _batch),
    # past max_position_embeddings 32: the rotation keyed on the prompt's
    # length, a device tensor in the captured chunk (no prefix reuse)
    "dynamic_ntk": (None, dict(max_position_embeddings=32,
                               rope_scaling=("dynamic", 2.0)),
                    _lone(9, 60, keep_prefix=False)),
    "int8_kv": ("int8", {}, _lone(10, 45)),
    "sliding_window": (None, dict(sliding_window=48), _lone(11, 100)),
}


@pytest.mark.parametrize("kind", list(ENTRY))
def test_graphed_entry_points_equal_eager(kind):
    """Each entry point eager, then graphed twice on one engine: tokens,
    steps, every slot's tensors after the call (the flat slots and the
    batch's lanes) and the prefix caches it returns, bit for bit; the
    graphed calls count a prefill iteration a chunk."""
    kv_quant, model, call = ENTRY[kind]
    runs = {}
    with faked_capture():
        eng = engine(kv_quant, **model)
        for which in ("eager", "first", "graphed"):
            mode = graphs.eager() if which == "eager" else \
                contextlib.nullcontext()
            with mode:
                (res, caches, k), st = counted(lambda: call(eng))
            runs[which] = ([(r.tokens.tolist(), r.steps) for r in res],
                           [t.clone() for t in caches_and_slots(eng, caches)],
                           st)
    eager = runs["eager"]
    assert eager[2]["prefills"] == eager[2]["captured"] == 0
    for which in ("first", "graphed"):
        got = runs[which]
        assert got[0] == eager[0], (kind, which)
        assert bit_equal(got[1], eager[1]), (kind, which)
    # every call, past a prefix too, counts every chunk of its request
    # graph's prefill, the capturing call's included
    assert runs["first"][2]["prefills"] == k
    assert runs["graphed"][2]["prefills"] == k
    assert runs["graphed"][2]["captured"] == 0
