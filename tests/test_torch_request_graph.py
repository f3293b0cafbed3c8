"""The request graph on the CPU: the counterpart of the JAX engine's one
traced call a request (``lookaheaddecoding_tpu/core/engine.py``
``_make_fused``: ``_fused_greedy``, ``_fused_baseline``, the fused sampling
loop and ``_fused_prepare``). On one card a flat ``generate``,
``generate_baseline`` or ``generate_sample`` without a prefix is one
launch of a ``graphs.RequestGraph``: the resets, the seeding, the fill, the
prefill as a WHILE node under a chunk count the device computes, and the
decode loop's WHILE node, over arguments uploaded into the slot first.
Here the capture is ``torch_parallel_worker.faked_capture``'s, whose WHILE
node runs its body while its flag is clear and fewer than ``cap``
iterations have run, and the engines compute in float32:

- the preparation that reads its arguments on the device against the same
  functions given host numbers (the path every call took before): the
  window seeding with a tensor bound (each ``window_init``), the fill with
  a tensor clock and int32 keys (replace and merge), the stream's start
  from key words, and the whole prepare graph with its device-counted
  prefill against the host-data preparation with the host's count of
  chunks, bit for bit in every tensor of the slot;
- whole calls against JAX's fused calls on the same weights
  (``params_from_numpy``) and prompts: tokens and steps equal, the pool's
  rows [0, R) and clock equal where the seeding draws nothing
  (``order_copy_from``, ``copy_from_last``), the caches' committed rows
  within float32 rounding (atol 1e-4, the device-loop tests'), with
  ``pool_key_len`` 1 and 2, ``pool_from_prompt`` on and off, and on int8-KV,
  sliding-window and dynamic-NTK engines; the sampling loop at a
  temperature of 1e-4, where both packages' draws pick the argmax;
- the request graph against ``graphs.eager()`` on one engine: tokens,
  steps and every slot tensor bit-equal, one launch a call, prefill
  iterations the host's chunk count (none for a one-token prompt), decode
  iterations the steps, and one read back a call.

Prompt lengths: 1, C - 1, C, C + 1, 3C + 5, and M - 2S + 1, whose first
step ends one composite step short of the capacity. The WHILE nodes
themselves run on the card: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phase 13.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu.core.engine import _eos_vec as jax_eos_vec
from lookaheaddecoding_tpu.core.step import build_step_fns as jax_step_fns
from lookaheaddecoding_tpu_torch.core import graphs
from lookaheaddecoding_tpu_torch.core.engine import _clear_cache
from lookaheaddecoding_tpu_torch.core.pool import (apply_host_fill,
                                                   host_prompt_fill,
                                                   pool_init, upload_fill)
from lookaheaddecoding_tpu_torch.core.step import seed_window
from lookaheaddecoding_tpu_torch.ops import philox
from torch_parallel_worker import HostReads, faked_capture

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)
LOOK = dict(level=4, window_size=5, guess_set_size=4, pool_from_prompt=True)
M, C, S = 128, 16, 27          # S: the composite step's rows at LOOK
NEW = 24
LENGTHS = {"one": 1, "C_minus_1": C - 1, "C": C, "C_plus_1": C + 1,
           "three_C_plus_5": 3 * C + 5, "one_step_short": M - 2 * S + 1}
SAMPLE = dict(temperature=1e-4)


def prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 128,
                                                                size=n)]


def chunks(n):
    return -(-max(n - 1, 0) // C)


@functools.lru_cache(maxsize=None)
def tree(model_kw=()):
    jcfg = jlt.LlamaConfig(**dict(ARCH, **dict(model_kw)), dtype=jnp.float32)
    return jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                          scale=0.5))


def port_engine(model_kw=(), kv_quant=None, **lkw):
    """A float32 engine on the CPU; made inside ``faked_capture`` it
    captures, and its calls without a prefix run as request graphs."""
    cfg = tlt.LlamaConfig(**dict(ARCH, **dict(model_kw)),
                          dtype=torch.float32)
    return tlt.LookaheadEngine(
        cfg, tlt.params_from_numpy(tree(model_kw), cfg, "cpu"),
        tlt.LookaheadConfig(**dict(LOOK, **lkw)),
        tlt.EngineConfig(max_seq_len=M, prefill_chunk=C, kv_quant=kv_quant),
        device="cpu")


@functools.lru_cache(maxsize=None)
def jax_engine(model_kw=(), kv_quant=None, lkw=()):
    return jlt.LookaheadEngine(
        jlt.LlamaConfig(**dict(ARCH, **dict(model_kw)), dtype=jnp.float32),
        tree(model_kw), jlt.LookaheadConfig(**dict(LOOK, **dict(lkw))),
        jlt.EngineConfig(max_seq_len=M, prefill_chunk=C, dtype="float32",
                         kv_quant=kv_quant))


def counted(fn):
    graphs.reset_stats()
    out = fn()
    return out, graphs.read_stats()


def slot_tensors(slot, tree=None):
    """Clones of every tensor of ``tree`` (by default the whole slot) but
    the caches' rows past the committed ones (never read: a host loop's
    step after ``finished`` may rewrite them) and the pool's write-only
    trash row."""
    st = slot.state
    kv = int(st.kv_len)
    caches = graphs.state_tensors((st.k_cache, st.v_cache))
    tables = {id(t) for t in caches} | {id(st.pool.values), id(st.pool.age)}
    out = [t for t in graphs.state_tensors(slot if tree is None else tree)
           if id(t) not in tables]
    out += [t[:, :, :kv] for t in caches]
    return [t.clone() for t in out + [st.pool.values[:-1],
                                      st.pool.age[:-1]]]


def bit_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# The preparation from device data against the same functions on host data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init", ["copy_from", "order_copy_from",
                                  "copy_from_last", "random_set"])
@pytest.mark.parametrize("name", ["one", "C_minus_1", "three_C_plus_5"])
def test_seed_window_takes_its_bound_from_the_device(init, name):
    """The window seeding with the prompt's length as a 0-d int32 tensor
    (a slot's, what a captured seeding reads) equals the seeding with the
    length as an integer, bit for bit, for each ``window_init``."""
    n = LENGTHS[name]
    lcfg = tlt.LookaheadConfig(**dict(LOOK, window_init=init))
    out_buf = torch.zeros(M + 3, dtype=torch.int32)
    out_buf[:n] = torch.tensor(prompt(n, n), dtype=torch.int32)
    key = torch.tensor(philox.seed_key(11 + n), dtype=torch.int32)
    draws = torch.zeros((), dtype=torch.int64)
    want = seed_window(lcfg, 128, 15, out_buf, key, draws, n)
    got = seed_window(lcfg, 128, 15, out_buf, key, draws,
                      torch.tensor(n, dtype=torch.int32))
    assert torch.equal(got.int(), want.int())
    if init != "random_set":
        assert set(got.tolist()) <= set(out_buf[:n].tolist())


@pytest.mark.parametrize("merge", [False, True], ids=["replace", "merge"])
@pytest.mark.parametrize("key_len", [1, 2])
def test_apply_host_fill_takes_its_clock_from_the_device(merge, key_len):
    """The pool fill with a 0-d int32 clock and int32 keys (a slot's
    arguments) equals the fill with an integer clock and int64 keys, bit
    for bit in every row and the clock, replacing rows of an empty pool or
    merging into a warm one."""
    rows = 128 if key_len == 1 else 512
    fill = host_prompt_fill(np.array(prompt(5, 60)), 4, 4, pad_to=M,
                            key_len=key_len, table_rows=rows)
    pools = []
    for device_data in (False, True):
        pool = pool_init(rows, 4, 3, "cpu")
        if merge:        # a warm pool, the same for both
            warm = host_prompt_fill(np.array(prompt(6, 40)), 4, 4, pad_to=M,
                                    key_len=key_len, table_rows=rows)
            apply_host_fill(pool, *upload_fill(*warm, "cpu"))
        keys, tups, ages, clock = upload_fill(*fill, "cpu")
        if device_data:
            keys = keys.int()
            clock = torch.tensor(clock, dtype=torch.int32)
        apply_host_fill(pool, keys, tups, ages, clock, merge=merge)
        pools.append([pool.values, pool.age, pool.clock])
    assert bit_equal(*pools)


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3, -1])
def test_philox_start_takes_the_key_words_from_the_device(seed):
    """A stream started from its seed's key words on the device equals one
    started from the integer seed: the key, the counter and a draw."""
    got, want = [], []
    for out, s in ((want, seed),
                   (got, torch.tensor(philox.seed_key(seed),
                                      dtype=torch.int32))):
        key = torch.full((2,), 5, dtype=torch.int32)
        draws = torch.full((), 9, dtype=torch.int64)
        philox.start(key, draws, s)
        out += [key, draws, philox.bits(key[None], draws.view(1), 8)]
    assert bit_equal(got, want)


def host_data_prepare(eng, slot, p, seed):
    """A request prepared as every call was before the request graph: the
    same functions given host numbers (the seed and the prompt's length as
    integers, the fill's clock as an integer and its keys int64) and the
    prefill by the host's count of chunks."""
    out_buf, n, fill = eng._host_args(p, NEW)
    st = slot.state
    with torch.inference_mode():
        _clear_cache(st.k_cache)
        _clear_cache(st.v_cache)
        st.pool.values.zero_()
        st.pool.age.zero_()
        st.pool.clock.fill_(1)
        philox.start(st.key, st.draws, seed)
        eng._fns.init_state(st, torch.from_numpy(out_buf), n)
        apply_host_fill(st.pool, *upload_fill(*fill, "cpu"))
        eng._prefill(slot, n, 0)


def prepared(slot):
    """The slot's state and its prefill counters (not its arguments, which
    the host-data path does not write), as :func:`slot_tensors` takes
    them."""
    return slot_tensors(slot, (slot.state, slot.start0, slot.chunk,
                               slot.chunks, slot.prefills))


@pytest.mark.parametrize("name", list(LENGTHS))
def test_device_counted_prepare_equals_the_host_data_path(name):
    """The prepare graph (captured, then replayed) against the host-data
    preparation on the same slot, bit for bit: the caches' committed rows,
    ``kv_len``, pool rows [0, R) and clock, window, output buffer,
    counters, stream, and the prefill's counters; the prefill ran the
    host's count of chunks as iterations of its WHILE node, whose cap the
    device computed (0 for a one-token prompt)."""
    n = LENGTHS[name]
    p = prompt(n, n)
    with faked_capture():
        eng = port_engine()
        slot = eng._free_slot()
        host_data_prepare(eng, slot, p, 3)
        want = prepared(slot)
        got = []
        for _ in range(2):
            out_buf, k, fill = eng._host_args(p, NEW)
            with torch.inference_mode():
                _, st = counted(lambda: eng._prepare(out_buf, k, 3, fill,
                                                     slot=slot))
            got.append((prepared(slot), st))
    for tensors, st in got:
        assert bit_equal(tensors, want)
        assert (st["requests"], st["prefills"], st["replays"]) == \
            (1, chunks(n), 0)
    assert int(slot.chunks) == int(slot.prefills) == chunks(n)
    assert got[0][1]["captured"] == 1 and got[1][1]["captured"] == 0


# ---------------------------------------------------------------------------
# Whole calls against JAX's fused calls
# ---------------------------------------------------------------------------

# config -> (model settings, KV quantization, lookahead settings, calls)
CONFIGS = {
    "base": ((), None, (("window_init", "order_copy_from"),),
             [(mode, name) for mode in ("greedy", "ar") for name in LENGTHS]
             + [("sample", "one"), ("sample", "three_C_plus_5")]),
    "bigram": ((), None, (("window_init", "copy_from_last"),
                          ("pool_key_len", 2)),
               [("greedy", "C_plus_1"), ("greedy", "three_C_plus_5")]),
    "no_fill": ((), None, (("window_init", "order_copy_from"),
                           ("pool_from_prompt", False)),
                [("greedy", "C"), ("ar", "three_C_plus_5")]),
    "int8_kv": ((), "int8", (("window_init", "order_copy_from"),),
                [("greedy", "three_C_plus_5")]),
    "sliding_window": ((("sliding_window", 48),), None,
                       (("window_init", "order_copy_from"),),
                       [("greedy", "one_step_short")]),
    "dynamic_ntk": ((("max_position_embeddings", 32),
                     ("rope_scaling", ("dynamic", 2.0))), None,
                    (("window_init", "order_copy_from"),),
                    [("greedy", "three_C_plus_5")]),
}
CASES = [(config, mode, name) for config, (_, _, _, calls) in CONFIGS.items()
         for mode, name in calls]


@functools.lru_cache(maxsize=None)
def jax_sample_loop(jeng):
    """JAX's fused sampling call (``generate_sample``'s, no prefix)."""
    sc = jlt.SamplingConfig(**SAMPLE)
    return jax.jit(jeng._make_fused(jax_step_fns(
        jeng.mcfg, jeng.lcfg, jeng.ecfg, jeng.layout, top_k=sc.top_k,
        use_top_p=sc.top_p < 1.0, mesh=jeng.mesh).sample_loop))


def jax_call(jeng, mode, p):
    """JAX's fused call of ``mode`` on ``p`` (seed 0, no EOS id): its
    result and final state."""
    if mode == "sample":
        sc = jlt.SamplingConfig(**SAMPLE)
        fused = jax_sample_loop(jeng)
        extra = (jnp.float32(sc.temperature), jnp.float32(sc.top_p))
    else:
        fused = jeng._fused_greedy if mode == "greedy" else \
            jeng._fused_baseline
        extra = ()
    state = jeng._run_fused(fused, p, 0, NEW, jax_eos_vec(None), *extra)
    return jeng._finalize(state, NEW, 0.0), state


@pytest.mark.parametrize("config,mode,name", CASES,
                         ids=["-".join(c) for c in CASES])
def test_request_graph_equals_jax_fused_call(config, mode, name):
    """A call through the request graph (captured, then replayed) against
    JAX's fused call: tokens and steps equal, the pool's rows [0, R) and
    clock equal (the seedings here draw nothing), and the committed cache
    rows within float32 rounding (a plain cache: an int8 cache's bytes may
    round apart); one launch, its prefill iterations the chunks."""
    model_kw, kv_quant, lkw, _ = CONFIGS[config]
    n = LENGTHS[name]
    p = prompt(n + 100, n)
    jres, jstate = jax_call(jax_engine(model_kw, kv_quant, lkw), mode, p)
    call = {"greedy": lambda e: e.generate(p, NEW),
            "ar": lambda e: e.generate_baseline(p, NEW),
            "sample": lambda e: e.generate_sample(
                p, NEW, tlt.SamplingConfig(**SAMPLE))}[mode]
    with faked_capture():
        eng = port_engine(model_kw, kv_quant, **dict(lkw))
        runs = [counted(lambda: call(eng)) for _ in range(2)]
    st = eng._slots[0].state
    for res, stats in runs:
        np.testing.assert_array_equal(res.tokens, np.asarray(jres.tokens))
        assert res.steps == jres.steps
        assert (stats["requests"], stats["prefills"], stats["replays"]) == \
            (1, chunks(n), res.steps)
    for got, want in ((st.pool.values, jstate.pool.values),
                      (st.pool.age, jstate.pool.age)):
        np.testing.assert_array_equal(got[:-1].numpy(),
                                      np.asarray(want)[:-1])
    assert int(st.pool.clock) == int(jstate.pool.clock)
    assert int(st.kv_len) == int(jstate.kv_len)
    if kv_quant is None:
        kv = int(st.kv_len)
        for got, want in ((st.k_cache, jstate.k_cache),
                          (st.v_cache, jstate.v_cache)):
            np.testing.assert_allclose(got[:, :, :kv].numpy(),
                                       np.asarray(want)[:, :, :kv],
                                       atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The request graph against graphs.eager()
# ---------------------------------------------------------------------------

def calls(mode, p, eos=None):
    sc = tlt.SamplingConfig(temperature=0.9, top_k=20, top_p=0.9)
    return {"greedy": lambda e: e.generate(p, NEW, eos_token_id=eos,
                                           seed=4),
            "ar": lambda e: e.generate_baseline(p, NEW, eos_token_id=eos),
            "sample": lambda e: e.generate_sample(p, NEW, sc,
                                                  eos_token_id=eos,
                                                  seed=4)}[mode]


EAGER = [(mode, name) for mode in ("greedy", "sample") for name in LENGTHS] \
    + [("ar", name) for name in ("one", "C_plus_1", "one_step_short")]


@pytest.mark.parametrize("mode,name", EAGER, ids=["-".join(c) for c in EAGER])
def test_request_graph_equals_eager(mode, name):
    """One engine (``copy_from`` seeding: the window draws from the
    stream): the call eagerly, then through its request graph twice
    (capturing, replaying): tokens, steps and every tensor of the slot
    bit-equal; a graphed call is one launch, whose prefill ran the host's
    chunk count (none for a one-token prompt) and whose decode loop ran an
    iteration a step; the replaying call reads the device once, after the
    launch."""
    n = LENGTHS[name]
    p = prompt(n + 200, n)
    call = calls(mode, p)
    with faked_capture():
        eng = port_engine()
        slot = eng._free_slot()
        with graphs.eager():
            (want, st0) = counted(lambda: call(eng))
        eager = slot_tensors(slot)
        runs = []
        for _ in range(2):
            res, st = counted(lambda: call(eng))
            runs.append((res, st, slot_tensors(slot)))
        with HostReads() as reads:
            call(eng)
    assert st0["requests"] == st0["loops"] == st0["captured"] == 0
    for res, st, tensors in runs:
        np.testing.assert_array_equal(res.tokens, want.tokens)
        assert res.steps == want.steps
        assert bit_equal(tensors, eager)
        assert (st["requests"], st["loops"], st["prefills"],
                st["replays"]) == (1, 1, chunks(n), res.steps)
    assert runs[0][1]["captured"] == 1 and runs[1][1]["captured"] == 0
    assert reads.seen == ["fetch"]


def test_an_eos_ended_request_stops_at_its_step():
    """An EOS id that the greedy run emits at its 6th new position ends the
    graphed call there, as eagerly: tokens and steps equal, the decode
    loop's iterations the steps taken."""
    p = prompt(9, 30)
    with faked_capture():
        eng = port_engine()
        full = eng.generate(p, NEW)
        eos = int(full.tokens[len(p) + 5])
        with graphs.eager():
            want = calls("greedy", p, eos)(eng)
        got, st = counted(lambda: calls("greedy", p, eos)(eng))
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens[-1] == eos and len(got.tokens) <= len(p) + 6
    assert st["replays"] == got.steps == want.steps


def test_a_prefill_count_that_disagrees_with_the_host_raises():
    """The call's one read brings the prefill's iterations back, and the
    call refuses a count other than the host's: a prefill WHILE node that
    ran one chunk too few raises."""
    p = prompt(3, 3 * C + 5)
    with faked_capture():
        eng = port_engine()
        eng.generate(p, NEW)
        real = eng._fns.prefill_from

        def short(params, state, counters, run):
            def fewer():
                run()
                eng._slots[0].prefills.sub_(1)
            return real(params, state, counters, fewer)
        eng._fns = eng._fns._replace(prefill_from=short)
        eng._slots[0].graphs.clear()
        with pytest.raises(RuntimeError, match="prefill ran 3 chunks where "
                                               "the prompt has 4"):
            eng.generate(p, NEW)


def test_calls_with_a_prefix_or_the_host_loop_keep_their_path():
    """A prefix call is one launch of its request graph (the prefix copied
    in from the engine's prefix source, the prefill from the prefix's
    length: the chunks past it), and a host-loop call
    (``host_loop=True``) still prepares op by op and launches none; each
    equals the request graph's tokens without the prefix."""
    p = prompt(4, 40)
    with faked_capture():
        eng = port_engine()
        fused = eng.generate(p, NEW)
        pc = eng.precompute_prefix(p[:20])
        (with_prefix, st1) = counted(lambda: eng.generate(p, NEW, prefix=pc))
        (host, st2) = counted(lambda: eng._run("greedy", p, NEW, None, 0,
                                               host_loop=True))
    for res in (with_prefix, host):
        np.testing.assert_array_equal(res.tokens, fused.tokens)
    assert (st1["requests"], st1["loops"], st1["prefills"]) == \
        (1, 1, chunks(len(p) - 20))
    assert st2["requests"] == st2["loops"] == 0
