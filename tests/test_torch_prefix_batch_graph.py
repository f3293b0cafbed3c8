"""The prefix and batch request graphs on the CPU: the counterparts of the
JAX engine's one traced call with a prefix
(``lookaheaddecoding_tpu/core/engine.py`` ``_make_fused_prefix``, jitted
by ``_fused_with_prefix``) and of a whole ``generate_batch`` (``bcall`` /
``bcall_px``: a vmapped prepare, then the vmapped loop, in one ``jit``).
On one card a flat call with ``prefix=`` is one launch of a
``graphs.RequestGraph`` that copies the prefix from the engine's prefix
source (filled by the host, device to device, before the launch) and
prefills from the ``start0`` among the request's arguments; a whole
``generate_batch`` is one launch of a graph whose WHILE node over the lanes
prepares each lane (its prefill's WHILE node nested) and copies it into
its page, then runs the lanes' decode loop. Here the capture is
``torch_parallel_worker.faked_capture``'s, whose WHILE node runs its body
while its flag is clear and fewer than ``cap`` iterations have run (a
nested one inside its parent's pass), and the engines compute in float32:

- prefix calls against JAX's prefix calls on the same weights
  (``params_from_numpy``) and prompts, on ``precompute_prefix`` prefixes
  and on ``return_prefix`` prefixes with their warm pools, for
  ``generate``, ``generate_baseline`` and ``generate_sample`` at a
  temperature of 1e-4 (both packages' draws pick the argmax): tokens and
  steps equal, the pool's rows [0, R) and clock equal (``order_copy_from``
  seeding draws nothing), the caches' committed rows within atol and
  rtol 1e-4;
  suffixes of 1 (no chunk), C - 1, C + 1 and 3C + 5 tokens;
- the prefix graph against ``graphs.eager()`` and ``fused=False`` on one
  engine: every slot tensor bit-equal, one launch, the prefill's
  iterations the host's chunk count past the prefix, the decode loop's the
  steps, one read; a three-turn conversation chained by ``return_prefix``
  equal to the eager chain;
- the batch graph against JAX's ``generate_batch`` (B = 1 and 3, prompts
  of different lengths, greedy and sampled at per-lane temperatures near
  1e-4, with and without a shared prefix), then against eager and
  ``host_loop=True`` on one engine: every lane tensor bit-equal, one
  launch, one read, decode iterations the slowest lane's steps, each
  lane's prefill iterations its own chunk count, the kernels' launches
  (the attention's plain versions, counted) those of the eager call, and
  the WHILE condition kernel's those the graph's loops account for;
- a prefill count that disagrees with the host's raises, for a prefix
  call and for a batch.

The nested WHILE node itself runs on the card: ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` phase 13.
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
from lookaheaddecoding_tpu_torch.ops import graph_cond, lookahead_attention
from torch_parallel_worker import HostReads, faked_capture

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)
LOOK = dict(level=4, window_size=5, guess_set_size=4, pool_from_prompt=True,
            window_init="order_copy_from")
M, C = 128, 16
NEW = 24
P0 = 20                         # the precomputed prefix's length
SUFFIXES = {"one": 1, "C_minus_1": C - 1, "C_plus_1": C + 1,
            "three_C_plus_5": 3 * C + 5}


def prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 128,
                                                                size=n)]


def chunks(n, start0=0):
    return -(-max(n - 1 - start0, 0) // C)


@functools.lru_cache(maxsize=None)
def tree():
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    return jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                          scale=0.5))


def port_engine(**lkw):
    """A float32 engine on the CPU; made inside ``faked_capture`` it
    captures, and its calls run as request graphs."""
    cfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    return tlt.LookaheadEngine(
        cfg, tlt.params_from_numpy(tree(), cfg, "cpu"),
        tlt.LookaheadConfig(**dict(LOOK, **lkw)),
        tlt.EngineConfig(max_seq_len=M, prefill_chunk=C), device="cpu")


@functools.lru_cache(maxsize=None)
def jax_engine():
    return jlt.LookaheadEngine(
        jlt.LlamaConfig(**ARCH, dtype=jnp.float32), tree(),
        jlt.LookaheadConfig(**LOOK),
        jlt.EngineConfig(max_seq_len=M, prefill_chunk=C, dtype="float32"))


def counted(fn):
    graphs.reset_stats()
    out = fn()
    return out, graphs.read_stats()


def bit_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def slot_tensors(slot):
    """Clones of every tensor of the slot but the caches' rows past the
    committed ones (never read: a host loop's step after ``finished`` may
    rewrite them) and the pool's write-only trash row."""
    st = slot.state
    kv = int(st.kv_len)
    caches = graphs.state_tensors((st.k_cache, st.v_cache))
    tables = {id(t) for t in caches} | {id(st.pool.values), id(st.pool.age)}
    out = [t for t in graphs.state_tensors(slot) if id(t) not in tables]
    out += [t[:, :, :kv] for t in caches]
    return [t.clone() for t in out + [st.pool.values[:-1],
                                      st.pool.age[:-1]]]


def lane_tensors(lanes):
    """Clones of every lane's state in a LaneSlot: each lane's committed
    cache rows, its bookkeeping, pool rows [0, R) and clock, stream, and
    the call's values (the args and the lane graph's counters apart,
    which only the graph writes)."""
    st = lanes.states
    out = []
    for b, kv in enumerate(st.kv_len.tolist()):
        for t in graphs.state_tensors((lanes.k_pool, lanes.v_pool)):
            out.append(t[:, :, b * M:b * M + kv])
    out += [st.kv_len, st.window, st.out_buf, st.n_confirmed, st.init_len,
            st.step_idx, st.finished, st.key, st.draws, st.pool.values[:, :-1],
            st.pool.age[:, :-1], st.pool.clock, lanes.max_new, lanes.eos,
            lanes.temperature]
    return [t.clone() for t in out]


# ---------------------------------------------------------------------------
# Prefix calls against JAX's prefix calls
# ---------------------------------------------------------------------------

SAMPLE = dict(temperature=1e-4)
FIRST = prompt(1, 12)           # the warm prefix's first turn, 16 new tokens


@functools.lru_cache(maxsize=None)
def jax_prefix(kind):
    jeng = jax_engine()
    if kind == "precomputed":
        return jeng.precompute_prefix(prompt(0, P0))
    return jeng.generate(FIRST, 16, return_prefix=True).prefix


def port_prefix(eng, kind):
    if kind == "precomputed":
        return eng.precompute_prefix(prompt(0, P0))
    return eng.generate(FIRST, 16, return_prefix=True).prefix


def jax_prefix_call(mode, p, prefix):
    """JAX's prefix call (``_make_fused_prefix``) of ``mode``: its result
    and final state."""
    jeng = jax_engine()
    eos = jax_eos_vec(None)
    if mode == "sample":
        sc = jlt.SamplingConfig(**SAMPLE)
        key = (sc.top_k, sc.top_p < 1.0)
        fused = jeng._fused_with_prefix(("sample",) + key, lambda: (
            jax_step_fns(jeng.mcfg, jeng.lcfg, jeng.ecfg, jeng.layout,
                         top_k=sc.top_k, use_top_p=key[1]).sample_loop))
        extra = (jnp.float32(sc.temperature), jnp.float32(sc.top_p))
    else:
        fused = jeng._fused_with_prefix(mode, lambda: (
            jeng._fns.decode_loop if mode == "greedy"
            else jeng._fns.baseline_loop))
        extra = ()
    state = jeng._run_fused(fused, p, 0, NEW, eos, *extra, prefix=prefix)
    return jeng._finalize(state, NEW, 0.0), state


# greedy at every suffix, the others at two, each on both prefix kinds
PREFIX_CASES = [(mode, kind, name)
                for mode, names in (("greedy", list(SUFFIXES)),
                                    ("baseline", ["one", "three_C_plus_5"]),
                                    ("sample", ["C_minus_1", "C_plus_1"]))
                for kind in ("precomputed", "warm") for name in names]


def port_call(eng, mode, p, prefix, **kw):
    if mode == "sample":
        return eng.generate_sample(p, NEW, tlt.SamplingConfig(**SAMPLE),
                                   prefix=prefix, **kw)
    if mode == "baseline":
        return eng.generate_baseline(p, NEW, prefix=prefix, **kw)
    return eng.generate(p, NEW, prefix=prefix, **kw)


@pytest.mark.parametrize("mode,kind,name", PREFIX_CASES,
                         ids=["-".join(c) for c in PREFIX_CASES])
def test_prefix_graph_equals_jax_prefix_call(mode, kind, name):
    """A prefix call through its request graph (captured, then replayed)
    against JAX's ``_make_fused_prefix`` call past the same prefix: tokens
    and steps equal, the pool's rows [0, R) and clock equal, the committed
    cache rows within float32 rounding (atol and rtol 1e-4, the tolerance
    of ``tests/test_torch_engine.py``'s chunked prefill from a start row:
    a warm prefix's rows are each package's own first turn, so the
    suffix's second-layer K/V sum slightly different inputs); one launch
    whose prefill ran the chunks past the prefix (none for a one-token
    suffix)."""
    jpc = jax_prefix(kind)
    p = list(np.asarray(jpc.tokens)) + prompt(7 + SUFFIXES[name],
                                              SUFFIXES[name])
    jres, jstate = jax_prefix_call(mode, p, jpc)
    with faked_capture():
        eng = port_engine()
        pc = port_prefix(eng, kind)
        np.testing.assert_array_equal(pc.tokens, np.asarray(jpc.tokens))
        assert (kind == "warm") == (pc.pool is not None)
        runs = [counted(lambda: port_call(eng, mode, p, pc))
                for _ in range(2)]
    st = eng._slots[0].state
    k = chunks(len(p), pc.length)
    assert k == {"one": 0, "C_minus_1": 1, "C_plus_1": 1,
                 "three_C_plus_5": 4}[name]
    for res, stats in runs:
        np.testing.assert_array_equal(res.tokens, np.asarray(jres.tokens))
        assert res.steps == jres.steps
        assert (stats["requests"], stats["prefills"], stats["replays"]) == \
            (1, k, res.steps)
    assert runs[1][1]["captured"] == 0
    for got, want in ((st.pool.values, jstate.pool.values),
                      (st.pool.age, jstate.pool.age)):
        np.testing.assert_array_equal(got[:-1].numpy(),
                                      np.asarray(want)[:-1])
    assert int(st.pool.clock) == int(jstate.pool.clock)
    kv = int(st.kv_len)
    assert kv == int(jstate.kv_len)
    for got, want in ((st.k_cache, jstate.k_cache),
                      (st.v_cache, jstate.v_cache)):
        np.testing.assert_allclose(got[:, :, :kv].numpy(),
                                   np.asarray(want)[:, :, :kv], atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# The prefix graph against graphs.eager() and fused=False
# ---------------------------------------------------------------------------

EAGER_CASES = [("greedy", "precomputed", "C_minus_1"),
               ("greedy", "warm", "three_C_plus_5"),
               ("baseline", "warm", "one"),
               ("sample", "precomputed", "C_plus_1")]


@pytest.mark.parametrize("mode,kind,name", EAGER_CASES,
                         ids=["-".join(c) for c in EAGER_CASES])
def test_prefix_graph_equals_eager_and_todays_path(mode, kind, name):
    """One engine (``copy_from`` seeding: the window draws from the
    stream; a sampled call at T 0.9 with top-k and top-p): a prefix call
    eagerly, by today's path (``fused=False``: the preparation op by op,
    the prefill's chunk graph replayed a chunk, the decode loop's graph)
    and through its request graph twice (capturing, replaying): tokens,
    steps and every slot tensor bit-equal, the prefix's own tensors
    unwritten; the graphed call is one launch whose prefill ran the chunks
    past the prefix and whose decode loop an iteration a step, and reads
    the device once."""
    sc = tlt.SamplingConfig(temperature=0.9, top_k=20, top_p=0.9)
    modes = {"greedy": "greedy", "baseline": "ar", "sample": "sample"}
    with faked_capture():
        eng = port_engine(window_init="copy_from")
        pc = port_prefix(eng, kind)
        kept = [t.clone() for t in graphs.state_tensors(pc)]
        p = list(pc.tokens) + prompt(9 + SUFFIXES[name], SUFFIXES[name])
        slot = eng._free_slot()

        def call(fused=True):
            return eng._run(modes[mode], p, NEW, None, 4, prefix=pc,
                            sampling=sc if mode == "sample" else None,
                            fused=fused)
        with graphs.eager():
            want, st0 = counted(call)
        eager = slot_tensors(slot)
        call(False)                       # captures the prefill chunk
        today, st1 = counted(lambda: call(False))
        today_tensors = slot_tensors(slot)
        runs = []
        for _ in range(2):
            res, st = counted(call)
            runs.append((res, st, slot_tensors(slot)))
        with HostReads() as reads:
            call()
    assert st0["requests"] == st1["requests"] == 0
    assert (st1["loops"], st1["prefills"]) == (1, chunks(len(p), pc.length))
    assert bit_equal(today_tensors, eager)
    np.testing.assert_array_equal(today.tokens, want.tokens)
    for res, st, tensors in runs:
        np.testing.assert_array_equal(res.tokens, want.tokens)
        assert res.steps == want.steps == today.steps
        assert bit_equal(tensors, eager)
        assert (st["requests"], st["loops"], st["prefills"],
                st["replays"]) == (1, 1, chunks(len(p), pc.length),
                                   res.steps)
    assert runs[0][1]["captured"] == 1 and runs[1][1]["captured"] == 0
    assert reads.seen == ["fetch"]
    assert bit_equal(graphs.state_tensors(pc), kept)


def test_a_conversation_chained_by_return_prefix_equals_the_eager_chain():
    """Three turns, each prompt the last result's tokens plus a new
    message and each call on the last result's ``return_prefix`` (a new
    PrefixCache with its warm pool every turn, one graph for them all):
    tokens, steps, the returned prefixes and the slot bit-equal to the same
    chain run eagerly; each graphed turn after the first is one launch."""
    def chain(eng):
        out, prefix, p = [], None, prompt(2, 14)
        for turn in range(3):
            res = eng.generate(p, 16, prefix=prefix, return_prefix=True)
            out.append((res, slot_tensors(eng._slots[0])))
            prefix = res.prefix
            p = list(res.tokens) + prompt(30 + turn, 5 + 4 * turn)
        return out
    with faked_capture():
        eng = port_engine(window_init="copy_from")
        with graphs.eager():
            want = chain(eng)
        got, st = counted(lambda: chain(eng))
    for (a, ta), (b, tb) in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.steps == b.steps and a.prefix.length == b.prefix.length
        assert bit_equal(ta, tb)
        assert bit_equal(graphs.state_tensors(a.prefix),
                         graphs.state_tensors(b.prefix))
    assert st["requests"] == 3 and st["loops"] == 3
    # turn 1 has no prefix, turns 2 and 3 share the warm-pool prefix graph
    assert st["captured"] == 2


def test_prepare_with_a_prefix_is_one_launch_without_a_read():
    """``_prepare`` with a prefix (what ``generate_stream`` and the
    scheduler's admission call) is one launch of the slot's prepare graph
    and reads nothing back; a stream past the prefix equals the eager
    stream."""
    with faked_capture():
        eng = port_engine()
        pc = eng.precompute_prefix(prompt(0, P0))
        p = list(pc.tokens) + prompt(3, 21)
        out_buf, n, fill = eng._host_args(p, NEW, pc)
        slot = eng._free_slot()
        with graphs.eager(), torch.inference_mode():
            eng._prepare(out_buf, n, 0, fill, pc, slot=slot)
        want = slot_tensors(slot)
        with torch.inference_mode():
            eng._prepare(out_buf, n, 0, fill, pc, slot=slot)   # captures
        graphs.reset_stats()
        with HostReads() as reads, torch.inference_mode():
            eng._prepare(out_buf, n, 0, fill, pc, slot=slot)
        st = graphs.read_stats()
        got = slot_tensors(slot)
        with graphs.eager():
            stream = list(eng.generate_stream(p, NEW, prefix=pc))
        streamed = list(eng.generate_stream(p, NEW, prefix=pc))
    assert bit_equal(got, want)
    assert reads.seen == []
    assert (st["requests"], st["prefills"], st["captured"]) == \
        (1, chunks(n, P0), 0)
    np.testing.assert_array_equal(np.concatenate(streamed),
                                  np.concatenate(stream))


# ---------------------------------------------------------------------------
# The batch graph against JAX's generate_batch and against eager
# ---------------------------------------------------------------------------

# the lanes' prompt lengths past the prefix: 2, 0 and 3 prefill chunks
# (2, 0 and 3 without one too)
BATCHES = {1: [31], 3: [31, 1, 40]}
LANE_TEMPS = [1e-4, 2e-4, 5e-5]
BATCH_NEW = 16
# (lanes, sampled, with a prefix): each of B, sampling and the prefix
# both ways
BATCH_CASES = [(1, False, False), (3, False, True), (3, True, False),
               (1, True, True)]


def batch_prompts(B, prefix_tokens=None):
    head = [] if prefix_tokens is None else list(prefix_tokens)
    return [head + prompt(40 + i, n) for i, n in enumerate(BATCHES[B])]


def batch_kwargs(B, sampled, tlt_or_jlt):
    if not sampled:
        return {}
    return dict(sampling=tlt_or_jlt.SamplingConfig(**SAMPLE),
                temperatures=LANE_TEMPS[:B], seeds=[5 + i for i in range(B)])


@pytest.mark.parametrize("B,sampled,with_prefix", BATCH_CASES,
                         ids=[f"B{b}-{'sampled' if s else 'greedy'}-"
                              f"{'prefix' if p else 'no_prefix'}"
                              for b, s, p in BATCH_CASES])
def test_batch_graph_equals_jax_generate_batch(B, sampled, with_prefix):
    """A whole ``generate_batch`` through its batch graph (captured, then
    replayed) against JAX's ``generate_batch`` (``bcall``, or ``bcall_px``
    past a shared ``precompute_prefix``): every lane's tokens and steps
    equal, and each lane of a sampled batch equals its lone
    ``generate_sample``; one launch, one decode loop whose iterations are
    the slowest lane's steps, the prefill's iterations every lane's
    chunks."""
    jeng = jax_engine()
    jpc = jax_prefix("precomputed") if with_prefix else None
    prompts = batch_prompts(B, None if jpc is None else jpc.tokens)
    want = jeng.generate_batch(prompts, BATCH_NEW, prefix=jpc,
                               **batch_kwargs(B, sampled, jlt))
    with faked_capture():
        eng = port_engine()
        pc = port_prefix(eng, "precomputed") if with_prefix else None
        kw = batch_kwargs(B, sampled, tlt)
        runs = [counted(lambda: eng.generate_batch(
            prompts, BATCH_NEW, prefix=pc, **kw)) for _ in range(2)]
        lone = [eng.generate_sample(
            p, BATCH_NEW, tlt.SamplingConfig(temperature=t), seed=s,
            prefix=pc)
            for p, t, s in zip(prompts, kw.get("temperatures", []),
                               kw.get("seeds", []))]
    start0 = 0 if pc is None else pc.length
    for got, stats in runs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
            assert g.steps == w.steps
        assert (stats["requests"], stats["loops"], stats["replays"],
                stats["prefills"]) == (
            1, 1, max(r.steps for r in got),
            sum(chunks(len(p), start0) for p in prompts))
    assert runs[0][1]["captured"] == 1 and runs[1][1]["captured"] == 0
    for g, one in zip(runs[1][0], lone):
        np.testing.assert_array_equal(g.tokens, one.tokens)
        assert g.steps == one.steps


def tallies():
    return [dict(t) for t in graphs._TALLIES]


def moved(before, after):
    return [{k: a[k] - b[k] for k in a if a[k] != b[k]}
            for a, b in zip(after, before)]


@pytest.mark.parametrize("B,sampled,with_prefix", BATCH_CASES[1:],
                         ids=[f"B{b}-{'sampled' if s else 'greedy'}-"
                              f"{'prefix' if p else 'no_prefix'}"
                              for b, s, p in BATCH_CASES[1:]])
def test_batch_graph_equals_eager_and_the_host_loop(B, sampled, with_prefix):
    """One engine (``copy_from`` seeding, the attention through its
    wrappers' plain versions, so that their launches count; a sampled
    batch at T 0.9 with top-k and top-p and per-lane temperatures): a
    ``generate_batch`` eagerly, by the host loop (``host_loop=True``) and
    through its batch graph twice: every lane's tokens, steps and tensors
    bit-equal; the graphed call is one launch, whose lane loop prepared
    each lane with its own chunk count (``lanes.prefills``) and whose
    decode loop ran the slowest lane's steps, and reads the device once;
    its kernels' launches are the eager call's, and the WHILE condition
    kernel ran once before each of its loops and once an iteration."""
    sc = tlt.SamplingConfig(temperature=0.9, top_k=20, top_p=0.9)
    with faked_capture():
        eng = port_engine(window_init="copy_from", attention_impl="kernel")
        pc = eng.precompute_prefix(prompt(0, P0)) if with_prefix else None
        prompts = batch_prompts(B, None if pc is None else pc.tokens)
        kw = dict(sampling=sc, temperatures=[0.7, 1.0, 1.2][:B],
                  seeds=[5, 6, 7][:B]) if sampled else {}

        def call(host_loop=False):
            return eng._batch(prompts, BATCH_NEW, None, 0, kw.get("seeds"),
                              pc, kw.get("sampling"), kw.get("temperatures"),
                              None, host_loop=host_loop)
        lanes = None
        with graphs.eager():
            before = tallies()
            want, st0 = counted(call)
            eager_counts = moved(before, tallies())
            lanes = eng._lane_slots[B]
            eager = lane_tensors(lanes)
        host, st1 = counted(lambda: call(True))
        host_tensors = lane_tensors(lanes)
        call()                                        # captures
        before = tallies()
        got, st = counted(call)
        graph_counts = moved(before, tallies())
        got_tensors = lane_tensors(lanes)
        prefills = lanes.prefills.tolist()
        with HostReads() as reads:
            call()
    start0 = 0 if pc is None else pc.length
    want_chunks = [chunks(len(p), start0) for p in prompts]
    # the host loop prepares each lane by its own prepare graph, and op by
    # op past a prefix
    assert (st0["requests"], st1["requests"]) == (0, 0 if pc else B)
    for res in (host, got):
        for a, b in zip(res, want):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert a.steps == b.steps
    assert bit_equal(host_tensors, eager) and bit_equal(got_tensors, eager)
    steps = max(r.steps for r in got)
    assert (st["requests"], st["loops"], st["replays"], st["prefills"],
            st["captured"]) == (1, 1, steps, sum(want_chunks), 0)
    assert prefills == want_chunks
    assert reads.seen == ["fetch"]
    # the kernels' launches: the eager call's (the WHILE condition kernel
    # apart, which eager calls do not run)
    index = graphs._TALLIES.index(graph_cond.counts)
    set_while = graph_counts[index].pop("set_while")
    graph_counts[index].pop("plain", None)
    eager_counts[index].pop("plain", None)
    assert graph_counts == eager_counts
    assert eager_counts[graphs._TALLIES.index(
        lookahead_attention.paged_counts)]["plain"] > 0
    # one before each loop and one an iteration: the lane loop's B, the
    # nested prefills' chunks, the decode loop's steps
    assert set_while == (1 + B) + (B + sum(want_chunks)) + (1 + steps)


# ---------------------------------------------------------------------------
# A prefill count that disagrees with the host's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["prefix", "batch"])
def test_a_prefill_count_that_disagrees_with_the_host_raises(kind):
    """The call's one read brings each prepared lane's prefill iterations
    back, and the call refuses a count other than the host's: a prefill
    WHILE node that ran one chunk too few raises, past a prefix and in a
    batch's lane."""
    with faked_capture():
        eng = port_engine()
        pc = eng.precompute_prefix(prompt(0, P0))
        p = list(pc.tokens) + prompt(3, 3 * C + 5)

        def call():
            if kind == "prefix":
                return eng.generate(p, NEW, prefix=pc)
            return eng.generate_batch([prompt(4, 20), p], BATCH_NEW)
        call()
        real = eng._fns.prefill_from

        def short(params, state, counters, run):
            def fewer():
                run()
                eng._slots[0].prefills.sub_(1)
            return real(params, state, counters, fewer)
        eng._fns = eng._fns._replace(prefill_from=short)
        for slot in eng._slots:
            slot.graphs.clear()
        for lanes in eng._lane_slots.values():
            lanes.graphs.clear()
        want = "ran 3 chunks where the prompt has 4" if kind == "prefix" \
            else "ran 1 chunks where the prompt has 2"
        with pytest.raises(RuntimeError, match=want):
            call()
