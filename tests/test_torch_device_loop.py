"""The decode loop on the device, held on the CPU: the counterpart of the JAX
decode loop's ``lax.while_loop`` on ``~finished``
(``lookaheaddecoding_tpu/core/step.py:520-529`` and ``:568-575``;
``core/engine.py:625`` for ``generate_batch``). On one card greedy
``generate``, ``generate_baseline`` and greedy ``generate_batch`` launch
their whole loop once, a CUDA-graph WHILE node around the captured step
(``ops/graph_cond.py``): a ``graphs.LoopGraph`` (``fused=False``), or
the decode node of the call's ``graphs.RequestGraph``, the whole request
as one graph; and they read the device once, in the call's final
transfer. Here the capture is
``torch_parallel_worker.faked_capture``'s, whose WHILE node runs its body
while a lane is unfinished and fewer than ``cap`` iterations have run, and
the port computes in float32 against the JAX package:

- greedy ``generate`` (to its budget, to an EOS id, to the capacity stop),
  ``generate_baseline``, calls on a ``precompute_prefix`` cache, a second
  turn on a ``return_prefix`` result and a two-lane greedy
  ``generate_batch`` give JAX's tokens, steps and pool rows [0, R) exactly,
  and the rows of the caches they return within float32 rounding, on the
  capturing call and on the next;
- a call reads the device once after its preparation (``HostReads``);
- the replays, branches and each kernel's launches a call counts are its
  steps times those of a decode iteration, beside its chunks times a
  prefill iteration's and the preparation's;
- sampled ``generate_sample`` (top-k, top-p, EOS-ended, on a prefix) and
  a sampled two-lane ``generate_batch`` loop on the device too, their
  noise from the state's Philox stream (``ops/philox.py``), and equal the
  host loop and ``graphs.eager()`` in tokens, steps, pool rows [0, R) and
  the final draw counters, with one read a call;
- greedy calls with ``always_fwd_one=False`` (whose window refill draws
  from the stream), with the ``copy_from`` and ``order_copy_from``
  seedings, loop on the device, give JAX's tokens and equal eager;
- a loop that stops at its cap with a lane unfinished raises and is not
  run again from the host; a step that draws from a ``torch.Generator``
  and a mesh that does not capture are refused (meshes that capture loop
  on the device: ``tests/test_torch_parallel.py``); a failing WHILE node
  raises and runs no host loop;
- streams, a call that asks for the host loop and ``graphs.eager()`` keep
  the host loop (gloo meshes: ``tests/test_torch_parallel.py``);
- ``while_node_ref`` runs 0, 1 and n iterations;
- the host loop takes no step past a capacity stop, whose cache write
  would overwrite committed rows that a ``return_prefix`` carries.

The WHILE node itself runs on the card: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phases 3 and 13.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu_torch.core import engine as engine_module
from lookaheaddecoding_tpu_torch.core import graphs
from lookaheaddecoding_tpu_torch.core.step import host_batch
from lookaheaddecoding_tpu_torch.ops import graph_cond
from torch_parallel_worker import HostReads, faked_capture

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)
# S = 27 composite rows; order_copy_from seeds the window without a
# generator, so JAX and the port take the same steps
LOOK = dict(level=4, window_size=5, guess_set_size=4, pool_from_prompt=True,
            window_init="order_copy_from")
M, C = 128, 16


@functools.lru_cache(maxsize=None)
def tree():
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    return jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                          scale=0.5))


@functools.lru_cache(maxsize=None)
def jax_engine():
    return jlt.LookaheadEngine(
        jlt.LlamaConfig(**ARCH, dtype=jnp.float32), tree(),
        jlt.LookaheadConfig(**LOOK),
        jlt.EngineConfig(max_seq_len=M, prefill_chunk=C, dtype="float32"))


def port_engine(**lkw):
    """A float32 engine on the CPU; made inside ``faked_capture`` it
    captures, and its greedy and AR calls loop on the (faked) device."""
    cfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    return tlt.LookaheadEngine(
        cfg, tlt.params_from_numpy(tree(), cfg, "cpu"),
        tlt.LookaheadConfig(**dict(LOOK, **lkw)),
        tlt.EngineConfig(max_seq_len=M, prefill_chunk=C), device="cpu")


def prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 128,
                                                                size=n)]


P1, P2 = prompt(0, 20), prompt(1, 11)
LONG = prompt(2, 100)              # M - S + 1 = 102: the capacity stop


@functools.lru_cache(maxsize=None)
def eos_id():
    """A token that JAX's greedy run of P1 emits at its 11th new position:
    an EOS id that ends that run early."""
    return int(jax_engine().generate(P1, 40).tokens[len(P1) + 10])


def _second_turn(e):
    r1 = e.generate(P1, 24, return_prefix=True)
    return [r1, e.generate(list(r1.tokens) + [5, 6], 24, prefix=r1.prefix,
                           return_prefix=True)]


# call -> (results of one call on an engine, device loops it launches)
CALLS = {
    "generate": (lambda e: [e.generate(P1, 40, return_prefix=True)], 1),
    "eos": (lambda e: [e.generate(P1, 40, eos_token_id=eos_id(),
                                  return_prefix=True)], 1),
    "capacity": (lambda e: [e.generate(LONG, 60, return_prefix=True)], 1),
    "baseline": (lambda e: [e.generate_baseline(P1, 30,
                                                return_prefix=True)], 1),
    "baseline_capacity": (lambda e: [e.generate_baseline(
        LONG, 60, return_prefix=True)], 1),
    "prefix": (lambda e: [e.generate(P1, 30, prefix=e.precompute_prefix(
        P1[:12]), return_prefix=True)], 1),
    "baseline_prefix": (lambda e: [e.generate_baseline(
        P1, 30, prefix=e.precompute_prefix(P1[:12]))], 1),
    "second_turn": (_second_turn, 2),
    "batch": (lambda e: e.generate_batch([P1, P2], 24), 1),
}


def pools(eng, kind, res):
    """The pool tables (rows [0, R): the write-only trash row apart, whose
    order differs from JAX's; and the clock) each result ended with: its
    returned prefix's, or a batch lane's."""
    if kind == "batch":
        pool = eng._lane_slots[2].states.pool
        return [[np.asarray(pool.values[b, :-1]), np.asarray(pool.age[b, :-1]),
                 np.asarray(pool.clock[b])] for b in range(2)]
    return [[np.asarray(r.prefix.pool.values[:-1]),
             np.asarray(r.prefix.pool.age[:-1]),
             np.asarray(r.prefix.pool.clock)] for r in res
            if r.prefix is not None and r.prefix.pool is not None]


def jax_pools(kind, res):
    if kind == "batch":          # a lane equals its lone call
        res = [jax_engine().generate(p, 24, return_prefix=True)
               for p in (P1, P2)]
    return [[np.asarray(r.prefix.pool.values)[:-1],
             np.asarray(r.prefix.pool.age)[:-1],
             np.asarray(r.prefix.pool.clock)] for r in res
            if r.prefix is not None and r.prefix.pool is not None]


def counted(fn):
    graphs.reset_stats()
    out = fn()
    return out, graphs.read_stats()


@pytest.mark.parametrize("kind", list(CALLS))
def test_device_loop_equals_jax(kind):
    """The call through the device-loop wiring (the capturing call, then
    one that replays) against JAX: tokens, steps and pool rows [0, R)
    exactly, the returned prefix's length and its committed cache rows
    within float32 rounding; each decode launched one device loop, and the
    replaying call counts a replay a step."""
    call, loops = CALLS[kind]
    want = call(jax_engine())
    with faked_capture():
        eng = port_engine()
        runs = [counted(lambda: call(eng)) for _ in range(2)]
    for i, (got, st) in enumerate(runs):
        assert [r.tokens.tolist() for r in got] == \
            [np.asarray(r.tokens).tolist() for r in want], (kind, i)
        assert [r.steps for r in got] == [r.steps for r in want], (kind, i)
        for a, b in zip(pools(eng, kind, got), jax_pools(kind, want)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=kind)
        for g, w in zip(got, want):
            if g.prefix is None:
                continue
            assert g.prefix.length == w.prefix.length
            n = g.prefix.length
            for cache, jcache in ((g.prefix.k_cache, w.prefix.k_cache),
                                  (g.prefix.v_cache, w.prefix.v_cache)):
                np.testing.assert_allclose(
                    cache[..., :n, :].numpy(),
                    np.asarray(jcache)[..., :n, :], atol=1e-4, rtol=0)
        assert st["loops"] == loops, (kind, i, st)
    steps = (max if kind == "batch" else sum)(r.steps for r in runs[1][0])
    assert runs[1][1]["replays"] == steps and runs[1][1]["captured"] == 0


@pytest.mark.parametrize("kind", ["generate", "eos", "baseline", "prefix",
                                  "second_turn", "batch"])
def test_a_call_reads_the_device_once(kind):
    """On an engine whose graphs are captured, a call makes one read back
    to the host, its final transfer (a turn: one a call): nothing from its
    preparation through the loop reads the device."""
    call, loops = CALLS[kind]
    pc = None
    with faked_capture():
        eng = port_engine()
        call(eng)
        if kind == "prefix":
            pc = eng.precompute_prefix(P1[:12])
            call = (lambda e: [e.generate(P1, 30, prefix=pc,
                                          return_prefix=True)])
        with HostReads() as mode:
            call(eng)
    assert mode.seen == ["fetch"] * loops


@pytest.mark.parametrize("mode", ["greedy", "ar"])
def test_replays_and_launches_are_steps_times_an_iteration(mode):
    """A replaying call, one launch of its request graph, counts from the
    iterations its final transfer read: a replay and the decode loop's
    branches a step, a prefill iteration a chunk, and each kernel's
    launches (the attention's plain version here, the IF nodes' and the
    WHILE nodes' condition kernels) a step times a decode iteration's
    plus a chunk times a prefill iteration's plus the preparation's once,
    each WHILE node's condition kernel once before its loop."""
    def call(e):
        return (e.generate(P1, 40) if mode == "greedy"
                else e.generate_baseline(P1, 30))
    with faked_capture():
        eng = port_engine(attention_impl="kernel")
        call(eng)
        before = [dict(t) for t in graphs._TALLIES]
        res, st = counted(lambda: call(eng))
        after = [dict(t) for t in graphs._TALLIES]
    slot_graphs = eng._slots[0].graphs
    graph = next(g for k, g in slot_graphs.items() if k[0] == "request")
    chunks = -(-(len(P1) - 1) // C)
    assert isinstance(graph, graphs.RequestGraph)
    assert (st["loops"], st["replays"], st["prefills"], st["requests"]) == \
        (1, res.steps, chunks, 1)
    conds = graph.loops["decode"][2]
    assert st["branches"] == res.steps * conds
    assert conds == (1 if mode == "greedy" else 0)
    index = [id(t) for t in graphs._TALLIES]
    want = [dict.fromkeys(t, 0) for t in graphs._TALLIES]
    for launches, n in ((graph.fixed, 1),
                        (graph.loops["decode"][1], res.steps),
                        (graph.loops["prefill"][1], chunks)):
        for tally, key, k in launches:
            want[index.index(id(tally))][key] += k * n
    got = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
    assert got == want
    assert got[index.index(id(graph_cond.counts))]["set_while"] == \
        2 + res.steps + chunks
    for name in ("decode", "prefill"):
        assert graph.per_iteration(name)["set_while"] == 1
        assert graph.per_iteration(name)["plain"] >= ARCH["num_hidden_layers"]


def test_a_loop_stopped_at_its_cap_raises(monkeypatch):
    """A step that never finishes runs the loop to its cap, the call's
    max_new iterations; the call then raises, and nothing runs the loop
    again from the host."""
    ran = []
    monkeypatch.setattr(engine_module, "run_loop",
                        lambda *a, **k: ran.append(1))
    with faked_capture():
        eng = port_engine()
        eng._fns = eng._fns._replace(decode_step=lambda *args: None)
        graphs.reset_stats()
        with pytest.raises(RuntimeError, match="cap of 5 iterations"):
            eng.generate(P1, 5)
        st = graphs.read_stats()
    assert ran == []
    assert (st["loops"], st["replays"]) == (1, 5)


def test_a_failing_while_node_raises_and_runs_no_host_loop(monkeypatch):
    """The C entry point returning an error (a CUDA runtime without
    conditional nodes answers so) fails the first greedy call, naming the
    error; the call neither loops on the host nor replays a step."""
    ran = []
    monkeypatch.setattr(engine_module, "run_loop",
                        lambda *a, **k: ran.append(1))
    real = graph_cond.while_node
    card = SimpleNamespace(cuda_stream=0, wait_stream=lambda other: None)
    with faked_capture():
        eng = port_engine()
        graphs.reset_stats()
        with monkeypatch.context() as m:
            m.setattr(graph_cond, "while_node", real)
            m.setattr(graph_cond, "_device_type", lambda t: "cuda")
            m.setattr(graph_cond, "_launch", lambda op, *args: 801)
            m.setattr(graph_cond, "body_stream", lambda *a, **k: card)
            m.setattr(torch.cuda, "current_stream", lambda *a: card)
            with pytest.raises(RuntimeError,
                               match="WHILE node failed: CUDA error 801"):
                eng.generate(P1, 24)
        st = graphs.read_stats()
    assert ran == []
    assert st["loops"] == st["replays"] == 0


def test_loop_graph_refuses_a_random_step_and_a_mesh():
    """A step whose warm step moved a generator of the state would draw
    the same numbers every iteration of a device loop: the capture raises
    before recording anything. A mesh is refused when the loop is made
    only where it does not capture (here on the CPU; on the card a gloo
    group); a mesh that captures is taken and its loop runs."""
    x, gen = torch.zeros(1), torch.Generator().manual_seed(0)
    finished = torch.zeros(1, dtype=torch.bool)
    cap = torch.tensor([4], dtype=torch.int32)
    with faked_capture() as made:
        loop = graphs.LoopGraph(
            lambda: x.add_(torch.rand(1, generator=gen)),
            {"x": x, "rng": gen}, finished, cap)
        with pytest.raises(RuntimeError, match="drew random numbers"):
            loop.run()
        assert made == [] and loop.graph is None
    mesh = SimpleNamespace(groups={"tp": object()})
    with pytest.raises(ValueError, match="mesh only when the mesh captures"):
        graphs.LoopGraph(lambda: None, {"x": x}, finished, cap, mesh=mesh)
    with faked_capture():

        def step():
            x.add_(1)
            finished.copy_(x >= 3)
        x.zero_()
        loop = graphs.LoopGraph(step, {"x": x, "finished": finished},
                                finished, cap, mesh=mesh)
        loop.run()
        assert (float(x), int(loop.iters)) == (3.0, 2)

def test_loop_graph_runs_until_every_lane_finished():
    """Three lanes that finish after 2, 5 and 3 steps: the warm step, then
    one launch of the loop runs 4 iterations (5 steps in all); the counts
    fold in when the caller hands over the iterations it read."""
    x = torch.zeros(3, dtype=torch.int32)
    finished = torch.zeros(3, dtype=torch.bool)
    limit = torch.tensor([2, 5, 3], dtype=torch.int32)
    cap = torch.tensor([100], dtype=torch.int32)

    def step():
        x.add_((~finished).int())
        finished.copy_(x >= limit)
    with faked_capture():
        loop = graphs.LoopGraph(step, {"x": x, "finished": finished},
                                finished, cap)
        graphs.reset_stats()
        loop.run()
        iters = int(loop.iters)
        loop.account(iters)
        st = graphs.read_stats()
    assert x.tolist() == [2, 5, 3] and iters == 4
    assert (st["captured"], st["loops"], st["replays"]) == (1, 1, 4)
    assert graph_cond.counts["set_while"] >= 1


@pytest.mark.parametrize("n", [0, 1, 5])
def test_while_node_ref_runs_n_iterations(n):
    """The plain version runs its body while the predicate holds: 0, 1 or
    n times; ``while_node`` on CPU tensors is that loop over its flags and
    cap, counting the iterations and the plain call."""
    runs = []
    graph_cond.while_node_ref(lambda: len(runs) < n, lambda: runs.append(1))
    assert len(runs) == n
    x = torch.zeros((), dtype=torch.int32)
    finished = torch.tensor([n == 0])
    iters = torch.zeros(1, dtype=torch.int32)
    before = graph_cond.counts["plain"]
    graph_cond.while_node(finished, torch.tensor([n], dtype=torch.int32),
                          iters, lambda: x.add_(1), None)
    assert int(x) == int(iters) == n
    assert graph_cond.counts["plain"] == before + 1
    with pytest.raises(ValueError, match="int32"):
        graph_cond.while_node(finished, torch.tensor([n]), iters,
                              lambda: None, None)


@pytest.mark.parametrize("group", [1, 2])
def test_fused_drains_loop_on_the_device(group):
    """``ContinuousBatchingEngine``'s throughput objective drains its
    queue through the engine's fused calls, greedy ``generate`` one by one
    or ``generate_batch`` by groups: each launches one device loop, and
    every result equals the lone call."""
    reqs = [tlt.Request(prompt=P1[:n], max_new_tokens=16, request_id=i)
            for i, n in enumerate((10, 13, 9, 20))]
    with faked_capture():
        eng = port_engine()
        want = {r.request_id: eng.generate(r.prompt, 16).tokens.tolist()
                for r in reqs}
        cb = tlt.ContinuousBatchingEngine(eng, num_lanes=2,
                                          objective="throughput",
                                          batch_group=group)
        res, st = counted(lambda: cb.run(reqs))
    assert {r.request_id: r.tokens.tolist() for r in res} == want
    assert st["loops"] == len(reqs) // group


HOST_LOOP = {
    "sample": lambda e: [e.generate_sample(P1, 30, tlt.SamplingConfig(
        temperature=0.9, top_k=20), seed=3)],
    "stream": lambda e: [np.concatenate(list(e.generate_stream(
        P1, 30, steps_per_yield=4)))],
    "stream_ar": lambda e: [np.concatenate(list(e.generate_stream(
        P1, 30, lookahead=False, steps_per_yield=8)))],
    "sampled_batch": lambda e: e.generate_batch(
        [P1, P2], 24, sampling=tlt.SamplingConfig(temperature=0.9),
        seeds=[1, 2]),
    "asked_for": lambda e: [e._run("greedy", P1, 30, None, 0,
                                   host_loop=True)],
}
# the cases of HOST_LOOP that loop on the device: sampling draws from the
# state's stream, whose counter the kernel reads on the device
DEVICE_LOOP = ("sample", "sampled_batch")


@pytest.mark.parametrize("kind", list(HOST_LOOP))
def test_sampling_and_streams_keep_the_host_loop(kind):
    """Which loop each call takes on an engine whose graphs are captured.
    Streams (a yield every ``steps_per_yield`` steps, as JAX's) and a
    greedy call that asks for the host loop (``host_loop=True``, which
    ``chip_smoke.py``'s profiles take) replay their captured step from the
    host loop, reading the device more than once, and launch no device
    loop. Sampling and sampled lanes, whose noise comes from the state's
    Philox stream, launch one device loop and read the device once.
    ``graphs.eager()`` steps every call op by op, greedy ones too."""
    call = HOST_LOOP[kind]
    with faked_capture():
        eng = port_engine()
        call(eng)
        graphs.reset_stats()
        with HostReads() as mode:
            call(eng)
        st = graphs.read_stats()
        with graphs.eager():
            _, eager = counted(lambda: CALLS["generate"][0](eng)
                               + CALLS["batch"][0](eng))
    if kind in DEVICE_LOOP:
        assert st["loops"] == 1 and st["replays"] > 0
        assert mode.seen == ["fetch"]
    else:
        assert st["loops"] == 0 and st["replays"] > 0
        assert len(mode.seen) > 1 and set(mode.seen) == {"fetch"}
    assert (eager["loops"], eager["replays"], eager["captured"]) == (0, 0, 0)


SC_K = tlt.SamplingConfig(temperature=0.9, top_k=20)
SC_P = tlt.SamplingConfig(temperature=0.8, top_p=0.9)


@functools.lru_cache(maxsize=None)
def sampled_eos():
    """A token that the sampled run of P1 (top-k, seed 3) emits at its 6th
    new position, eagerly on the CPU: an EOS id that ends that run
    early."""
    res = port_engine().generate_sample(P1, 30, SC_K, seed=3)
    return int(res.tokens[len(P1) + 5])


# call -> its results on an engine, by the device loop or (host=True) by
# the host loop
SAMPLED = {
    "top_k": lambda e, host: [e._run("sample", P1, 30, None, 3,
                                     return_prefix=True, sampling=SC_K,
                                     host_loop=host)],
    "top_p": lambda e, host: [e._run("sample", P1, 30, None, 4,
                                     return_prefix=True, sampling=SC_P,
                                     host_loop=host)],
    "eos": lambda e, host: [e._run("sample", P1, 40, sampled_eos(), 3,
                                   return_prefix=True, sampling=SC_K,
                                   host_loop=host)],
    "prefix": lambda e, host: [e._run(
        "sample", P1, 30, None, 5, prefix=e.precompute_prefix(P1[:12]),
        return_prefix=True, sampling=SC_K, host_loop=host)],
    "batch": lambda e, host: e._batch([P1, P2], 24, None, 0, [1, 2], None,
                                      SC_P, [0.7, 1.2], None,
                                      host_loop=host),
}


def outcome(eng, kind, res):
    """What a call ended with: each result's tokens and steps, its pool
    rows [0, R) and clock (the returned prefix's, or a batch lane's) and
    its final draw counter."""
    draws = (eng._lane_slots[2].states.draws.tolist() if kind == "batch"
             else [int(eng._slots[0].state.draws)])
    return ([r.tokens.tolist() for r in res], [r.steps for r in res],
            [[x.tolist() for x in lane] for lane in pools(eng, kind, res)],
            draws)


@pytest.mark.parametrize("kind", list(SAMPLED))
def test_sampling_device_loop_equals_host_loop_and_eager(kind):
    """A sampling call on the device loop (captured, then replayed) equals
    the same call by the host loop and by ``graphs.eager()``: tokens,
    steps, pool rows and the final draw counter, bit for bit (a step after
    ``finished`` keeps the counter, so the host loop's overshoot changes
    nothing). It launches one loop, runs a replay a step, and reads the
    device once; the host loop none and more."""
    call = SAMPLED[kind]
    with faked_capture():
        eng = port_engine()
        call(eng, False)
        dev, dev_st = counted(lambda: outcome(eng, kind, call(eng, False)))
        host, host_st = counted(lambda: outcome(eng, kind, call(eng, True)))
        with graphs.eager():
            eager, eager_st = counted(lambda: outcome(eng, kind,
                                                      call(eng, False)))
        pc = eng.precompute_prefix(P1[:12])
        again = call if kind != "prefix" else (lambda e, host: [e._run(
            "sample", P1, 30, None, 5, prefix=pc, return_prefix=True,
            sampling=SC_K)])
        with HostReads() as mode:
            again(eng, False)
    assert dev == host == eager
    assert (dev_st["loops"], host_st["loops"], eager_st["loops"]) == (1, 0, 0)
    assert dev_st["replays"] == max(dev[1]) and dev_st["captured"] == 0
    assert eager_st["replays"] == 0
    assert mode.seen == ["fetch"]
    assert min(dev[3]) > 0 and all(d == s for d, s in zip(dev[3], dev[1]))
    if kind == "eos":
        assert dev[0][0][-1] == sampled_eos() and len(dev[0][0]) < len(P1) + 40


@functools.lru_cache(maxsize=None)
def jax_refill_engine(init):
    return jlt.LookaheadEngine(
        jlt.LlamaConfig(**ARCH, dtype=jnp.float32), tree(),
        jlt.LookaheadConfig(**dict(LOOK, always_fwd_one=False,
                                   window_init=init)),
        jlt.EngineConfig(max_seq_len=M, prefill_chunk=C, dtype="float32"))


REFILL = {
    "generate": lambda e: [e.generate(P1, 40, return_prefix=True)],
    "prefix": lambda e: [e.generate(P1, 30, prefix=e.precompute_prefix(
        P1[:12]), return_prefix=True)],
    "batch": lambda e: e.generate_batch([P1, P2], 24),
}


@pytest.mark.parametrize("init", ["copy_from", "order_copy_from"])
@pytest.mark.parametrize("kind", list(REFILL))
def test_refilling_greedy_loops_on_the_device(kind, init):
    """A greedy call with ``always_fwd_one=False``, whose window refill
    draws random copies of confirmed tokens every step (and, with
    ``copy_from``, whose seeding draws too), is captured into a device
    loop: it gives JAX's tokens at float32, launches one loop, and equals
    ``graphs.eager()`` in tokens, steps, pool rows and draw counters."""
    call = REFILL[kind]
    jeng = jax_refill_engine(init)
    want = ([jeng.generate(p, 24) for p in (P1, P2)] if kind == "batch"
            else call(jeng))
    with faked_capture():
        eng = port_engine(always_fwd_one=False, window_init=init)
        call(eng)
        dev, st = counted(lambda: outcome(eng, kind, call(eng)))
        with graphs.eager():
            eager, eager_st = counted(lambda: outcome(eng, kind, call(eng)))
    assert dev[0] == [np.asarray(r.tokens).tolist() for r in want]
    assert dev == eager
    assert (st["loops"], eager_st["loops"]) == (1, 0)
    assert st["replays"] == max(dev[1])


@pytest.mark.parametrize("mode", ["greedy", "ar"])
def test_a_host_loop_call_equals_the_device_loop(mode):
    """A call that asks for the host loop (``_run(..., host_loop=True)``)
    gives the device loop's tokens, steps and final pool tables, on an
    engine whose graphs are captured, without launching a loop."""
    with faked_capture():
        eng = port_engine()
        eng._run(mode, P1, 40, None, 0)
        eng._run(mode, P1, 40, None, 0, host_loop=True)
        dev, dev_st = counted(lambda: eng._run(mode, P1, 40, None, 0,
                                               return_prefix=True))
        host, host_st = counted(lambda: eng._run(
            mode, P1, 40, None, 0, return_prefix=True, host_loop=True))
    assert (dev_st["loops"], host_st["loops"]) == (1, 0)
    assert dev_st["captured"] == host_st["captured"] == 0
    assert host_st["replays"] >= host.steps == dev.steps
    np.testing.assert_array_equal(host.tokens, dev.tokens)
    got, want = pools(eng, mode, [host]), pools(eng, mode, [dev])
    assert len(got) == len(want)
    for a, b in zip(sum(got, []), sum(want, [])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("call", ["generate", "baseline", "stream"])
def test_host_loop_takes_no_step_past_a_capacity_stop(call):
    """Eagerly (the CPU's host loop) a run that ends at the capacity stop
    returns the prefix JAX's does: a step after the stop would write its
    composite rows at the cache's end (the start clamped as
    ``lax.dynamic_update_slice`` clamps it), over the last committed rows.
    The batches the host queues stop at the step that may end the run
    (``step.host_batch``); the prefix equals the device loop's bit for
    bit."""
    def run(e):
        if call == "stream":
            parts = e.generate_stream(LONG, 60, steps_per_yield=64,
                                      return_prefix=True)
            while True:
                try:
                    next(parts)
                except StopIteration as stop:
                    return stop.value
        fn = e.generate if call == "generate" else e.generate_baseline
        return fn(LONG, 60, return_prefix=True).prefix
    jfn = (jax_engine().generate_baseline if call == "baseline"
           else jax_engine().generate)
    want = jfn(LONG, 60, return_prefix=True).prefix
    got = run(port_engine())
    assert got.length == want.length
    n = got.length
    for cache, jcache in ((got.k_cache, want.k_cache),
                          (got.v_cache, want.v_cache)):
        np.testing.assert_allclose(cache[..., :n, :].numpy(),
                                   np.asarray(jcache)[..., :n, :],
                                   atol=1e-4, rtol=0)
    if call != "stream":
        with faked_capture():
            looped = run(port_engine())
        assert all(torch.equal(a[..., :n, :], b[..., :n, :]) for a, b in
                   zip((got.k_cache, got.v_cache),
                       (looped.k_cache, looped.v_cache)))


@pytest.mark.parametrize("mode,max_new,first", [
    ("sample", 30, 10),      # ceil(30 / 3)
    ("ar", 30, 30),
])
def test_host_loop_batches_its_steps(monkeypatch, mode, max_new, first):
    """The host loop queues ceil(max_new / tokens a step) steps before its
    first read (``step.host_batch``), and then as many as the remaining
    budget allows: a sampling call at GS = 3 runs 10 steps first and reads
    the device fewer times than it takes steps; the AR baseline's 30 steps
    run in one batch. A call that its budget ends runs no step past it."""
    from lookaheaddecoding_tpu_torch.core import step as step_module
    ran, host_loop = [], step_module.run_loop

    def spied(run, *args):
        def counted(n):
            ran.append(n)
            run(n)
        return host_loop(counted, *args)
    monkeypatch.setattr(engine_module, "run_loop", spied)
    eng = port_engine()
    if mode == "sample":
        res = eng.generate_sample(P1, max_new, tlt.SamplingConfig(
            temperature=1e-4), seed=0)
    else:
        res = eng.generate_baseline(P1, max_new)
    assert ran[0] == first and sum(ran) == res.steps
    assert len(ran) < res.steps or len(ran) == 1


@pytest.mark.parametrize("left,kv_len,want", [
    (40, 20, 10),      # the budget binds: ceil(40 / 4)
    (40, 90, 3),       # (101 - 90) // 4 + 1: only the last may stop
    (40, 101, 1),      # at the last live start
    (40, 110, 1),      # always at least one
])
def test_host_batch(left, kv_len, want):
    assert host_batch(left, 4, kv_len, M - 27) == want
