"""What capturing the decode step in a CUDA graph needs of the port, held on
the CPU (capture and replay themselves need the card:
``tests/test_torch_gpu.py``):

- every state tensor keeps its address across a step of each kind
  (``decode_step``, ``sample_step``, ``baseline_step``, ``decode_batch``,
  ``sample_batch``) and across calls on one engine (``_prepare`` and
  admission write in place);
- a step taken after ``finished`` leaves every buffer bit-equal;
- a step reads nothing back to the host;
- two calls in a row on one engine equal two fresh engines' calls and the
  JAX engine's at float32: tokens, steps and pool tables;
- ``core/graphs.py``'s bookkeeping: launch counts (and collectives'
  calls) a capture takes back and each replay adds, and the refusal of a
  step that rebinds a field;
- the mesh rule of capture: on the card without a mesh or on an NCCL one,
  eager on a gloo one; a gloo op staged through the host raises inside a
  capture;
- ``graphs.cond``: its body runs exactly when the predicate holds, a
  capture records it as an IF node (or raises without the API), the warm
  step runs it whatever the predicate says, the pool's chain launches
  none of the port's counted kernels, and a body that calls a collective
  is refused;
- the captured train step (``training/train_step.py``): eager on the CPU,
  on a mesh and inside ``graphs.eager()``; through a faked capture its
  steps equal the eager ones bit for bit, its arguments stay as they were,
  its results alias neither them nor the static buffers, and calls with
  the same shapes share one graph.
"""

import contextlib
import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu_torch.core import graphs
from lookaheaddecoding_tpu_torch.core.engine import lane_slot
from lookaheaddecoding_tpu_torch.ops import lookahead_attention as la
from torch_parallel_worker import HostReads, faked_capture, prepared

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)
LOOK = dict(level=4, window_size=5, guess_set_size=4, pool_from_prompt=True,
            window_init="order_copy_from")
SC = tlt.SamplingConfig(temperature=0.9, top_k=20, top_p=0.95)


def tree():
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    return jcfg, jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                                scale=0.5))


def port_engine(kv_quant=None, **lkw):
    _, params = tree()
    tcfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    return tlt.LookaheadEngine(
        tcfg, tlt.params_from_numpy(params, tcfg, "cpu"),
        tlt.LookaheadConfig(**dict(LOOK, **lkw)),
        tlt.EngineConfig(max_seq_len=256, prefill_chunk=16,
                         kv_quant=kv_quant), device="cpu")


def jax_engine(kv_quant=None):
    jcfg, params = tree()
    return jlt.LookaheadEngine(
        jcfg, params, jlt.LookaheadConfig(**LOOK),
        jlt.EngineConfig(max_seq_len=256, prefill_chunk=16, dtype="float32",
                         kv_quant=kv_quant))


def prompt(seed, n):
    return list(np.random.RandomState(seed).randint(0, 128, size=n))


def ptrs(tree_):
    return [t.data_ptr() for t in graphs.state_tensors(tree_)]


def snapshot(tree_):
    return [t.clone() for t in graphs.state_tensors(tree_)]


def bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def flat_steps(eng, slot):
    fns, st = eng._fns, slot.state
    temps, top_p, top_k = eng._warp(SC)
    return {
        "decode_step": lambda: fns.decode_step(eng.params, st, slot.max_new,
                                               slot.eos),
        "sample_step": lambda: fns.sample_step(eng.params, st, slot.max_new,
                                               slot.eos, temps, top_p, top_k),
        "baseline_step": lambda: fns.baseline_step(eng.params, st,
                                                   slot.max_new, slot.eos)}


def batch_slot(eng, seeds=(3, 4)):
    """Two lanes written as generate_batch writes them."""
    from lookaheaddecoding_tpu_torch.core.engine import write_lane
    lanes = lane_slot(eng, len(seeds))
    for b, s in enumerate(seeds):
        out_buf, n, fill = eng._host_args(prompt(b, 12 + 5 * b), 40)
        write_lane(lanes, b, eng._prepare(out_buf, n, s, fill))
    lanes.max_new.fill_(40)
    return lanes


def batch_steps(eng, lanes):
    fns = eng._batch_fns()
    args = (eng.params, lanes.k_pool, lanes.v_pool, lanes.states,
            lanes.max_new, lanes.eos)
    return {"decode_batch": lambda: fns.decode_batch(*args),
            "sample_batch": lambda: fns.sample_batch(
                *args, lanes.temperature, lanes.top_p, SC.top_k)}


# --------------------------------------------------------------------------
# fixed addresses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("kind", ["decode_step", "sample_step",
                                  "baseline_step"])
def test_flat_steps_keep_every_address(kind, kv_quant):
    """Each flat step writes its state in place: every tensor of the slot
    (caches or int8 {"q", "s"} trees, pool, window, counters, buffers) has
    the same data_ptr after steps, and the steps did change the state."""
    eng = port_engine(kv_quant)
    with torch.inference_mode():
        slot = prepared(eng, prompt(0, 20), 24)
        before, old = ptrs(slot), snapshot(slot)
        for _ in range(3):
            flat_steps(eng, slot)[kind]()
        assert ptrs(slot) == before
        assert not bit_equal(snapshot(slot), old)


@pytest.mark.parametrize("kind", ["decode_batch", "sample_batch"])
def test_batched_steps_keep_every_address(kind):
    """The batched paged step writes its lanes, pools and buffers in
    place."""
    eng = port_engine()
    with torch.inference_mode():
        lanes = batch_slot(eng)
        before, old = ptrs(lanes), snapshot(lanes)
        for _ in range(3):
            batch_steps(eng, lanes)[kind]()
        assert ptrs(lanes) == before
        assert not bit_equal(snapshot(lanes), old)


def test_calls_on_one_engine_reuse_its_static_state():
    """A second generate, a sampling call, the AR baseline, a stream, a
    prefix call and a batch reuse the engine's one flat slot and its lane
    slot, at the same addresses."""
    eng = port_engine()
    p = prompt(0, 20)
    eng.generate(p, 30)
    assert len(eng._slots) == 1
    flat = ptrs(eng._slots[0])
    eng.generate_batch([p, p[:9]], 16)
    lanes = ptrs(eng._lane_slots[2])
    pc = eng.precompute_prefix(p[:12])
    eng.generate(prompt(1, 31), 40)
    eng.generate_sample(p, 20, SC, seed=3)
    eng.generate_baseline(p, 20)
    list(eng.generate_stream(p, 20, steps_per_yield=2))
    eng.generate(p, 20, prefix=pc, return_prefix=True)
    eng.generate_batch([p[:15], p], 24, sampling=SC, seeds=[1, 2])
    assert len(eng._slots) == 1 and list(eng._lane_slots) == [2]
    assert ptrs(eng._slots[0]) == flat
    assert ptrs(eng._lane_slots[2]) == lanes


def test_a_suspended_stream_keeps_its_slot():
    """A call made while a stream is suspended takes a second slot, so
    neither writes the other's state: both equal their lone calls."""
    eng = port_engine()
    p, q = prompt(0, 20), prompt(1, 17)
    want_p, want_q = eng.generate(p, 40), eng.generate(q, 40)
    stream = eng.generate_stream(p, 40)
    first = next(stream)
    got_q = eng.generate(q, 40)
    assert len(eng._slots) == 2
    rest = np.concatenate([p, first] + list(stream))
    np.testing.assert_array_equal(rest, want_p.tokens)
    np.testing.assert_array_equal(got_q.tokens, want_q.tokens)
    assert not any(s.busy for s in eng._slots)


def test_continuous_batching_lanes_keep_their_addresses():
    """The scheduler's lanes (their streams' keys and draw counters too)
    keep their addresses across admissions, steps and harvests."""
    eng = port_engine()
    cb = tlt.ContinuousBatchingEngine(eng, num_lanes=2, steps_per_sync=2)
    reqs = [tlt.Request(prompt=prompt(i, 9 + i), max_new_tokens=16,
                        seed=i, request_id=i) for i in range(3)]
    cb.submit(reqs[0])
    cb.step()
    before = ptrs(cb._lanes)
    streams = ptrs((cb._lanes.states.key, cb._lanes.states.draws))
    for r in reqs[1:]:
        cb.submit(r)
    while cb.step():
        pass
    assert ptrs(cb._lanes) == before
    assert ptrs((cb._lanes.states.key, cb._lanes.states.draws)) == streams
    for r in cb._results:
        np.testing.assert_array_equal(
            r.tokens, eng.generate(reqs[r.request_id].prompt, 16,
                                   seed=r.request_id).tokens)


def test_paged_serving_keeps_its_addresses():
    """PagedServingEngine's pools, lanes, streams and buffers keep their
    addresses across admission (a prefix, a lane's stream rewritten),
    steps and harvest."""
    eng = port_engine()
    srv = tlt.PagedServingEngine(
        eng.mcfg, eng.params, eng.lcfg, eng.ecfg, num_lanes=2, page_size=32,
        n_pages=8, device="cpu", sampling=SC)
    bufs = (srv._k_pool, srv._v_pool, srv._states, srv._max_new, srv._eos,
            srv._temp, srv._topp)
    before = ptrs(bufs)
    streams = ptrs((srv._states.key, srv._states.draws))
    px = srv.precompute_prefix(prompt(0, 40)[:12])
    res = srv.run([tlt.Request(prompt=prompt(0, 40), max_new_tokens=24,
                               prefix=px, seed=5, request_id=0),
                   tlt.Request(prompt=prompt(1, 20), max_new_tokens=24,
                               seed=6, top_p=0.8, request_id=1)])
    srv.release_prefix(px)
    assert ptrs(bufs) == before
    assert ptrs((srv._states.key, srv._states.draws)) == streams
    assert all(r.error is None for r in res)


# --------------------------------------------------------------------------
# a finished step is a no-op; no host read
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("kind", ["decode_step", "sample_step",
                                  "baseline_step"])
def test_flat_step_after_finished_changes_nothing(kind, kv_quant):
    """Once ``finished`` is set (here by max_new), further steps leave
    every buffer of the slot bit-equal but the cache rows past the
    committed ones and the pool's write-only trash row, which no read
    sees: a replayed batch may overshoot. (The generator advances: a step
    draws a fixed count whatever the data.)"""
    eng = port_engine(kv_quant)
    with torch.inference_mode():
        slot = prepared(eng, prompt(0, 20), 6)
        step = flat_steps(eng, slot)[kind]
        for _ in range(40):
            step()
            if bool(slot.state.finished):
                break
        assert bool(slot.state.finished)
        kv = int(slot.state.kv_len)
        caches = graphs.state_tensors((slot.state.k_cache,
                                       slot.state.v_cache))
        pool = slot.state.pool
        others = [t for t in graphs.state_tensors(slot)
                  if not any(t is c for c in caches + [pool.values,
                                                       pool.age])]
        others += [pool.values[:-1], pool.age[:-1]]
        committed = [c[..., :kv, :].clone() for c in caches]
        kept = [t.clone() for t in others]
        for _ in range(3):
            step()
        assert bit_equal([c[..., :kv, :] for c in caches], committed)
        assert bit_equal(others, kept)


@pytest.mark.parametrize("kind", ["decode_batch", "sample_batch"])
def test_batched_step_after_finished_changes_nothing(kind):
    """Lanes that are all finished: a batched step leaves the lanes'
    committed KV rows, bookkeeping and pools bit-equal (rows past the
    committed ones, the trash page and the pools' trash rows, which no
    read sees, may be written)."""
    eng = port_engine()
    with torch.inference_mode():
        lanes = batch_slot(eng)
        lanes.states.finished.fill_(True)
        M = eng.ecfg.max_seq_len
        kv = lanes.states.kv_len.tolist()

        def committed():
            return [t[:, :, b * M:b * M + kv[b]] for t in graphs.state_tensors(
                (lanes.k_pool, lanes.v_pool)) for b in range(2)]
        live = [t.clone() for t in committed()]
        pool = lanes.states.pool
        rows = [t for t in graphs.state_tensors(
            (lanes.states, lanes.max_new, lanes.eos))
            if t is not pool.values and t is not pool.age]
        rows += [pool.values[:, :-1], pool.age[:, :-1]]
        rest = [t.clone() for t in rows]
        for _ in range(3):
            batch_steps(eng, lanes)[kind]()
        assert bit_equal(committed(), live)
        assert bit_equal(rows, rest)


@pytest.mark.parametrize("kind", ["decode_step", "sample_step",
                                  "baseline_step", "decode_batch",
                                  "sample_batch"])
def test_steps_read_nothing_back_to_the_host(kind, monkeypatch):
    """No op of a step reads a value back (``item``, a data-dependent
    shape): capture would fail on one, and a replay would not redo it. The
    one exception is ``graphs.cond``'s predicate, which a capture turns
    into an IF node and which eagerly is read on the host: it is replaced
    here by a call that runs the body without reading it, and the
    lookahead steps make one such call (the pool's chain)."""
    eng = port_engine(pool_key_len=2, pool_hash_size=97,
                      always_fwd_one=False)
    conds = []

    def cond(pred, body):
        conds.append(pred.shape)
        body()
    monkeypatch.setattr(graphs, "cond", cond)
    with torch.inference_mode():
        if kind.endswith("batch"):
            lanes = batch_slot(eng)
            step = batch_steps(eng, lanes)[kind]
        else:
            step = flat_steps(eng, prepared(eng, prompt(0, 20), 24))[kind]
        step()
        conds.clear()
        with HostReads() as mode:
            step()
    assert mode.seen == []
    assert conds == ([] if kind == "baseline_step" else [torch.Size([])])


# --------------------------------------------------------------------------
# two calls in a row
# --------------------------------------------------------------------------

def pool_of(res):
    pool = res.prefix.pool
    return [np.asarray(x) for x in (pool.values, pool.age, pool.clock)]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_two_calls_on_one_engine_equal_fresh_engines_and_jax(kv_quant):
    """generate twice on one engine (a long prompt, then a shorter one, so
    a stale row of the first would show) equals each call on a fresh
    engine and the JAX engine: tokens, steps and the final pool tables
    (values, ages, clock; from ``return_prefix``; JAX's trash row apart),
    and the committed KV rows equal the fresh engine's bit for bit."""
    eng, jeng = port_engine(kv_quant), jax_engine(kv_quant)
    calls = [(prompt(0, 60), 48), (prompt(1, 14), 40)]
    got = [eng.generate(p, n, return_prefix=True) for p, n in calls]
    fresh = [port_engine(kv_quant).generate(p, n, return_prefix=True)
             for p, n in calls]
    want = [jeng.generate(p, n, return_prefix=True) for p, n in calls]
    for g, f, w in zip(got, fresh, want):
        np.testing.assert_array_equal(g.tokens, f.tokens)
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.steps == f.steps == w.steps
        for a, b, c in zip(pool_of(g), pool_of(f), pool_of(w)):
            np.testing.assert_array_equal(a, b)
            # the write-only trash row takes another order than JAX's
            np.testing.assert_array_equal(a[:-1] if a.ndim else a,
                                          c[:-1] if c.ndim else c)
        assert g.prefix.length == f.prefix.length == w.prefix.length
        kv = g.prefix.length
        for a, b in zip(graphs.state_tensors((g.prefix.k_cache,
                                              g.prefix.v_cache)),
                        graphs.state_tensors((f.prefix.k_cache,
                                              f.prefix.v_cache))):
            assert torch.equal(a[..., :kv, :], b[..., :kv, :])


def test_two_calls_of_each_kind_equal_fresh_engines():
    """Sampling at a seed, the AR baseline and a batch, each called twice
    on one engine after other calls, equal the same call on a fresh
    engine: tokens and steps."""
    eng = port_engine()
    p, q = prompt(0, 30), prompt(2, 11)
    calls = {
        "sample": lambda e: [e.generate_sample(p, 40, SC, seed=7)],
        "baseline": lambda e: [e.generate_baseline(q, 30)],
        "batch": lambda e: e.generate_batch([q, p], 24, sampling=SC,
                                            seeds=[1, 2]),
    }
    for name, call in calls.items():
        want = call(port_engine())
        for _ in range(2):
            got = call(eng)
            eng.generate(prompt(3, 25), 16)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.tokens, w.tokens, name)
                assert g.steps == w.steps, name


def test_returned_prefix_is_not_the_engine_state():
    """A ``return_prefix`` result owns its caches and pool: a later call on
    the engine does not write them, and the conversation's next turn
    equals the full prefill."""
    eng = port_engine()
    r1 = eng.generate(prompt(0, 20), 30, return_prefix=True)
    kept = [t.clone() for t in graphs.state_tensors(r1.prefix)]
    eng.generate(prompt(5, 40), 40)
    assert bit_equal(graphs.state_tensors(r1.prefix), kept)
    turn2 = list(r1.tokens) + [5, 6]
    np.testing.assert_array_equal(
        eng.generate(turn2, 30, prefix=r1.prefix).tokens,
        eng.generate(turn2, 30).tokens)


# --------------------------------------------------------------------------
# core/graphs.py
# --------------------------------------------------------------------------

def test_runner_is_eager_on_the_cpu_and_inside_eager():
    cache = {}
    r = graphs.runner(cache, "k", lambda: None, (), graphed=False)
    assert isinstance(r, graphs.EagerSteps) and cache == {}
    with graphs.eager():
        r = graphs.runner(cache, "k", lambda: None, (), graphed=True)
    assert isinstance(r, graphs.EagerSteps) and cache == {}


@contextlib.contextmanager
def backends_named_by_group():
    """``dist.get_backend(group)`` is the group itself: a hand-made mesh's
    groups are backend names."""
    get = torch.distributed.get_backend
    torch.distributed.get_backend = lambda group=None: group
    try:
        yield
    finally:
        torch.distributed.get_backend = get


def mesh_of(**groups):
    """A hand-made mesh whose axes' groups are ``groups`` (backend names
    for :func:`backends_named_by_group`), every axis of size 1 or 2."""
    from lookaheaddecoding_tpu_torch.parallel.sharding import AXES, Mesh
    shape = {a: 2 if a in groups else 1 for a in AXES}
    return Mesh(shape, dict.fromkeys(AXES, 0), torch.device("cuda"),
                np.zeros([shape[a] for a in AXES], np.int64), groups)


@pytest.mark.parametrize("groups,want", [
    ({}, True),                           # every axis of size 1: no group
    ({"tp": "nccl"}, True),
    ({"pp": "nccl", "tp": "nccl", "la": "nccl"}, True),
    ({"tp": "gloo"}, False),
    ({"dp": "nccl", "tp": "gloo"}, False),
])
def test_capture_follows_the_meshs_backends(groups, want):
    """An engine's steps and the train step capture on the card without a
    mesh, or on a mesh whose every process group is NCCL; a gloo group
    (whose collectives stage through the host) keeps them eager, and the
    CPU never captures. ``runner`` then gives a StepGraph or eager
    steps."""
    from lookaheaddecoding_tpu_torch.training import train_step
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert graphs.capturable(cuda) and not graphs.capturable(cpu)
    with backends_named_by_group():
        mesh = mesh_of(**groups)
        assert graphs.capturable(cuda, mesh) is want
        assert not graphs.capturable(cpu, mesh)
        assert train_step._graphed(cuda, mesh) is want
        with graphs.eager():
            assert not train_step._graphed(cuda, mesh)
        r = graphs.runner({}, "k", lambda: None, (),
                          graphed=graphs.capturable(cuda, mesh))
    assert isinstance(r, graphs.StepGraph if want else graphs.EagerSteps)


@pytest.fixture
def gloo_group():
    """A one-rank gloo process group in this process, torn down after."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield dist.new_group([0])
    finally:
        dist.destroy_process_group()



def test_make_mesh_turns_nccls_graph_mixing_off(gloo_group, monkeypatch):
    """``make_mesh`` turns NCCL's graph mixing off before it makes its
    groups, whatever started the rank and whatever its environment said
    (``parallel/collectives.py``)."""
    from lookaheaddecoding_tpu_torch.parallel import collectives, make_mesh
    name, value = collectives.GRAPH_MIXING
    monkeypatch.setenv(name, "1")
    make_mesh(devices="cpu")
    assert os.environ[name] == value

@pytest.mark.parametrize("op,staged", [("send", True), ("recv", True),
                                       ("all_reduce", False),
                                       ("all_gather", False),
                                       ("broadcast", False)])
def test_staged_gloo_op_inside_a_capture_raises(gloo_group, monkeypatch, op,
                                                staged):
    """A collective that gloo takes only through host memory (send and
    receive of a CUDA tensor) raises when the stream is being captured,
    and is staged otherwise; the ones gloo takes on the card are never
    staged."""
    from types import SimpleNamespace
    from lookaheaddecoding_tpu_torch.parallel import collectives
    on_card = SimpleNamespace(is_cuda=True)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    assert collectives.staged(gloo_group, on_card, op) is staged
    assert not collectives.staged(gloo_group, torch.zeros(1), op)
    capturing[0] = True
    if staged:
        with pytest.raises(RuntimeError, match="cannot capture"):
            collectives.staged(gloo_group, on_card, op)
    else:
        assert not collectives.staged(gloo_group, on_card, op)


def test_step_graph_counts_collectives_once_a_replay(fake_cuda, gloo_group):
    """A captured step's collectives are counted as its kernels are: the
    warm step's for real, the capture's taken back, each replay's added
    once."""
    from lookaheaddecoding_tpu_torch.parallel import collectives
    x = torch.ones(4)

    def step():
        collectives.all_reduce(x, gloo_group)
        collectives.all_gather(x, gloo_group)
        collectives.all_reduce(x, gloo_group)

    before = dict(collectives.counts)
    g = graphs.StepGraph(step, {"x": x})
    g.run(1)
    assert g.launches_per_replay() == {"all_reduce": 2, "all_gather": 1}
    fake_cuda[0].step = lambda: None
    g.run(5)
    assert collectives.counts == dict(before,
                                      all_reduce=before["all_reduce"] + 12,
                                      all_gather=before["all_gather"] + 6)



def test_a_collective_after_a_graph_launch_waits_for_the_card(
        fake_cuda, monkeypatch):
    """With NCCL's graph mixing off no collective may be launched outside a
    graph while a graph launch is outstanding (``parallel/collectives.py``):
    after a graph's launch, the next collective outside a capture waits for
    the card first, once; one inside a capture and one on a CPU tensor do
    not, nor does one before any launch."""
    from types import SimpleNamespace
    from lookaheaddecoding_tpu_torch.parallel import collectives
    synced, capturing = [], [False]
    monkeypatch.setattr(collectives, "_graph_pending", False)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    on_card = SimpleNamespace(is_cuda=True, device="cuda:0")
    collectives._after_graphs(on_card)
    assert synced == []
    graphs.StepGraph(lambda: None, {"x": torch.zeros(1)}).run(2)
    collectives._after_graphs(torch.zeros(1))
    capturing[0] = True
    collectives._after_graphs(on_card)
    assert synced == []
    capturing[0] = False
    collectives._after_graphs(on_card)
    collectives._after_graphs(on_card)
    assert synced == ["cuda:0"]

def test_cond_body_calling_a_collective_is_refused(fake_cuda, if_nodes,
                                                   gloo_group):
    """Each rank evaluates its IF node on its own device: a collective
    under a predicate that differed between ranks would hang the world, so
    a body that calls one fails the capture."""
    from lookaheaddecoding_tpu_torch.parallel import collectives
    x = torch.ones(2)

    def step():
        graphs.cond(torch.tensor(True),
                    lambda: collectives.all_reduce(x, gloo_group))

    with pytest.raises(RuntimeError, match="collective"):
        graphs.StepGraph(step, {"x": x}).run(1)


def test_runner_keys_graphs_by_the_int4_kernel_switch(monkeypatch):
    """A graph is cached by its key and by ``ops.quant.INT4_PIPELINE``,
    which picks the int4 kernel inside a captured step."""
    from lookaheaddecoding_tpu_torch.ops import quant
    cache = {}
    monkeypatch.setattr(quant, "INT4_PIPELINE", False)
    plain = graphs.runner(cache, "k", lambda: None, (), graphed=True)
    assert isinstance(plain, graphs.StepGraph)
    assert graphs.runner(cache, "k", lambda: None, (), graphed=True) is plain
    monkeypatch.setattr(quant, "INT4_PIPELINE", True)
    piped = graphs.runner(cache, "k", lambda: None, (), graphed=True)
    assert piped is not plain and len(cache) == 2


@pytest.fixture
def fake_cuda():
    """torch.cuda's streams and graphs on the CPU (the worker's
    ``faked_capture``): the graphs made, in order."""
    with faked_capture() as made:
        yield made


def test_step_graph_counts_launches_once_a_replay(fake_cuda):
    """A capture takes back the launches it counted (capture launches
    nothing), each replay adds the step's launches, the warm step counts
    as the real step it is, the generators of the state are registered,
    and the cycle collector is off during the capture and on after it."""
    state = dict(x=torch.zeros(3), rng=torch.Generator())
    la.counts.update(dict.fromkeys(la.counts, 0))

    def step():
        state["x"].add_(1)
        la.counts["kernel"] += 2
        la.counts["mma"] += 2

    g = graphs.StepGraph(step, state)
    before = dict(graphs.stats)
    g.run(1)                       # the warm step and the capture
    assert la.counts["kernel"] == 2 and la.counts["mma"] == 2
    assert g.launches_per_replay() == {"kernel": 2, "mma": 2}
    assert fake_cuda[0].generators == [state["rng"]]
    assert gc.isenabled()
    fake_cuda[0].step = lambda: state["x"].add_(1)
    g.run(5)
    assert la.counts["kernel"] == 12 and la.counts["mma"] == 12
    assert g.replays == 5
    assert graphs.stats["captured"] == before["captured"] + 1
    assert graphs.stats["replays"] == before["replays"] + 5


def test_step_graph_refuses_a_step_that_rebinds_its_state(fake_cuda):
    """A step that replaces a state tensor instead of writing it would
    replay into a buffer nobody reads: the capture raises."""
    state = {"x": torch.zeros(3)}

    def step():
        state["x"] = state["x"] + 1

    with pytest.raises(RuntimeError, match="in place"):
        graphs.StepGraph(step, state).run(2)


# --------------------------------------------------------------------------
# graphs.cond
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pred", [True, False])
@pytest.mark.parametrize("shape", [(), (1,)])
def test_cond_runs_its_body_exactly_when_pred_holds(pred, shape):
    """Eagerly (the CPU) the body runs iff the one-element predicate is
    true; ``stats`` counts the branch and, if taken, the body."""
    graphs.reset_stats()
    ran = []
    graphs.cond(torch.full(shape, pred), lambda: ran.append(1))
    assert ran == ([1] if pred else [])
    assert graphs.read_stats()["branches"] == 1
    assert graphs.stats["taken"] == int(pred)


@pytest.fixture
def if_nodes(monkeypatch):
    """ops.graph_cond.if_node recorded: (predicate, body stream) of each
    node; the body runs, as a capture would record it."""
    from lookaheaddecoding_tpu_torch.ops import graph_cond
    made = []

    def if_node(pred, body, body_stream):
        made.append((pred, body_stream))
        body()
    monkeypatch.setattr(graph_cond, "if_node", if_node)
    return made


def test_cond_is_an_if_node_under_capture(fake_cuda, if_nodes):
    """A capture records the body as an IF node on the predicate as a 0-d
    bool tensor, on the graph's own body stream, and the body adds one to
    the graph's device counter. The warm step runs the body although the
    predicate is false, and counts no branch; each replay counts one
    branch evaluated."""
    state = {"x": torch.zeros(3), "flag": torch.zeros(1, dtype=torch.int32)}
    ran = []

    def step():
        graphs.cond(state["flag"] > 0, lambda: ran.append(1))

    g = graphs.StepGraph(step, state)
    graphs.reset_stats()
    g.run(1)
    assert len(ran) == 2                 # the warm step and the capture
    assert [(p.shape, p.dtype, s) for p, s in if_nodes] == [
        (torch.Size([]), torch.bool, g.body_stream)]
    assert g.conds == 1
    assert int(g.taken) == 1             # the faked capture ran the body
    assert graphs.stats["branches"] == 0 and graphs.stats["taken"] == 0
    g.taken.zero_()
    fake_cuda[0].step = lambda: None     # a replay that skips the body
    g.run(3)
    assert graphs.stats["branches"] == 3
    assert g.branches() == (0, 3)


def test_capture_raises_when_the_if_node_fails(fake_cuda, monkeypatch):
    """An IF node that cannot be made (no conditional nodes in the CUDA
    runtime) fails the capture: the error reaches the caller, and the body
    is not captured unconditionally instead."""
    from lookaheaddecoding_tpu_torch.ops import graph_cond

    def if_node(pred, body, body_stream):
        raise RuntimeError("CUDA-graph IF node failed")
    monkeypatch.setattr(graph_cond, "if_node", if_node)
    ran = []

    def step():
        graphs.cond(torch.tensor(False), lambda: ran.append(1))

    with pytest.raises(RuntimeError, match="IF node failed"):
        graphs.StepGraph(step, {"x": torch.zeros(1)}).run(2)
    assert ran == [1]                    # the warm step's run alone


def test_cond_body_launching_a_counted_kernel_is_refused(fake_cuda, if_nodes):
    """A body that launches one of the port's counted kernels would leave
    the launch counts of a replay unknown: the capture raises."""
    def step():
        def body():
            la.counts["kernel"] += 1
        graphs.cond(torch.tensor(True), body)

    with pytest.raises(RuntimeError, match="counted kernels"):
        graphs.StepGraph(step, {"x": torch.zeros(1)}).run(1)


def test_pool_chain_launches_no_counted_kernel(fake_cuda, if_nodes):
    """The pool update's chain (valid lanes sharing a key) captures as an
    IF node whose body launches none of the port's kernels: every launch
    count stays as it was, eagerly and through a capture."""
    from lookaheaddecoding_tpu_torch.core import pool as tpool
    p = tpool.pool_init(8, 2, 2, device="cpu")
    keys = torch.tensor([5, 5, 3, 5])
    tups = torch.tensor([[1, 1], [2, 2], [9, 9], [1, 1]])
    valid = torch.ones(4, dtype=torch.bool)
    before = [dict(t) for t in graphs._TALLIES]
    graphs.reset_stats()
    tpool.pool_update(p, keys, tups, valid)
    assert graphs.stats["taken"] == 1
    g = graphs.StepGraph(lambda: tpool.pool_update(p, keys, tups, valid), p)
    g.run(3)
    assert g.conds == 1 and g.launches_per_replay() == {}
    assert [dict(t) for t in graphs._TALLIES] == before


# --------------------------------------------------------------------------
# the captured train step
# --------------------------------------------------------------------------

def _train_model():
    from lookaheaddecoding_tpu_torch.training import init_opt_state
    cfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    params = tlt.init_params(cfg, seed=0, scale=0.1, device="cpu")
    return cfg, params, init_opt_state(params)


def _train_batch(seed, t=33):
    return np.random.RandomState(seed).randint(0, 128, size=(4, t))


def test_train_step_is_eager_on_the_cpu_on_a_mesh_and_inside_eager():
    """A step replays a graph only on the card, without a mesh or on an
    NCCL one, and outside ``graphs.eager()``: a gloo mesh steps eagerly;
    on the CPU it captures nothing."""
    from lookaheaddecoding_tpu_torch.training import make_train_step
    from lookaheaddecoding_tpu_torch.training import train_step
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert train_step._graphed(cuda, None)
    assert not train_step._graphed(cpu, None)
    with backends_named_by_group():
        assert not train_step._graphed(cuda, mesh_of(tp="gloo"))
    with graphs.eager():
        assert not train_step._graphed(cuda, None)
    cfg, params, opt = _train_model()
    step = make_train_step(cfg, seq_len=64)
    captured = graphs.stats["captured"]
    step(params, opt, _train_batch(0))
    assert step.graphs == {} and graphs.stats["captured"] == captured


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_captured_train_step_equals_eager(fake_cuda, optimizer):
    """Through a faked capture (the state restored after it, replays
    running the step): three steps equal three eager steps bit for bit;
    the arguments are unchanged after each call; the returned trees alias
    neither the arguments nor the static buffers; calls with the same
    shapes, fed their own results, share one graph key, and a new batch
    shape adds a second."""
    from lookaheaddecoding_tpu_torch.training import (init_opt_state,
                                                      make_train_step)
    cfg, params, _ = _train_model()
    opt = init_opt_state(params, optimizer)
    batches = [_train_batch(s) for s in range(3)]

    def run(step):
        p, o, out = params, opt, []
        for b in batches:
            kept = snapshot((p, o))
            p2, o2, loss = step(p, o, b)
            assert bit_equal(snapshot((p, o)), kept)       # unchanged
            mine = set(ptrs((p2, o2, loss)))
            assert not mine & set(ptrs((p, o)))
            for _, static in step.graphs.values():
                assert not mine & set(ptrs(static))
            p, o = p2, o2
            out.append(loss)
        return p, o, out

    step = make_train_step(cfg, seq_len=64, optimizer=optimizer)
    with graphs.eager():
        want = run(step)
    assert step.graphs == {}
    captured, replays = graphs.stats["captured"], graphs.stats["replays"]
    got = run(step)
    assert len(step.graphs) == 1
    assert graphs.stats["captured"] == captured + 1
    assert graphs.stats["replays"] == replays + 2
    assert bit_equal(graphs.state_tensors(got), graphs.state_tensors(want))
    step(got[0], got[1], _train_batch(5, t=17))
    assert len(step.graphs) == 2


@pytest.mark.parametrize("pred", [True, False])
def test_if_node_runs_its_plain_version_on_the_cpu(pred):
    """ops.graph_cond.if_node on a CPU predicate is its plain version (the
    body runs iff the predicate holds) and counts it; it takes one bool
    element only."""
    from lookaheaddecoding_tpu_torch.ops import graph_cond
    before = dict(graph_cond.counts)
    ran = []
    graph_cond.if_node(torch.tensor(pred), lambda: ran.append(1), None)
    assert ran == ([1] if pred else [])
    assert graph_cond.counts == dict(before, plain=before["plain"] + 1)
    with pytest.raises(ValueError, match="one bool element"):
        graph_cond.if_node(torch.tensor([True, False]), lambda: None, None)
