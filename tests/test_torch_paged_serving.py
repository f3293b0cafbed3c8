"""The port's PagedServingEngine on the CPU, in float32: tokens and step
counts against the JAX PagedServingEngine on the same numpy weights and
against the port's own flat ``generate``. The window is seeded with
``order_copy_from``, since the default draws from each framework's own
generator."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu.core.serving import Request as JRequest
from lookaheaddecoding_tpu_torch.core.paged import OutOfPages
from lookaheaddecoding_tpu_torch.ops import lookahead_attention as tla

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)
# tiny models gain nothing from intra-op threads, and several test workers
# each with a full thread pool contend for the same cores
torch.set_num_threads(1)

LCFG = dict(level=4, window_size=5, guess_set_size=4, pool_from_prompt=True,
            window_init="order_copy_from")


@functools.lru_cache(maxsize=None)
def weights():
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    params = jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                            scale=0.5))
    tcfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    return jcfg, params, tcfg, tlt.params_from_numpy(params, tcfg, "cpu")


@functools.lru_cache(maxsize=None)
def jax_engine(kv_quant, page_size, num_lanes, n_pages, steps_per_sync):
    """One JAX engine a configuration (it compiles its steps anew for each
    instance); every test leaves it with all lanes idle and all pages free."""
    jcfg, jparams, _, _ = weights()
    return jlt.PagedServingEngine(
        jcfg, jparams, jlt.LookaheadConfig(attention_impl="xla", **LCFG),
        jlt.EngineConfig(max_seq_len=256, prefill_chunk=16, dtype="float32",
                         kv_quant=kv_quant),
        num_lanes=num_lanes, page_size=page_size, n_pages=n_pages,
        steps_per_sync=steps_per_sync)


def engines(kv_quant=None, page_size=64, num_lanes=2, n_pages=None,
            steps_per_sync=1, want_jax=True, port_impl="dense"):
    """(JAX paged engine or None, port flat engine, port paged engine)."""
    _, _, tcfg, tparams = weights()
    lkw = dict(LCFG)
    ekw = dict(max_seq_len=256, prefill_chunk=16, dtype="float32",
               kv_quant=kv_quant)
    pkw = dict(num_lanes=num_lanes, page_size=page_size, n_pages=n_pages,
               steps_per_sync=steps_per_sync)
    jeng = None
    if want_jax:
        jeng = jax_engine(kv_quant, page_size, num_lanes, n_pages,
                          steps_per_sync)
    flat = tlt.LookaheadEngine(
        tcfg, tparams, tlt.LookaheadConfig(attention_impl=port_impl, **lkw),
        tlt.EngineConfig(**ekw), device="cpu")
    paged = tlt.PagedServingEngine(
        tcfg, tparams, tlt.LookaheadConfig(attention_impl=port_impl, **lkw),
        tlt.EngineConfig(**ekw), device="cpu", **pkw)
    return jeng, flat, paged


def prompts(n, sizes=(10, 23, 17, 9)):
    rng = np.random.RandomState(3)
    return [list(rng.randint(0, 128, size=sizes[i % len(sizes)]))
            for i in range(n)]


def run_both(jeng, paged, reqs):
    """The same requests through the JAX engine (when given) and the
    port's; results by request id."""
    got = {r.request_id: r for r in paged.run(
        [tlt.Request(**kw) for kw in reqs])}
    want = None
    if jeng is not None:
        want = {r.request_id: r for r in jeng.run(
            [JRequest(**kw) for kw in reqs])}
        assert set(want) == set(got)
        for rid, w in want.items():
            np.testing.assert_array_equal(got[rid].tokens, w.tokens)
            assert got[rid].steps == w.steps, rid
            assert (got[rid].error is None) == (w.error is None)
    return got, want


def assert_equals_flat(flat, got, reqs):
    for kw in reqs:
        single = flat.generate(kw["prompt"], kw["max_new_tokens"],
                               eos_token_id=kw.get("eos_token_id"),
                               seed=kw.get("seed", 0))
        np.testing.assert_array_equal(got[kw["request_id"]].tokens,
                                      single.tokens)
        assert got[kw["request_id"]].steps == single.steps


# --------------------------------------------------------------------------
# tokens and steps: JAX paged == port paged == port flat
# --------------------------------------------------------------------------

def test_one_lane_matches_jax_and_flat():
    jeng, flat, paged = engines(num_lanes=1)
    reqs = [dict(prompt=p, max_new_tokens=40, seed=i, request_id=i)
            for i, p in enumerate(prompts(3))]
    got, _ = run_both(jeng, paged, reqs)
    assert_equals_flat(flat, got, reqs)
    assert paged.pages_free == paged.memory_stats()["pages_total"]


def test_more_requests_than_lanes_match_jax_and_flat():
    jeng, flat, paged = engines(num_lanes=4)
    reqs = [dict(prompt=p, max_new_tokens=24, seed=i, request_id=i)
            for i, p in enumerate(prompts(6))]
    got, _ = run_both(jeng, paged, reqs)
    assert len(got) == 6
    assert_equals_flat(flat, got, reqs)
    assert paged.pages_free == paged.memory_stats()["pages_total"]
    stats, jstats = paged.memory_stats(), jeng.memory_stats()
    assert stats == jstats


def test_int8_kv_matches_jax_and_flat():
    jeng, flat, paged = engines(kv_quant="int8")
    reqs = [dict(prompt=p, max_new_tokens=32, seed=i, request_id=i)
            for i, p in enumerate(prompts(3))]
    got, _ = run_both(jeng, paged, reqs)
    assert_equals_flat(flat, got, reqs)


def test_eos_and_capacity_stop_match_jax_and_flat():
    jeng, flat, paged = engines()
    p = prompts(1)[0]
    eos = int(flat.generate(p, 40).tokens[len(p) + 5])
    reqs = [dict(prompt=p, max_new_tokens=40, eos_token_id=eos,
                 request_id="eos"),
            dict(prompt=p, max_new_tokens=40, eos_token_id=[eos, 3],
                 request_id="two_eos"),
            # max_new past the logical bound: both stop at the KV budget
            dict(prompt=p, max_new_tokens=10_000, seed=1, request_id="cap")]
    got, _ = run_both(jeng, paged, reqs)
    assert_equals_flat(flat, got, reqs)
    assert got["eos"].num_generated <= 6
    assert got["cap"].num_generated < 10_000


def test_uneven_page_size_and_long_prompt_match_jax_and_flat():
    """A prompt that crosses many page boundaries (prefill chunks, the
    padded last chunk writing to the trash page)."""
    jeng, flat, paged = engines(page_size=32)
    p = list(np.random.RandomState(9).randint(0, 128, size=130))
    reqs = [dict(prompt=p, max_new_tokens=48, request_id=0)]
    got, _ = run_both(jeng, paged, reqs)
    assert_equals_flat(flat, got, reqs)


def test_prefix_sharing_with_partial_tail_page():
    jeng, flat, paged = engines(num_lanes=2, page_size=64)
    system = list(np.random.RandomState(7).randint(0, 128, size=70))
    px, jpx = paged.precompute_prefix(system), jeng.precompute_prefix(system)
    assert len(px.pages) == 2 and px.pages == jpx.pages
    used0 = paged.alloc.used_pages
    ps = [system + list(np.random.RandomState(s).randint(0, 128, size=8))
          for s in (1, 2)]
    reqs = [dict(prompt=p, max_new_tokens=20, seed=i, request_id=i)
            for i, p in enumerate(ps)]
    got = {r.request_id: r for r in paged.run(
        [tlt.Request(prefix=px, **kw) for kw in reqs])}
    want = {r.request_id: r for r in jeng.run(
        [JRequest(prefix=jpx, **kw) for kw in reqs])}
    for i in (0, 1):
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
        assert got[i].steps == want[i].steps
    assert_equals_flat(flat, got, reqs)
    # all lane pages came back; the prefix still owns its own
    assert paged.alloc.used_pages == used0
    paged.release_prefix(px)
    jeng.release_prefix(jpx)
    assert paged.alloc.used_pages == 0 and jeng.alloc.used_pages == 0
    with pytest.raises(ValueError, match="does not start with"):
        paged.generate(ps[0][1:], 4, prefix=paged.precompute_prefix(system))


def test_conversation_carry_matches_jax_and_flat():
    jeng, flat, paged = engines(num_lanes=2, page_size=64)
    p = prompts(1)[0]
    r1 = paged.generate(p, 24, return_prefix=True)
    j1 = jeng.generate(p, 24, return_prefix=True)
    np.testing.assert_array_equal(r1.tokens, j1.tokens)
    assert r1.prefix.length == j1.prefix.length
    assert r1.prefix.pool is not None
    assert len(r1.prefix.pages) == -(-r1.prefix.length // 64)
    # the carried warm pool equals JAX's
    np.testing.assert_array_equal(r1.prefix.pool.values[:128].numpy(),
                                  np.asarray(j1.prefix.pool.values)[:128])
    np.testing.assert_array_equal(r1.prefix.pool.age[:128].numpy(),
                                  np.asarray(j1.prefix.pool.age)[:128])
    turn2 = list(r1.prefix.tokens) + list(
        np.random.RandomState(4).randint(0, 128, size=6))
    r2 = paged.generate(turn2, 24, seed=1, prefix=r1.prefix)
    j2 = jeng.generate(turn2, 24, seed=1, prefix=j1.prefix)
    np.testing.assert_array_equal(r2.tokens, j2.tokens)
    assert r2.steps == j2.steps
    np.testing.assert_array_equal(r2.tokens,
                                  flat.generate(turn2, 24, seed=1).tokens)
    paged.release_prefix(r1.prefix)
    jeng.release_prefix(j1.prefix)
    assert paged.alloc.used_pages == 0 and jeng.alloc.used_pages == 0


def test_admission_backpressure_serves_every_request():
    jeng, flat, paged = engines(num_lanes=2, page_size=64, n_pages=3)
    # two pages a request, three in the pool: the second lane has to wait
    reqs = [dict(prompt=p, max_new_tokens=40, seed=i, request_id=i)
            for i, p in enumerate(prompts(4))]
    got, _ = run_both(jeng, paged, reqs)
    assert len(got) == 4 and all(r.error is None for r in got.values())
    assert_equals_flat(flat, got, reqs)
    assert paged.admission_waits > 0          # a request did wait
    assert paged.pages_free == 3              # every page back in the pool


def test_oversized_and_malformed_requests_fail_alone():
    jeng, _, paged = engines(num_lanes=2, page_size=64, n_pages=2)
    ps = prompts(2)
    reqs = [dict(prompt=ps[0], max_new_tokens=200, request_id="big"),
            dict(prompt=[], max_new_tokens=4, request_id="empty"),
            dict(prompt=ps[1], max_new_tokens=0, request_id="zero"),
            dict(prompt=ps[1], max_new_tokens=8, request_id="ok")]
    got, want = run_both(jeng, paged, reqs)
    assert "pages" in got["big"].error and "pages" in want["big"].error
    assert "empty prompt" in got["empty"].error
    assert "max_new_tokens" in got["zero"].error
    assert got["ok"].error is None and got["ok"].num_generated == 8
    # port only: an id outside the vocabulary would be a device assert
    bad = paged.run([tlt.Request(prompt=[1, 128], max_new_tokens=4),
                     tlt.Request(prompt=[1, 2], max_new_tokens=4,
                                 temperature=0.7)])
    assert "[0, 128)" in bad[0].error and "greedy" in bad[1].error
    with pytest.raises(ValueError, match="empty prompt"):
        paged.generate([], 4)


def test_streaming_delivers_every_token_once():
    jeng, flat, paged = engines(num_lanes=2, steps_per_sync=2)
    p = prompts(1)[0]
    single = flat.generate(p, 24)
    got, jgot = [], []
    res = paged.run([tlt.Request(prompt=p, max_new_tokens=24,
                                 on_tokens=got.append)])[0]
    jeng.run([JRequest(prompt=p, max_new_tokens=24, on_tokens=jgot.append)])
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(p), np.concatenate(got)]), single.tokens)
    assert len(got) > 1                       # incremental
    assert [len(c) for c in got] == [len(c) for c in jgot]
    np.testing.assert_array_equal(res.tokens, single.tokens)
    assert res.ttft_s is not None and res.latency_s >= res.ttft_s


def test_interactive_class_jumps_the_queue():
    _, flat, paged = engines(num_lanes=2, n_pages=3, want_jax=False)
    chat_p = prompts(1, sizes=(12,))[0]
    for i, p in enumerate(prompts(5)):
        paged.submit(tlt.Request(prompt=p, max_new_tokens=16, seed=i,
                                 request_id=i))
    paged.submit(tlt.Request(prompt=chat_p, max_new_tokens=16, seed=99,
                             request_id="chat", interactive=True))
    paged.step()
    assert "chat" in {m["req"].request_id for m in paged._meta.values()}
    while paged.step():
        pass
    results, paged._results = paged._results, []
    by_id = {r.request_id: r for r in results}
    assert len(results) == 6
    np.testing.assert_array_equal(by_id["chat"].tokens,
                                  flat.generate(chat_p, 16, seed=99).tokens)


def test_release_prefix_while_lanes_are_active():
    """Releasing a prefix while requests that use it are in flight must not
    free shared pages under them: the lanes' references hold."""
    _, flat, paged = engines(num_lanes=2, page_size=64, want_jax=False)
    system = list(np.random.RandomState(7).randint(0, 128, size=70))
    px = paged.precompute_prefix(system)
    ps = [system + list(np.random.RandomState(s).randint(0, 128, size=8))
          for s in (1, 2)]
    for i, p in enumerate(ps):
        paged.submit(tlt.Request(prompt=p, max_new_tokens=20, seed=i,
                                 request_id=i, prefix=px))
    paged.step()                       # both admitted, sharing px's page
    paged.release_prefix(px)
    assert paged.alloc.used_pages > 0
    while paged.step():
        pass
    results, paged._results = paged._results, []
    for r in results:
        np.testing.assert_array_equal(
            r.tokens, flat.generate(ps[r.request_id], 20,
                                    seed=r.request_id).tokens)
    assert paged.alloc.used_pages == 0


def test_prefix_ending_on_a_page_boundary_is_copied_on_write():
    """Port only (a fault of the reference): a prompt that is exactly a
    prefix whose length is a multiple of the page size starts decoding at
    ``kv_len = length - 1``, inside the last shared page, and the first
    step writes there. The port gives the lane its own copy of that page:
    the prefix's pages keep their bytes, and a second and a concurrent
    request on the same prefix still get the flat engine's tokens."""
    _, flat, paged = engines(num_lanes=2, page_size=32, want_jax=False)
    system = list(np.random.RandomState(11).randint(0, 128, size=64))
    px = paged.precompute_prefix(system)
    assert len(px.pages) == 2

    def prefix_bytes():
        lo, hi = px.pages[1] * 32, (px.pages[1] + 1) * 32
        return (paged._k_pool[:, :, lo:hi].clone(),
                paged._v_pool[:, :, lo:hi].clone())
    before = prefix_bytes()
    want = flat.generate(system, 20).tokens
    first = paged.generate(system, 20, prefix=px)
    np.testing.assert_array_equal(first.tokens, want)
    for a, b in zip(before, prefix_bytes()):
        assert torch.equal(a, b)             # the shared page was not written
    both = paged.run([tlt.Request(prompt=system, max_new_tokens=20,
                                  prefix=px, request_id=i) for i in (0, 1)])
    for r in both:
        np.testing.assert_array_equal(r.tokens, want)
    longer = system + [5, 6, 7]
    np.testing.assert_array_equal(
        paged.generate(longer, 12, prefix=px).tokens,
        flat.generate(longer, 12).tokens)
    paged.release_prefix(px)
    assert paged.alloc.used_pages == 0


def test_no_live_lane_writes_a_slot_twice_or_another_lanes_page(monkeypatch):
    """Every scatter into the shared pool: duplicate destination slots lie
    in trash pages only, and a lane's table names only the pages it owns,
    the pages it shares and its own trash page."""
    from lookaheaddecoding_tpu_torch.core import paged as tpaged
    _, _, paged = engines(num_lanes=3, page_size=32, want_jax=False)
    trash_slots = paged.num_lanes * paged.page_size
    seen = []

    def check(slots):
        live = slots[slots >= trash_slots]
        assert live.unique().numel() == live.numel()
        seen.append(int(live.numel()))

    write, commit = tpaged.paged_write, tpaged.paged_commit
    # forward_paged looks paged_write up at each call; the step module
    # holds its own name for paged_commit
    monkeypatch.setattr(
        tpaged, "paged_write",
        lambda buf, slots, new: (check(slots), write(buf, slots, new))[1])
    monkeypatch.setattr(
        "lookaheaddecoding_tpu_torch.core.paged_step.paged_commit",
        lambda buf, src, dst: (check(dst), commit(buf, src, dst))[1])
    for i, p in enumerate(prompts(5)):
        paged.submit(tlt.Request(prompt=p, max_new_tokens=30, seed=i,
                                 request_id=i))
    more = True
    while more:
        more = paged.step()
        tables = paged._states.table.numpy()
        owned = [set(m["priv"]) for m in paged._meta.values()]
        assert sum(len(o) for o in owned) == len(set().union(*owned))
        for lane, m in paged._meta.items():
            assert set(tables[lane].tolist()) <= (
                set(m["priv"]) | set(m["shared"]) | {lane})
        for lane in set(range(paged.num_lanes)) - set(paged._meta):
            assert set(tables[lane].tolist()) == {lane}
    assert sum(seen) > 0 and paged.alloc.used_pages == 0


# --------------------------------------------------------------------------
# the batched step's state against JAX's, step by step
# --------------------------------------------------------------------------

def test_lane_state_equals_jax_after_each_step():
    jeng, _, paged = engines(num_lanes=2, page_size=32)
    # the JAX engine is shared between tests: its pages are all free, but
    # in the order earlier requests returned them; a new allocator hands
    # them out in the order the port's new engine does
    assert jeng.alloc.used_pages == 0
    jeng.alloc = type(jeng.alloc)(jeng.alloc.n_pages, jeng.alloc.reserved)
    for i, p in enumerate(prompts(3)):
        kw = dict(prompt=p, max_new_tokens=30, seed=i, request_id=i)
        jeng.submit(JRequest(**kw))
        paged.submit(tlt.Request(**kw))
    for step in range(12):
        more_j, more_t = jeng.step(), paged.step()
        assert more_j == more_t
        js, ts = jeng._batched, paged._states
        for name in ("table", "cap", "trash", "kv_len", "n_confirmed",
                     "init_len", "step_idx", "finished"):
            np.testing.assert_array_equal(
                getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                err_msg=f"{name} after step {step}")
        active = sorted(paged._meta)
        assert active == sorted(jeng._meta)
        for lane in active:
            n = int(ts.n_confirmed[lane])
            np.testing.assert_array_equal(ts.window[lane].numpy(),
                                          np.asarray(js.window)[lane])
            np.testing.assert_array_equal(
                ts.out_buf[lane, :n].numpy(),
                np.asarray(js.out_buf)[lane, :n])
            np.testing.assert_array_equal(
                ts.pool.values[lane, :128].numpy(),
                np.asarray(js.pool.values)[lane, :128])
            np.testing.assert_array_equal(
                ts.pool.age[lane, :128].numpy(),
                np.asarray(js.pool.age)[lane, :128])
            assert int(ts.pool.clock[lane]) == int(js.pool.clock[lane])
        if not more_t:
            break


# --------------------------------------------------------------------------
# build checks and modes
# --------------------------------------------------------------------------

def test_rejected_modes_raise_as_in_jax():
    jcfg, jparams, tcfg, tparams = weights()
    lc = tlt.LookaheadConfig(**LCFG)
    ec = tlt.EngineConfig(max_seq_len=256)
    with pytest.raises(ValueError, match="dynamic"):
        tlt.PagedServingEngine(
            tlt.LlamaConfig(**ARCH, rope_scaling=("dynamic", 2.0),
                            dtype=torch.float32), tparams, lc, ec,
            device="cpu")
    with pytest.raises(ValueError, match="single-chip"):
        tlt.PagedServingEngine(tcfg, tparams, lc,
                               tlt.EngineConfig(max_seq_len=256, tp=2),
                               device="cpu")
    with pytest.raises(ValueError, match="max_seq_len too small"):
        tlt.PagedServingEngine(tcfg, tparams, lc,
                               tlt.EngineConfig(max_seq_len=30), device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        tlt.PagedServingEngine(tcfg, tparams, lc, ec, page_size=2,
                               device="cpu")
    with pytest.raises(ValueError, match="more pages"):
        tlt.PagedServingEngine(tcfg, tparams, lc, ec, n_pages=0,
                               device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        tlt.PagedServingEngine(tcfg, tparams, lc, ec, device="cpu",
                               sampling=tlt.SamplingConfig(temperature=0.8))
    eng = tlt.PagedServingEngine(tcfg, tparams, lc, ec, device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        eng._fns.sample_batch()
    with pytest.raises(ValueError, match="leaves no room"):
        eng.precompute_prefix(list(range(100)) * 3)
    with pytest.raises(ValueError, match="empty prefix"):
        eng.precompute_prefix([])


def test_engine_needs_cuda_unless_cpu_is_asked(monkeypatch):
    _, _, tcfg, tparams = weights()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlt.PagedServingEngine(tcfg, tparams)
    eng = tlt.PagedServingEngine(tcfg, tparams, device="cpu")
    assert eng.lcfg.attention_impl == "dense"     # "auto" on the CPU


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_card_never_falls_back_to_the_dense_path(monkeypatch, impl):
    _, _, tcfg, tparams = weights()               # head_dim 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="head_dim"):
        tlt.PagedServingEngine(tcfg, tparams,
                               tlt.LookaheadConfig(attention_impl=impl))


def test_kernel_path_on_the_cpu_goes_through_the_paged_wrapper():
    """``attention_impl="kernel"`` on CPU tensors runs the wrapper's plain
    version (and counts it): same tokens as the dense path."""
    _, flat, paged = engines(num_lanes=2, want_jax=False, port_impl="kernel")
    before = tla.paged_counts["plain"]
    p = prompts(1)[0]
    np.testing.assert_array_equal(paged.generate(p, 16).tokens,
                                  flat.generate(p, 16).tokens)
    assert tla.paged_counts["plain"] > before
    assert tla.paged_counts["kernel"] == 0


def test_out_of_pages_is_exported_for_callers():
    assert issubclass(OutOfPages, Exception)
    assert tlt.PagedPrefix and tlt.Request
