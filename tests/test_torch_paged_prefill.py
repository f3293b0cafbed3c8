"""Paged admission on the CPU: the counterpart of the JAX paged engine's
one-dispatch prepare (``PagedServingEngine._get_prepare``: lane init, the
host fill merge, the prefill ``fori_loop`` and the insertion into the
batched lanes) and of its ``"precompute"`` prepare. The port writes each
admission into an admission record (``core/paged_step.py:PagedAdmission``)
and runs its prefill as chunks that read their start from the record's
counters (``prefill_chunk``), on the card replays of one captured chunk.

- Against JAX, float32, on the same numpy weights and the same pages: the
  lane's row after one admission (table, capacity, trash slot, ``kv_len``,
  window, output buffer, counters, the n-gram pool's rows and clock) equal,
  and the K/V rows the prefill wrote, gathered through the lane's table up
  to ``kv_len``, within ``test_forward_paged_matches_jax``'s rtol 1e-4 /
  atol 2e-4; for each ``(has_fill, has_ppool)`` of JAX's prepare and prompt
  lengths 1, below C, C, C + 1 rows, several chunks across pages and a
  prompt that is its prefix (no chunk). ``precompute_prefix`` the same
  against JAX's.
- Graphed against eager, through ``torch_parallel_worker.faked_capture``
  (the warm chunk runs, the capture runs a chunk and restores its state, a
  replay runs the chunk): the lane's row, every data page of the pool and
  the admission record bit for bit, one capture and then only replays.
- No host read (``HostReads``) from the lane's choice to the first batched
  step, on a warm engine, with a prompt, a warm prefix and an int8 KV
  cache.

The card runs the capture itself (``chip_smoke.py`` phase 13,
``tests/test_torch_gpu.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu.core import pool as jpool
from lookaheaddecoding_tpu.core.serving import Request as JRequest
from lookaheaddecoding_tpu_torch.core import graphs
from lookaheaddecoding_tpu_torch.core import pool as tpool
from torch_parallel_worker import HostReads, faked_capture

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)
LCFG = dict(level=4, window_size=5, guess_set_size=4,
            window_init="order_copy_from")
# S = 27 composite rows: a prompt of at most M - S + 1 = 230 tokens
M, C, PAGE, LANES, N_NEW = 256, 16, 32, 2, 8
RTOL, ATOL = 1e-4, 2e-4     # test_torch_paged.py's forward_paged limits
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def weights():
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    params = jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                            scale=0.5))
    tcfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    return jcfg, params, tcfg, tlt.params_from_numpy(params, tcfg, "cpu")


@functools.lru_cache(maxsize=None)
def jax_engine(has_fill):
    """One JAX engine a fill setting (it compiles each prepare once), and
    its state as made, which :func:`fresh_jax` puts back."""
    jcfg, jparams, _, _ = weights()
    eng = jlt.PagedServingEngine(
        jcfg, jparams, jlt.LookaheadConfig(
            attention_impl="xla", pool_from_prompt=has_fill, **LCFG),
        jlt.EngineConfig(max_seq_len=M, prefill_chunk=C, dtype="float32"),
        num_lanes=LANES, page_size=PAGE)
    return eng, jax.device_get((eng._k_pool, eng._v_pool, eng._batched))


def fresh_jax(has_fill):
    """The JAX engine as made: pools, lanes, allocator and queues (its
    prepare donates the arrays it is given, so they are rebuilt)."""
    eng, made = jax_engine(has_fill)
    eng._k_pool, eng._v_pool, eng._batched = jax.tree.map(jnp.asarray, made)
    eng.alloc = type(eng.alloc)(eng.alloc.n_pages, eng.alloc.reserved)
    eng._meta, eng._results = {}, []
    eng._queue.clear()
    eng._iqueue.clear()
    return eng


def port_engine(has_fill=True, kv_quant=None):
    _, _, tcfg, tparams = weights()
    return tlt.PagedServingEngine(
        tcfg, tparams, tlt.LookaheadConfig(
            attention_impl="dense", pool_from_prompt=has_fill, **LCFG),
        tlt.EngineConfig(max_seq_len=M, prefill_chunk=C, dtype="float32",
                         kv_quant=kv_quant),
        num_lanes=LANES, page_size=PAGE, device="cpu")


def tokens(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 128,
                                                                size=n)]


def chunks(prompt_len, start0=0):
    return -(-max(prompt_len - 1 - start0, 0) // C)


def warm_pool(seed):
    """An n-gram pool as a carried conversation holds it: the port's fill
    of a random token run into an empty pool, as numpy (values, age,
    clock)."""
    rows = tpool.pool_table_rows(ARCH["vocab_size"], 1, 0)
    pool = tpool.pool_init(rows, LCFG["guess_set_size"],
                           LCFG["level"] - 1, "cpu")
    fill = tpool.host_prompt_fill(tokens(seed, 60), LCFG["level"],
                                  LCFG["guess_set_size"], pad_to=M,
                                  table_rows=rows)
    tpool.apply_host_fill(pool, *tpool.upload_fill(*fill, "cpu"))
    return tuple(x.numpy().copy() for x in (pool.values, pool.age,
                                            pool.clock))


def logical_rows(pool, table, n):
    """Rows [0, n) of a lane's logical cache through ``table``: every
    layer's K or V [L, Hkv, n, D], as numpy."""
    idx = (np.asarray(table, np.int64)[:, None] * PAGE
           + np.arange(PAGE)).reshape(-1)[:n]
    return np.asarray(pool)[:, :, idx]


def lane_row(states, lane):
    """Lane ``lane``'s row of batched lane states (JAX's or the port's), as
    numpy by field name."""
    out = {}
    for name in ("table", "cap", "trash", "kv_len", "window", "out_buf",
                 "n_confirmed", "init_len", "step_idx", "finished"):
        out[name] = np.asarray(getattr(states, name))[lane]
    for name in ("values", "age", "clock"):
        out["pool." + name] = np.asarray(getattr(states.pool, name))[lane]
    return out


# --------------------------------------------------------------------------
# against JAX's _get_prepare and "precompute"
# --------------------------------------------------------------------------

# name -> (prompt length, prefix length or None, warm pool, has_fill)
ADMISSIONS = {
    "one": (1, None, False, True),
    "below_C": (9, None, False, True),
    "C": (16, None, False, True),
    "C_rows": (17, None, False, True),
    "C_plus_1_rows": (18, None, False, True),
    "chunks_across_pages": (70, None, False, True),
    "no_fill": (70, None, False, False),
    "prefix": (75, 40, False, True),
    "prompt_is_prefix": (40, 40, False, True),
    "warm_prefix": (75, 40, True, True),
    "warm_prefix_no_fill": (75, 40, True, False),
}


@pytest.mark.parametrize("case", list(ADMISSIONS))
def test_admission_matches_jax_prepare(case):
    """One admission on lane 0, the port's ``_admit`` against JAX's (whose
    prepare is ``_get_prepare(has_fill, has_ppool)``): the lane's row equal
    (integers, table, pool rows and clock), and the K/V rows [0, kv_len)
    through its table, the shared prefix page's copy and the prefill's,
    within the limits. A prompt that is its prefix has no chunk; its
    prefix's tail page is copied on write all the same."""
    n, plen, warm, has_fill = ADMISSIONS[case]
    jeng, teng = fresh_jax(has_fill), port_engine(has_fill)
    p = tokens(n, n)
    kw = dict(prompt=p, max_new_tokens=N_NEW, seed=0, request_id=0)
    if plen is not None:
        p[:plen] = tokens(99, plen)
        jpx, tpx = jeng.precompute_prefix(p[:plen]), teng.precompute_prefix(
            p[:plen])
        assert jpx.pages == tpx.pages
        if warm:
            values, age, clock = warm_pool(5)
            jpx = dataclasses.replace(jpx, pool=jpool.PoolState(
                jnp.asarray(values), jnp.asarray(age), jnp.asarray(clock)))
            tpx = dataclasses.replace(tpx, pool=tpool.PoolState(
                torch.from_numpy(values), torch.from_numpy(age),
                torch.from_numpy(clock)))
        jkw, tkw = dict(kw, prefix=jpx), dict(kw, prefix=tpx)
    else:
        jkw = tkw = kw
    jeng.submit(JRequest(**jkw))
    teng.submit(tlt.Request(**tkw))
    jeng._admit()
    with torch.inference_mode():
        teng._admit()
    assert sorted(jeng._meta) == sorted(teng._meta) == [0]
    want, got = lane_row(jeng._batched, 0), lane_row(teng._states, 0)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    kv = int(got["kv_len"])
    assert kv == n - 1
    for jp, tp in ((jeng._k_pool, teng._k_pool), (jeng._v_pool, teng._v_pool)):
        np.testing.assert_allclose(
            logical_rows(tp.numpy(), got["table"], kv),
            logical_rows(jp, want["table"], kv), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("length", [1, 9, 32, 40, 70])
def test_precompute_prefix_matches_jax(length):
    """``precompute_prefix`` against JAX's ``"precompute"`` prepare (a
    prompt length of P0 + 1, lane 0's trash page, the prefix's own table):
    the same pages, and their rows [0, P0) within the limits."""
    jeng, teng = fresh_jax(True), port_engine()
    p = tokens(length + 1, length)
    jpx = jeng.precompute_prefix(p)
    tpx = teng.precompute_prefix(p)
    assert jpx.pages == tpx.pages and jpx.length == tpx.length == length
    assert np.array_equal(np.asarray(tpx.tokens), np.asarray(jpx.tokens))
    assert int(teng._rec.kv_len) == length
    for jp, tp in ((jeng._k_pool, teng._k_pool), (jeng._v_pool, teng._v_pool)):
        np.testing.assert_allclose(
            logical_rows(tp.numpy(), tpx.pages, length),
            logical_rows(jp, jpx.pages, length), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# graphed against eager (faked capture)
# --------------------------------------------------------------------------

def evict(srv, lane):
    """Undo lane ``lane``'s admission: its pages back to the allocator in
    the reverse order of their allocation (so the next admission gets the
    same pages) and the lane free."""
    meta = srv._meta.pop(lane)
    srv.alloc.release(list(reversed(meta["shared"] + meta["priv"])))
    srv._idle(lane)


def admitted(srv, req):
    """Clones of the lane's row, every data page of both pools, the
    admission record and the lane's budget and EOS ids after ``_admit`` of
    ``req`` (which must take lane 0), with ``graphs.stats`` of the call;
    then the lane is evicted."""
    graphs.reset_stats()
    srv.submit(req)
    with torch.inference_mode():
        srv._admit()
    assert list(srv._meta) == [0]
    st, trash = srv._states, LANES * PAGE
    row = [t[0].clone() for t in graphs.state_tensors(
        (st.table, st.cap, st.trash, st.kv_len, st.window, st.out_buf,
         st.n_confirmed, st.init_len, st.step_idx, st.finished, st.pool,
         srv._max_new, srv._eos))]
    pages = [t[:, :, trash:].clone()
             for t in graphs.state_tensors((srv._k_pool, srv._v_pool))]
    rec = [t.clone() for t in graphs.state_tensors(srv._rec)]
    evict(srv, 0)
    return row + pages + rec, graphs.read_stats()


def bit_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# name -> (prompt length, prefix: None, "precomputed" or "carried")
GRAPHED = {
    "one": (1, None),
    "below_C": (9, None),
    "C_rows": (17, None),
    "chunks_across_pages": (70, None),
    "prefix_copied_on_write": (75, "precomputed"),
    "prompt_is_prefix": (40, "precomputed"),
    "carried_warm_pool": (75, "carried"),
}


@pytest.mark.parametrize("case", list(GRAPHED))
def test_graphed_admission_equals_eager(case):
    """The same admission eager (``graphs.eager()``), graphed on first use
    of the chunk (its warm step, the capture, then replays) and graphed
    again (replays only), on one engine: the lane's row, the data pages
    and the admission record bit for bit."""
    n, prefix = GRAPHED[case]
    p = tokens(n, n)
    with faked_capture():
        srv = port_engine()
        px, start0 = None, 0
        if prefix == "precomputed":
            with graphs.eager():
                px = srv.precompute_prefix(p[:40])
            start0 = 40
        elif prefix == "carried":
            with graphs.eager():
                px = srv.generate(p[:30], 12, return_prefix=True).prefix
            p = list(px.tokens) + p[len(px.tokens):]
            start0 = px.length
        req = tlt.Request(prompt=p, max_new_tokens=N_NEW, prefix=px, seed=3)
        with graphs.eager():
            want, st0 = admitted(srv, req)
        first, st1 = admitted(srv, req)
        again, st2 = admitted(srv, req)
    k = chunks(len(p), start0)
    assert st0["captured"] == st0["prefills"] == 0
    assert (st1["captured"], st1["prefills"]) == (int(k > 0), max(k - 1, 0))
    assert (st2["captured"], st2["prefills"]) == (0, k)
    assert st1["replays"] == st2["replays"] == 0         # no decode step
    assert bit_equal(first, want), case
    assert bit_equal(again, want), case


@pytest.mark.parametrize("length", [9, 40, 70])
def test_graphed_precompute_prefix_equals_eager(length):
    """``precompute_prefix`` eager and graphed on one engine: the same
    pages' rows [0, P0) bit for bit, a replay a chunk of P0 + 1 rows."""
    p = tokens(length, length)
    got = {}
    with faked_capture():
        srv = port_engine()
        for which in ("eager", "first", "graphed"):
            graphs.reset_stats()
            if which == "eager":
                with graphs.eager():
                    px = srv.precompute_prefix(p)
            else:
                px = srv.precompute_prefix(p)
            rows = [torch.from_numpy(logical_rows(t.numpy(), px.pages,
                                                  length))
                    for t in (srv._k_pool, srv._v_pool)]
            got[which] = (rows, graphs.read_stats())
            srv.release_prefix(px)
    k = chunks(length + 1)
    assert got["graphed"][1]["prefills"] == k
    assert got["graphed"][1]["captured"] == 0
    assert got["first"][1]["captured"] == 1
    for which in ("first", "graphed"):
        assert bit_equal(got[which][0], got["eager"][0]), which


def test_graphed_requests_equal_eager_and_flat():
    """Requests through ``run`` on a capturing engine (its prefill chunk
    and batched step replayed) equal the same run inside ``graphs.eager()``
    and the flat ``generate``."""
    _, _, tcfg, tparams = weights()
    flat = tlt.LookaheadEngine(
        tcfg, tparams, tlt.LookaheadConfig(attention_impl="dense",
                                           pool_from_prompt=True, **LCFG),
        tlt.EngineConfig(max_seq_len=M, prefill_chunk=C, dtype="float32"),
        device="cpu")
    prompts = [tokens(20 + i, n) for i, n in enumerate((10, 70, 33, 17))]

    def reqs():
        return [tlt.Request(prompt=q, max_new_tokens=24, request_id=i)
                for i, q in enumerate(prompts)]
    with faked_capture():
        srv = port_engine()
        with graphs.eager():
            want = {r.request_id: r.tokens for r in srv.run(reqs())}
        graphs.reset_stats()
        got = {r.request_id: r.tokens for r in srv.run(reqs())}
        st = graphs.read_stats()
    assert st["prefills"] == sum(chunks(len(q)) for q in prompts) - 1
    assert st["replays"] > 0
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks)
        np.testing.assert_array_equal(
            toks, flat.generate(prompts[rid], 24).tokens)


# --------------------------------------------------------------------------
# no host read on the way to the first batched step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["prompt", "warm_prefix", "int8_kv"])
def test_admission_reads_nothing_back_to_the_host(kind):
    """From the lane's choice in ``_admit`` to the first batched step's
    runner, on a warm engine (its chunk and step captured) with another
    lane live: no op reads a value back to the host (``item``, a
    data-dependent shape): the uploads into the admission record and of
    the EOS ids, the pool's reset or warm copy, the copy on write, the
    merging fill, the lane's row, the prefill replays (through the int8
    cache's quantizing write) and ``kv_len``."""
    p = tokens(12, 50)
    with faked_capture():
        srv = port_engine(kv_quant="int8" if kind == "int8_kv" else None)
        px = None
        if kind == "warm_prefix":
            px = srv.generate(p[:30], 12, return_prefix=True).prefix
            p = list(px.tokens) + p[len(px.tokens):]
        srv.generate(p, 12, prefix=px)              # captures
        srv.submit(tlt.Request(prompt=tokens(13, 20), max_new_tokens=40))
        srv.step()                                  # lane 0 live
        srv.submit(tlt.Request(prompt=p, max_new_tokens=N_NEW, prefix=px,
                               eos_token_id=[3, 4]))
        with torch.inference_mode(), HostReads() as mode:
            srv._admit()
            srv._runner()
        assert sorted(srv._meta) == [0, 1]
    assert mode.seen == []
