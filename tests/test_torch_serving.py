"""The port's ContinuousBatchingEngine against the JAX package's, on the
model of tests/test_serving.py (one counterpart for each of its tests), at
float32 on the CPU.

Greedy cases run the same requests through both schedulers: every
request's tokens, prompt_len and steps must be equal (matched by
request_id), and a request fails in one exactly when it fails in the
other. The window is seeded with ``order_copy_from`` so that steps compare
(``copy_from`` draws from each framework's own generator). Where the JAX
test checks scheduling state (the lanes in ``_active``), the port's state
after the same calls must equal JAX's. Sampled tokens come from torch
generators, so sampling cases are held against the port's own lone
``generate_sample`` with the same seed and warpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu.core.serving import (
    ContinuousBatchingEngine as JaxCBE, Request as JaxRequest)
from lookaheaddecoding_tpu_torch import ContinuousBatchingEngine, Request

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)
LCFG = dict(level=4, window_size=5, guess_set_size=4, pool_from_prompt=True)
ECFG = dict(max_seq_len=256, prefill_chunk=16, dtype="float32")


def port_engine(tree, window_init="order_copy_from"):
    tcfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    return tlt.LookaheadEngine(
        tcfg, tlt.params_from_numpy(tree, tcfg, "cpu"),
        tlt.LookaheadConfig(window_init=window_init, **LCFG),
        tlt.EngineConfig(**ECFG), device="cpu")


@pytest.fixture(scope="module")
def engines():
    """tests/test_serving.py's tiny_engine model in both frameworks (one
    pair for the module: the JAX engine's compiled calls are reused)."""
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    jparams = jlt.init_params(jcfg, jax.random.PRNGKey(0), scale=0.5)
    tree = jax.device_get(jparams)
    jeng = jlt.LookaheadEngine(
        jcfg, jparams,
        jlt.LookaheadConfig(window_init="order_copy_from", **LCFG),
        jlt.EngineConfig(**ECFG))
    return jeng, port_engine(tree), tree


def prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, 128, size=n)) for n in sizes]


def run_both(engines, reqs, **kw):
    """The request dicts through JAX's scheduler and the port's with the
    same arguments; returns (jax results, port results) by request_id."""
    jeng, teng, _ = engines
    jres = JaxCBE(jeng, **kw).run([JaxRequest(**r) for r in reqs])
    tres = ContinuousBatchingEngine(teng, **kw).run(
        [Request(**r) for r in reqs])
    return ({r.request_id: r for r in jres}, {r.request_id: r for r in tres})


def assert_same(jres, tres):
    """Equal ids; the error set in both or in neither; otherwise equal
    tokens, prompt_len and steps."""
    assert set(jres) == set(tres)
    for rid, want in jres.items():
        got = tres[rid]
        assert (got.error is None) == (want.error is None), (rid, got.error,
                                                              want.error)
        if want.error is None:
            np.testing.assert_array_equal(got.tokens, want.tokens,
                                          err_msg=str(rid))
            assert got.prompt_len == want.prompt_len, rid
            assert got.steps == want.steps, rid


def equal_lone(teng, res, reqs):
    """Each greedy result equals the port's lone ``generate``."""
    for r in reqs:
        one = teng.generate(r["prompt"], r["max_new_tokens"],
                            seed=r.get("seed", 0))
        np.testing.assert_array_equal(res[r["request_id"]].tokens, one.tokens)


def test_continuous_batching_matches_individual(engines):
    ps = prompts(3, (10, 13, 9, 11, 8))          # 5 requests > 2 lanes
    reqs = [dict(prompt=p, max_new_tokens=m, seed=i, request_id=i)
            for i, (p, m) in enumerate(zip(ps, [20, 35, 12, 28, 16]))]
    jres, tres = run_both(engines, reqs, num_lanes=2)
    assert len(tres) == 5
    assert_same(jres, tres)
    equal_lone(engines[1], tres, reqs)


@pytest.mark.parametrize("kw", [
    dict(objective="fairness", num_lanes=2, steps_per_sync=1),
    dict(objective="throughput"),
    dict(objective="throughput", batch_group=2)],
    ids=["fairness", "throughput", "batch_group"])
def test_latency_accounting_fields(engines, kw):
    """TTFT and latency anchored at submit under every objective, TTFT no
    more than latency, and below it for laned multi-step requests; tokens
    and steps equal JAX's."""
    reqs = [dict(prompt=p, max_new_tokens=24, seed=i, request_id=i)
            for i, p in enumerate(prompts(7, (10,) * 4))]
    jres, tres = run_both(engines, reqs, **kw)
    assert_same(jres, tres)
    for r in tres.values():
        assert r.error is None
        assert r.ttft_s is not None and r.latency_s is not None
        assert 0 < r.ttft_s <= r.latency_s + 1e-9
        if kw["objective"] == "fairness":
            assert r.ttft_s < r.latency_s


def test_bad_request_fails_gracefully_without_killing_lanes(engines):
    good, oversized = prompts(5, (10, 300))          # 300 > max_seq_len
    reqs = [dict(prompt=good, max_new_tokens=12, request_id="ok"),
            dict(prompt=oversized, max_new_tokens=12, request_id="bad"),
            dict(prompt=good, max_new_tokens=8, request_id="ok2")]
    jres, tres = run_both(engines, reqs, num_lanes=2)
    assert_same(jres, tres)
    assert tres["bad"].error and "exceeds" in tres["bad"].error
    assert tres["ok"].num_generated == 12 and tres["ok2"].num_generated == 8


def test_bad_eos_and_sampling_params_fail_only_that_request(engines):
    _, teng, _ = engines
    good = prompts(6, (10,))[0]
    reqs = [dict(prompt=good, max_new_tokens=10, request_id="ok"),
            dict(prompt=good, max_new_tokens=10, request_id="bad_eos",
                 eos_token_id=[1, 2, 3, 4, 5])]
    jres, tres = run_both(engines, reqs, num_lanes=2)
    assert_same(jres, tres)
    assert "eos" in tres["bad_eos"].error

    scfg = tlt.SamplingConfig(temperature=1.0)
    res = {r.request_id: r for r in ContinuousBatchingEngine(
        teng, num_lanes=2, sampling=scfg).run([
            Request(prompt=good, max_new_tokens=10, request_id="ok", seed=1),
            Request(prompt=good, max_new_tokens=10, request_id="bad_temp",
                    temperature=0.0),
            Request(prompt=good, max_new_tokens=10, request_id="bad_topp",
                    top_p=0.0)])}
    assert "temperature" in res["bad_temp"].error
    assert "top_p" in res["bad_topp"].error
    assert res["ok"].error is None and res["ok"].num_generated == 10
    np.testing.assert_array_equal(
        res["ok"].tokens, teng.generate_sample(good, 10, scfg, seed=1).tokens)


def test_continuous_batching_incremental_submit(engines):
    jeng, teng, _ = engines
    p1, p2 = prompts(4, (10, 12))
    out = []
    for eng, cbe, req in ((jeng, JaxCBE, JaxRequest),
                          (teng, ContinuousBatchingEngine, Request)):
        server = cbe(eng, num_lanes=2)
        server.submit(req(prompt=p1, max_new_tokens=25, request_id="a"))
        for _ in range(3):
            server.step()
        server.submit(req(prompt=p2, max_new_tokens=10, request_id="b"))
        while server.step():
            pass
        out.append({r.request_id: r for r in server._results})
    assert set(out[1]) == {"a", "b"}
    assert_same(*out)
    np.testing.assert_array_equal(out[1]["a"].tokens,
                                  teng.generate(p1, 25).tokens)


def test_continuous_batching_sampling_lanes_match_individual(engines):
    """Sampling lanes with a temperature a request equal the port's lone
    generate_sample with the same seed and warpers."""
    _, teng, _ = engines
    ps = prompts(7, (10, 12, 9))
    temps = [0.7, 1.0, 1.3]
    scfg = tlt.SamplingConfig(temperature=1.0, top_p=0.9)
    res = {r.request_id: r for r in ContinuousBatchingEngine(
        teng, num_lanes=2, sampling=scfg).run([
            Request(prompt=p, max_new_tokens=24, seed=i, request_id=i,
                    temperature=t) for i, (p, t) in enumerate(zip(ps, temps))])}
    for i, (p, t) in enumerate(zip(ps, temps)):
        one = teng.generate_sample(
            p, 24, tlt.SamplingConfig(temperature=t, top_p=0.9), seed=i)
        np.testing.assert_array_equal(res[i].tokens, one.tokens)
        assert res[i].steps == one.steps


def test_greedy_engine_rejects_sampling_overrides(engines):
    good = prompts(11, (10,))[0]
    reqs = [dict(prompt=good, max_new_tokens=8, request_id="plain"),
            dict(prompt=good, max_new_tokens=8, request_id="sampled",
                 temperature=0.7),
            dict(prompt=good, max_new_tokens=8, request_id="topp",
                 top_p=0.9)]
    jres, tres = run_both(engines, reqs, num_lanes=2)
    assert_same(jres, tres)
    assert "SamplingConfig" in tres["sampled"].error
    assert "SamplingConfig" in tres["topp"].error


def test_throughput_objective_matches_individual(engines):
    reqs = [dict(prompt=p, max_new_tokens=m, seed=i, request_id=i)
            for i, (p, m) in enumerate(zip(prompts(7, (10, 13, 9)),
                                           [20, 12, 16]))]
    jres, tres = run_both(engines, reqs, objective="throughput")
    assert len(tres) == 3
    assert_same(jres, tres)


def test_throughput_batch_group_matches_individual(engines):
    reqs = [dict(prompt=p, max_new_tokens=14, request_id=i)
            for i, p in enumerate(prompts(8, (10, 12, 9, 11)))]
    jres, tres = run_both(engines, reqs, objective="throughput",
                          batch_group=2)
    assert_same(jres, tres)
    equal_lone(engines[1], tres, reqs)


def test_throughput_bad_request_fails_alone(engines):
    good, oversized = prompts(9, (10, 300))
    reqs = [dict(prompt=good, max_new_tokens=10, request_id="ok"),
            dict(prompt=oversized, max_new_tokens=10, request_id="bad"),
            dict(prompt=good, max_new_tokens=6, request_id="ok2")]
    jres, tres = run_both(engines, reqs, objective="throughput",
                          batch_group=2)
    assert_same(jres, tres)
    assert "exceeds" in tres["bad"].error
    assert tres["ok"].num_generated == 10 and tres["ok2"].num_generated == 6


def test_throughput_sampling_matches_individual(engines):
    _, teng, _ = engines
    sampling = tlt.SamplingConfig(temperature=0.9, top_p=0.95)
    ps = prompts(10, (10, 12))
    res = {r.request_id: r for r in ContinuousBatchingEngine(
        teng, objective="throughput", sampling=sampling).run([
            Request(prompt=p, max_new_tokens=12, seed=i + 1, request_id=i)
            for i, p in enumerate(ps)])}
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(
            res[i].tokens,
            teng.generate_sample(p, 12, sampling, seed=i + 1).tokens)


@pytest.mark.parametrize("kw,match", [
    (dict(objective="latency"), "objective"),
    (dict(batch_group=0), "batch_group"),
    (dict(num_lanes=0), "num_lanes")])
def test_objective_validation(engines, kw, match):
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine(engines[1], **kw)


def test_throughput_batch_group_sampling_matches_individual(engines):
    """A fused sampling group through generate_batch with a seed and a
    temperature a request (None: the engine's) equals the lone calls."""
    _, teng, _ = engines
    scfg = tlt.SamplingConfig(temperature=0.8, top_k=16)
    ps = prompts(21, (10,) * 4)
    temps = [0.8, 1.1, 0.8, 0.6]
    res = {r.request_id: r for r in ContinuousBatchingEngine(
        teng, objective="throughput", batch_group=4, sampling=scfg).run([
            Request(prompt=p, max_new_tokens=12, seed=i, request_id=i,
                    temperature=None if t == 0.8 else t)
            for i, (p, t) in enumerate(zip(ps, temps))])}
    for i, (p, t) in enumerate(zip(ps, temps)):
        one = teng.generate_sample(
            p, 12, tlt.SamplingConfig(temperature=t, top_k=16), seed=i)
        np.testing.assert_array_equal(res[i].tokens, one.tokens)


def test_batch_group_rejects_sampling_overrides_in_greedy_mode(engines):
    good = prompts(12, (10,))[0]
    reqs = [dict(prompt=good, max_new_tokens=8, request_id="a",
                 temperature=0.7),
            dict(prompt=good, max_new_tokens=8, request_id="b")]
    jres, tres = run_both(engines, reqs, objective="throughput",
                          batch_group=2)
    assert_same(jres, tres)
    assert "SamplingConfig" in tres["a"].error
    assert tres["b"].num_generated == 8


def test_batch_group_honors_per_request_seeds(engines):
    """Grouped requests equal JAX's (tokens and steps), and on an engine
    that seeds the window from its generator (``copy_from``) each group
    lane takes the steps of the lone call with its own seed."""
    ps = prompts(13, (11, 11))
    seeds = [100, 7]
    reqs = [dict(prompt=p, max_new_tokens=14, seed=s, request_id=i)
            for i, (p, s) in enumerate(zip(ps, seeds))]
    jres, tres = run_both(engines, reqs, objective="throughput",
                          batch_group=2)
    assert_same(jres, tres)
    seeded = port_engine(engines[2], window_init="copy_from")
    res = {r.request_id: r for r in ContinuousBatchingEngine(
        seeded, objective="throughput", batch_group=2).run(
            [Request(**r) for r in reqs])}
    for i, (p, s) in enumerate(zip(ps, seeds)):
        one = seeded.generate(p, 14, seed=s)
        np.testing.assert_array_equal(res[i].tokens, one.tokens)
        assert res[i].steps == one.steps


def test_adaptive_matches_individual_deep_queue(engines):
    """The overflow of a backlog deeper than the lanes drains fused (TTFT
    equals latency), the last requests go to the lanes (TTFT below
    latency); every result equals JAX's."""
    reqs = [dict(prompt=p, max_new_tokens=18, seed=i, request_id=i)
            for i, p in enumerate(prompts(11, (10, 13, 9, 11, 8, 12)))]
    jres, tres = run_both(engines, reqs, num_lanes=2, objective="adaptive")
    assert len(tres) == 6
    assert_same(jres, tres)
    assert all(tres[i].ttft_s == tres[i].latency_s for i in range(4))
    assert all(tres[i].ttft_s < tres[i].latency_s for i in (4, 5))


def test_adaptive_light_load_uses_lanes(engines):
    reqs = [dict(prompt=p, max_new_tokens=16, seed=i, request_id=i)
            for i, p in enumerate(prompts(12, (10, 9)))]
    jres, tres = run_both(engines, reqs, num_lanes=2, objective="adaptive")
    assert_same(jres, tres)
    assert all(r.ttft_s < r.latency_s for r in tres.values())


def test_adaptive_burst_after_lanes_active(engines):
    """Two requests on the lanes, then a burst of five: the lanes finish,
    then the deep remainder drains fused; the same results as JAX's."""
    jeng, teng, _ = engines
    ps = prompts(13, (10,) * 7)
    out = []
    for eng, cbe, req in ((jeng, JaxCBE, JaxRequest),
                          (teng, ContinuousBatchingEngine, Request)):
        server = cbe(eng, num_lanes=2, objective="adaptive")
        for i in range(2):
            server.submit(req(prompt=ps[i], max_new_tokens=14, seed=i,
                              request_id=i))
        server.step()
        for i in range(2, 7):
            server.submit(req(prompt=ps[i], max_new_tokens=14, seed=i,
                              request_id=i))
        while server.step():
            pass
        out.append({r.request_id: r for r in server._results})
    assert len(out[1]) == 7
    assert_same(*out)


def test_adaptive_with_batch_group_and_sampling_modes(engines):
    _, teng, _ = engines
    ps = prompts(14, (10,) * 5)
    reqs = [dict(prompt=p, max_new_tokens=12, seed=i, request_id=i)
            for i, p in enumerate(ps)]
    jres, tres = run_both(engines, reqs, num_lanes=2, objective="adaptive",
                          batch_group=2)
    assert_same(jres, tres)

    scfg = tlt.SamplingConfig(temperature=0.8)
    res = {r.request_id: r for r in ContinuousBatchingEngine(
        teng, num_lanes=2, objective="adaptive", sampling=scfg).run([
            Request(prompt=p, max_new_tokens=10, seed=i, request_id=i)
            for i, p in enumerate(ps)])}
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(
            res[i].tokens, teng.generate_sample(p, 10, scfg, seed=i).tokens)


def test_streaming_requests_deliver_incremental_tokens(engines):
    """on_tokens gets each streaming request's new tokens, more than once;
    their concatenation is the result, which equals JAX's."""
    ps = prompts(11, (10, 13, 9))
    chunks = {0: [], 2: []}
    reqs = [dict(prompt=p, max_new_tokens=24, seed=i, request_id=i)
            for i, p in enumerate(ps)]
    jeng, teng, _ = engines
    jres = {r.request_id: r for r in JaxCBE(
        jeng, num_lanes=2, steps_per_sync=2).run(
            [JaxRequest(**r) for r in reqs])}
    tres = {r.request_id: r for r in ContinuousBatchingEngine(
        teng, num_lanes=2, steps_per_sync=2).run([
            Request(**r, on_tokens=chunks[i].append if i in chunks else None)
            for i, r in enumerate(reqs)])}
    assert_same(jres, tres)
    for i in chunks:
        assert len(chunks[i]) >= 2
        np.testing.assert_array_equal(np.concatenate(chunks[i]),
                                      tres[i].new_tokens)


@pytest.mark.parametrize("objective", ["throughput", "adaptive"])
def test_streaming_in_throughput_and_adaptive_modes(engines, objective):
    """A fused drain delivers each streaming request's whole output in one
    call; results equal JAX's."""
    reqs = [dict(prompt=p, max_new_tokens=12, seed=i, request_id=i)
            for i, p in enumerate(prompts(12, (10,) * 4))]
    jeng, teng, _ = engines
    got = {}
    jres = {r.request_id: r for r in JaxCBE(
        jeng, num_lanes=1, objective=objective).run(
            [JaxRequest(**r) for r in reqs])}
    tres = {r.request_id: r for r in ContinuousBatchingEngine(
        teng, num_lanes=1, objective=objective).run([
            Request(**r, on_tokens=lambda c, i=r["request_id"]:
                    got.setdefault(i, []).append(c)) for r in reqs])}
    assert_same(jres, tres)
    for i in range(4):
        np.testing.assert_array_equal(np.concatenate(got[i]),
                                      tres[i].new_tokens)


def test_adaptive_head_of_line_guard(engines):
    """One long request on a lane, then a deep backlog: the guard admits
    the backlog to the three free lanes. The lanes in ``_active`` after
    each step equal JAX's, and so do the results."""
    jeng, teng, _ = engines
    long_p = prompts(15, (10,))[0]
    shorts = prompts(16, (8,) * 6)
    out, actives = [], []
    for eng, cbe, req in ((jeng, JaxCBE, JaxRequest),
                          (teng, ContinuousBatchingEngine, Request)):
        server = cbe(eng, num_lanes=4, objective="adaptive",
                     steps_per_sync=1)
        server.submit(req(prompt=long_p, max_new_tokens=48, seed=99,
                          request_id="long"))
        server.step()
        seen = [{lane: r.request_id for lane, r in server._active.items()}]
        for i, p in enumerate(shorts):
            server.submit(req(prompt=p, max_new_tokens=4, seed=i,
                              request_id=i))
        server.step()
        seen.append({lane: r.request_id
                     for lane, r in server._active.items()})
        while server.step():
            pass
        out.append({r.request_id: r for r in server._results})
        actives.append(seen)
    assert actives[1] == actives[0]
    assert len(actives[1][0]) == 1 and len(actives[1][1]) == 4
    assert len(out[1]) == 7
    assert_same(*out)


def test_interactive_class_jumps_queue_and_keeps_lane_mode(engines):
    """An interactive request behind a deep batch backlog is on a lane
    after one step (as in JAX's scheduler, lane for lane), streams, and
    every result equals JAX's."""
    jeng, teng, _ = engines
    batch_ps = prompts(31, (10,) * 6)
    chat_p = prompts(32, (12,))[0]
    out, actives, chunks = [], [], []
    for eng, cbe, req in ((jeng, JaxCBE, JaxRequest),
                          (teng, ContinuousBatchingEngine, Request)):
        server = cbe(eng, num_lanes=2, objective="adaptive",
                     steps_per_sync=1)
        for i, p in enumerate(batch_ps):
            server.submit(req(prompt=p, max_new_tokens=10, seed=i,
                              request_id=i))
        chunks = []
        server.submit(req(prompt=chat_p, max_new_tokens=20, seed=99,
                          request_id="chat", interactive=True,
                          on_tokens=chunks.append))
        server.step()
        actives.append({lane: r.request_id
                        for lane, r in server._active.items()})
        while server.step():
            pass
        out.append({r.request_id: r for r in server._results})
    assert actives[1] == actives[0]
    assert "chat" in actives[1].values()
    assert_same(*out)
    np.testing.assert_array_equal(np.concatenate([chat_p] + chunks),
                                  out[1]["chat"].tokens)
    assert len(chunks) > 1
    assert out[1]["chat"].ttft_s < out[1]["chat"].latency_s


def test_interactive_under_throughput_objective_still_served(engines):
    p = prompts(33, (10,))[0]
    reqs = [dict(prompt=p, max_new_tokens=8, request_id="a"),
            dict(prompt=p, max_new_tokens=8, request_id="b",
                 interactive=True)]
    jres, tres = run_both(engines, reqs, objective="throughput")
    assert_same(jres, tres)
    assert all(r.error is None for r in tres.values())


# --------------------------------------------------------------------------
# beyond tests/test_serving.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["fairness", "throughput"])
def test_request_top_p_applies_on_an_engine_at_one(engines, objective):
    """A request's top_p below 1 on a sampling engine built at top_p 1.0
    takes effect (the JAX lanes fix the top-p switch when the step is
    built and ignore it): the result equals the lone generate_sample with
    that top_p, and differs from the one without it."""
    _, teng, _ = engines
    scfg = tlt.SamplingConfig(temperature=1.5)
    p = prompts(40, (10,))[0]
    res = ContinuousBatchingEngine(teng, num_lanes=2, sampling=scfg,
                                   objective=objective).run([
        Request(prompt=p, max_new_tokens=32, seed=3, request_id="p",
                top_p=0.3)])[0]
    with_p = teng.generate_sample(
        p, 32, tlt.SamplingConfig(temperature=1.5, top_p=0.3), seed=3)
    without = teng.generate_sample(p, 32, scfg, seed=3)
    np.testing.assert_array_equal(res.tokens, with_p.tokens)
    assert not np.array_equal(res.tokens, without.tokens)


def test_engine_log_records_every_result_and_round_trips(engines, tmp_path):
    """An engine's DecodeLog takes every lane and fused result of the
    scheduler, with JAX's records for the same requests; its JSON loads
    into JAX's DecodeLog and back."""
    jeng, teng, _ = engines
    reqs = [dict(prompt=p, max_new_tokens=12, seed=i, request_id=i)
            for i, p in enumerate(prompts(41, (10, 9, 11)))]
    jeng.log, teng.log = jlt.DecodeLog(), tlt.DecodeLog()
    try:
        for kw in (dict(num_lanes=2), dict(objective="throughput")):
            jres, tres = run_both(engines, reqs, **kw)
            assert_same(jres, tres)
        assert sorted(teng.log.records) == sorted(jeng.log.records)
        assert len(teng.log.records) == 6
        teng.log.save(str(tmp_path / "log.json"))
        back = jlt.DecodeLog.load(str(tmp_path / "log.json"))
        assert back.records == teng.log.records
        assert (tlt.DecodeLog.load(str(tmp_path / "log.json")).log_history()
                == jeng.log.log_history())
    finally:
        jeng.log = teng.log = None


def test_lane_path_reads_the_host_once_a_sync(engines):
    """One read of the lanes' scalars every steps_per_sync steps, plus at
    most one read of the output buffers (shared by the stream and the
    harvest)."""
    _, teng, _ = engines
    srv = ContinuousBatchingEngine(teng, num_lanes=2, steps_per_sync=3)
    chunks = []
    srv.run([Request(prompt=p, max_new_tokens=20, request_id=i,
                     on_tokens=chunks.append if i == 0 else None)
             for i, p in enumerate(prompts(42, (10, 12, 9)))])
    syncs = srv.steps_run // 3
    assert syncs <= srv.host_reads <= 2 * syncs
