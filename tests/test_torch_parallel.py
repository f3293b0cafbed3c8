"""The port's parallel slice against the JAX package's meshes.

One world of four gloo ranks on the CPU (``parallel/launch.py``, one
thread a rank) runs every case of ``torch_parallel_worker.run`` once for
the whole file. Each rank's tokens and steps are held, exactly, against
the port's unsharded engine, JAX's unsharded engine on the same parameters
(run here, on the CPU: JAX's own tests hold it equal to its sharded runs)
and every other rank. The models, seeds and prompts are those of JAX's
``test_pipeline.py``, ``test_training_sharded.py``, ``test_multihost.py``
and ``test_review_regressions.py`` (tp scaled from 8 to the world of 4).
The shard layout is held byte for byte against the slices JAX's
``NamedSharding`` puts on conftest's eight CPU devices, and the attention's
``row0`` against the same rows of the whole call. Through a faked capture
every capture mesh runs each call that loops on the device where its
step captures (an NCCL mesh on the cards) as one device loop, held
against its host loop, its eager call and JAX's unsharded engine.
"""

from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as lt
import torch_parallel_worker as W
from lookaheaddecoding_tpu.parallel import sharding as jsh
from lookaheaddecoding_tpu_torch.ops import lookahead_attention as la_ops
from lookaheaddecoding_tpu_torch.ops.quant import qmatmul, quantize_weight
from lookaheaddecoding_tpu_torch.parallel import sharding as tsh
from lookaheaddecoding_tpu_torch.parallel.launch import WorldError, launch
from lookaheaddecoding_tpu_torch.training.train_step import (
    init_opt_state, make_train_step)

WORLD = 4
RANK_TIMEOUT = 240      # seconds a rank may take; the world runs ~30 s


def jcfg(cfg):
    """The JAX package's config of a port config (float32)."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "dtype"}
    return jlt.LlamaConfig(**fields, dtype=jnp.float32)


# model file -> (port config, JAX PRNGKey, init scale)
MODELS = {
    "small": (W.small(), 2, 0.4),
    "small_kv2": (W.small(num_key_value_heads=2), 2, 0.4),
    "bias": (W.DECODE["tp4_bias"][1], 0, 0.5),
    "pipe": (W.pipe(), 0, 0.1),
    "la": (W.small(), 5, 0.4),
    "multihost": (W.multihost(), 0, 0.02),
    "la_rows": (W.la_rows(), 0, 0.1),
    "train": (W.small(), 0, 0.2),
}


def jax_tree(name):
    cfg, key, scale = MODELS[name]
    tree = jax.device_get(jlt.init_params(jcfg(cfg), jax.random.PRNGKey(key),
                                          scale=scale))
    if cfg.attention_bias:
        # JAX initialises biases to zero: make them count
        rng = np.random.RandomState(7)
        for b in ("bq", "bk", "bv"):
            tree["layers"][b] = (rng.standard_normal(tree["layers"][b].shape)
                                 * 0.5).astype(np.float32)
    return tree


def jax_generate(cfg, tree, lc, ec, prompt, n, prefix=None):
    eng = jlt.LookaheadEngine(jcfg(cfg), jax.tree.map(jnp.asarray, tree),
                              jlt.LookaheadConfig(**lc),
                              jlt.EngineConfig(**ec, dtype="float32"))
    if prefix is None:
        return eng.generate(prompt, n)
    return eng.generate(prompt, n, prefix=eng.precompute_prefix(prefix))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(each rank's results, references) of the one world. The world runs
    in a thread while this process builds the references."""
    data = tmp_path_factory.mktemp("parallel")
    trees = {name: jax_tree(name) for name in MODELS}
    for name, tree in trees.items():
        W.save_tree(data / f"{name}.npz", tree)
    np.save(data / "batch.npy",
            np.random.RandomState(1).randint(0, 128, size=(4, 33)))
    box = {}

    def run():
        try:
            box["ranks"] = launch(
                f"{W.__file__}:run", WORLD, "gloo", "cpu",
                dict(data=str(data)), timeout=RANK_TIMEOUT, threads=1)
        except WorldError as e:
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    refs = {}
    for name, (model, cfg, lc, ec, prompt, n, _, _) in W.DECODE.items():
        key = (model, repr(lc), repr(ec), prompt, n)
        if key not in refs:
            p = W.prompt_of(prompt)
            port = W.engine(cfg, lt.params_from_numpy(trees[model], cfg, "cpu"),
                            lc, ec, "cpu").generate(p, n)
            refs[key] = (port, jax_generate(cfg, trees[model], lc, ec, p, n))
        refs[name] = refs[key]
    system, prompt = W.prefix_prompt()
    pipe_params = lt.params_from_numpy(trees["pipe"], W.pipe(), "cpu")
    refs["prefix"] = (W.engine(W.pipe(), pipe_params, W.LC_POOL, W.EC,
                               "cpu").generate(prompt, 24),
                      jax_generate(W.pipe(), trees["pipe"], W.LC_POOL, W.EC,
                                   prompt, 24))
    for bits in (8, 4):
        q = lt.quantize_params(lt.params_from_numpy(trees["small"], W.small(),
                                                    "cpu"), bits=bits,
                               quantize_lm_head=True, lm_head_bits=bits)
        refs[f"int{bits}"] = W.engine(W.small(), q, W.LC, W.EC, "cpu").generate(
            W.prompt_of("small"), 40)
    refs["mesh_jax"] = mesh_jax_refs(trees)
    thread.join(RANK_TIMEOUT + 30)
    if "error" in box:
        raise box["error"]
    assert "ranks" in box, "the world did not finish"
    return box["ranks"], refs, trees, data


def _jax_record(results, pools=True):
    """tokens, steps (and the pool rows [0, R) and clock each run ended
    with) of JAX results, as the worker records them."""
    out = {"tokens": [np.asarray(r.tokens).tolist() for r in results],
           "steps": [int(r.steps) for r in results]}
    if pools:
        out["pools"] = [[np.asarray(r.prefix.pool.values)[:-1].tolist(),
                         np.asarray(r.prefix.pool.age)[:-1].tolist(),
                         int(r.prefix.pool.clock)] for r in results]
    return out


def mesh_jax_refs(trees):
    """{capture mesh: {kind: record}}: JAX's unsharded engine in float32 on
    each capture mesh's model, for the greedy and AR calls of
    ``torch_parallel_worker._mesh_calls``."""
    n = W.MESH_NEW
    by_model = {}
    for model, cfg, _, _ in W.CAPTURE_MESHES.values():
        if model in by_model:
            continue
        tree = jax.tree.map(jnp.asarray, trees[model])
        lc = dict(W.LC_POOL, pool_key_len=2, pool_hash_size=97)

        def eng(**kw):
            return jlt.LookaheadEngine(
                jcfg(cfg), tree, jlt.LookaheadConfig(**lc, **kw),
                jlt.EngineConfig(**W.EC, dtype="float32"))
        e = eng()
        p, q = W.prompt_of("la"), W.prompt_of("small")[:9]
        eos = int(np.asarray(e.generate(p, n["eos"]).tokens)[
            len(p) + W.EOS_AT])
        by_model[model] = {
            "generate": _jax_record([e.generate(p, n["generate"],
                                                return_prefix=True)]),
            "baseline": _jax_record([e.generate_baseline(p, n["baseline"])],
                                    False),
            "batch": _jax_record([e.generate(x, n["batch"],
                                             return_prefix=True)
                                  for x in (p, q)]),
            "eos": _jax_record([e.generate(p, n["eos"], eos_token_id=eos,
                                           return_prefix=True)]),
            "refill": _jax_record([eng(always_fwd_one=False).generate(
                p, n["refill"], seed=4)], False),
            "prefix": _jax_record([e.generate(
                p, n["prefix"], prefix=e.precompute_prefix(p[:8]))],
                False)}
    return {mesh: by_model[model]
            for mesh, (model, _, _, _) in W.CAPTURE_MESHES.items()}


def _same(got, port, jax_res):
    """A rank's result equals the port's and JAX's unsharded runs."""
    assert got is not None
    assert got["tokens"] == port.tokens.tolist() == jax_res.tokens.tolist()
    assert got["steps"] == port.steps == jax_res.steps


def _members(ranks, key):
    got = [r[key] for r in ranks if r[key] is not None]
    assert got
    return got


@pytest.mark.parametrize("case", list(W.DECODE))
def test_sharded_decode_matches_unsharded_port_and_jax(world, case):
    """tp=4 (Hkv 4), tp=4 on Hkv=2 (replicated KV heads), tp=4 with
    attention biases, pp=2, pp=2 x tp=2, pp=4 with the int8 KV cache,
    la=2 x tp=2 and tp=4 across two "hosts": every rank of the mesh gives
    the unsharded tokens and steps, and so does every other rank."""
    ranks, refs, _, _ = world
    got = _members(ranks, case)
    mesh = W.DECODE[case][6]
    assert len(got) == int(np.prod(list(mesh.values())))
    for g in got:
        _same(g, *refs[case])
    if case == "la2_tp2":
        assert got[0]["compression"] >= 1.0


def test_pp_refusals_carry_jaxs_messages(world):
    ranks, _, _, _ = world
    r0 = ranks[0]["refusals"]
    assert "divisible" in r0["divisible"]
    assert "mesh" in r0["no_mesh"]
    assert "axis size" in r0["axis_size"]
    # JAX's own engine refuses the same settings with the same words
    jmsgs = {}
    cfg3 = W.pipe(layers=3)
    with pytest.raises(ValueError) as e:
        jlt.LookaheadEngine(
            jcfg(cfg3), jlt.init_params(jcfg(cfg3), jax.random.PRNGKey(0)),
            jlt.LookaheadConfig(**W.LC_POOL),
            jlt.EngineConfig(**W.EC, pp=2, dtype="float32"),
            mesh=jsh.make_mesh(pp=2))
    jmsgs["divisible"] = str(e.value)
    assert r0["divisible"] == jmsgs["divisible"]
    assert r0["no_mesh"] == "pp > 1 requires a mesh with a 'pp' axis"
    assert r0["axis_size"] == "mesh 'pp' axis size 4 != EngineConfig.pp 2"


def test_prefix_cache_under_pp_and_pp_tp(world):
    ranks, refs, _, _ = world
    for key, n in (("pp2", 2), ("pp2_tp2", 4)):
        got = [r["prefix"][key] for r in ranks if r["prefix"][key]]
        assert len(got) == n
        for g in got:
            _same(g, *refs["prefix"])


def test_la_partitions_the_products(world):
    """In one la=2 decode step at S=48, at least half of the rank's matrix
    products run on its 24 rows (JAX's test counts the HLO's dots)."""
    ranks, _, _, _ = world
    for rows in _members(ranks, "la_rows"):
        assert len(rows) > 0
        assert sum(r == 24 for r in rows) >= len(rows) / 2, rows


def test_every_rank_gets_the_same_logits(world):
    """One causal forward: pp keeps the order of layers and the arithmetic
    of one device, so its logits are bit-equal to the whole tree's at f32;
    tp and la sum partial products in another order (tp: rtol-level
    noise), and every rank of a mesh holds the same logits, bit for bit."""
    ranks, _, _, _ = world
    for name in ("pp2", "pp4", "tp4", "la2_tp2"):
        got = [r["logits"][name] for r in ranks if r["logits"][name]]
        assert len({g["sha"] for g in got}) == 1, name
        if name.startswith("pp"):
            assert all(g["equal"] for g in got), name
        assert all(g["max_diff"] < 1e-5 for g in got), (name, got)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_weights_at_tp2(world, bits):
    """int8 and int4 weights, LM head included (the int4 split-half row
    shard), under dp=2 x tp=2 give the unsharded port's tokens."""
    ranks, refs, _, _ = world
    ref = refs[f"int{bits}"]
    for r in ranks:
        got = r["quantized"][f"int{bits}"]
        assert got["tokens"] == ref.tokens.tolist()
        assert got["steps"] == ref.steps


# after one step: Adam within JAX's tolerances (its rsqrt(nu) amplifies the
# noise of the reduction order, test_training_sharded.py:29-47); SGD, whose
# update is lr times the gradient, within float32 noise of a sum of
# partial gradients in another order (~1e-6 of |g| ~ 1, times lr 0.1)
TRAIN_TOL = {"adam": dict(atol=3e-3, rtol=1e-2),
             "sgd": dict(atol=1e-5, rtol=1e-4)}


@pytest.mark.parametrize("opt", list(W.OPTIMIZERS))
@pytest.mark.parametrize("name", list(W.TRAIN))
def test_sharded_train_step_matches_one_device(world, name, opt):
    """dp=2 x tp=2 (JAX's test at the world of 4), pp=2 x tp=2 (the layer
    stack gathered for the step) and tp=4 on 2 KV heads (each KV head's
    gradient summed over the two ranks that hold it) against one device
    on the whole batch: the loss within rtol 1e-5 and every parameter
    within TRAIN_TOL after one step."""
    ranks, _, trees, data = world
    model, cfg, mesh_kw = W.TRAIN[name]
    params = lt.params_from_numpy(trees[model], cfg, "cpu")
    batch = np.load(data / "batch.npy")
    step = make_train_step(cfg, seq_len=64, learning_rate=W.OPTIMIZERS[opt],
                           optimizer=opt)
    ref, _, loss = step(params, init_opt_state(params, opt), batch)
    for r in ranks:
        np.testing.assert_allclose(r["train"][name][opt], float(loss),
                                   rtol=1e-5)
        mesh = W.mesh_at(r["rank"], **mesh_kw)
        want = tsh.shard_params(ref, mesh, cfg)
        with np.load(data / f"train_{name}_{opt}_rank{r['rank']}.npz") as got:
            for k, v in want.items():
                leaves = v.items() if k == "layers" else [(None, v)]
                for leaf, w in leaves:
                    key = k if leaf is None else f"layers/{leaf}"
                    np.testing.assert_allclose(got[key], w.numpy(),
                                               err_msg=key, **TRAIN_TOL[opt])


def test_multihost_mesh_training_step(world):
    """make_multihost_mesh(dp_hosts=2, tp=2) on four ranks numbered host by
    host: dp runs across the two "hosts", the loss is the same on every
    rank and lower after a step (test_multihost.py:62-102)."""
    ranks, _, _, _ = world
    coords = [r["multihost_train"]["coords"] for r in ranks]
    assert [(c["dp"], c["tp"]) for c in coords] == [(0, 0), (0, 1), (1, 0),
                                                    (1, 1)]
    losses = [r["multihost_train"]["loss"] for r in ranks]
    assert len(set(losses)) == 1
    for r in ranks:
        assert r["multihost_train"]["loss_after_step"] < r[
            "multihost_train"]["loss"]


def test_every_rank_ran_collectives(world):
    ranks, _, _, _ = world
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    for r in ranks:
        c = r["collectives"]
        assert c["all_reduce"] > 0 and c["all_gather"] > 0
    assert sum(r["collectives"]["send"] for r in ranks) > 0
    assert sum(r["collectives"]["recv"] for r in ranks) > 0


# ---------------------------------------------------------------------------
# What capturing a mesh step needs (an NCCL mesh replays it as a CUDA
# graph), held on the gloo world at tp=2, pp=2, la=2 (each beside dp=2)
# and la=2 x tp=2
# ---------------------------------------------------------------------------

CAPTURE = list(W.CAPTURE_MESHES)


@pytest.mark.parametrize("mesh", CAPTURE)
def test_mesh_steps_keep_every_address(world, mesh):
    """Each flat step (greedy, sampling, AR) and batched step (greedy,
    sampling) writes its state in place on every rank: every tensor of its
    slot has the same data_ptr after three steps, which changed it."""
    ranks, _, _, _ = world
    for r in ranks:
        for kind, got in r["mesh_steps"][mesh].items():
            assert got["addresses_kept"], (r["rank"], kind)
            assert got["changed"], (r["rank"], kind)


@pytest.mark.parametrize("mesh", CAPTURE)
def test_mesh_step_after_finished_changes_nothing(world, mesh):
    """Once ``finished`` holds, further steps leave every buffer bit-equal
    on every rank (cache rows past the committed ones and the pools' trash
    rows apart, which no read sees)."""
    ranks, _, _, _ = world
    for r in ranks:
        for kind, got in r["mesh_steps"][mesh].items():
            assert got["after_finished_unchanged"], (r["rank"], kind)


@pytest.mark.parametrize("mesh", CAPTURE)
def test_mesh_steps_read_nothing_back_to_the_host(world, mesh):
    """No op of a mesh step reads a value back to the host, collectives
    included; the lookahead steps make one ``graphs.cond`` call (the
    pool's chain, an IF node under capture), the AR step none."""
    ranks, _, _, _ = world
    for r in ranks:
        for kind, got in r["mesh_steps"][mesh].items():
            assert got["host_reads"] == [], (r["rank"], kind)
            assert got["conds"] == ([] if kind == "baseline_step"
                                    else [[]]), (r["rank"], kind)


@pytest.mark.parametrize("mesh", CAPTURE)
def test_every_rank_takes_the_same_branches(world, mesh):
    """Every rank evaluates the same cond predicates, step by step, and
    takes the same chains: each rank's IF node decides alone under
    capture, so the predicate must not differ between ranks."""
    ranks, _, _, _ = world
    got = [r["branches"][mesh] for r in ranks]
    assert got[0]["preds"] and any(got[0]["preds"])
    assert got[0]["branches"] == len(got[0]["preds"])
    for g in got[1:]:
        assert g == got[0]


# decode graphs the first graphed call of each kind captures on its engine,
# which has run the kinds before it (each followed by its host-loop twin,
# which captures the slot's step graph of its mode): every kind that loops
# on the device captures its loop graph, unless an earlier kind did (the
# EOS call and the prefix call replay the first slot's greedy loop); the
# streams' first resumes on the first slot, whose greedy step graph
# ``generate``'s host-loop twin captured, and the second captures on a
# second slot; ``refill`` runs on an engine of its own
NEW_GRAPHS = {"generate": 1, "baseline": 1, "sample": 1, "batch": 1,
              "batch_sample": 1, "eos": 0, "refill": 1, "streams": 1,
              "prefix": 0}
# prefill graphs it captures (one a slot: ``generate`` the first slot's,
# ``refill`` its engine's, the second stream the second slot's), and the
# prefill chunks of each call (chunks of 16 rows: the prompts of 12 and 9
# tokens, the prefix of 8 and the rows past it take one each; the batches
# and the streams prefill two prompts, the prefix call its prefix and then
# its prompt)
NEW_PREFILL_GRAPHS = {"generate": 1, "baseline": 0, "sample": 0, "batch": 0,
                      "batch_sample": 0, "eos": 0, "refill": 1, "streams": 1,
                      "prefix": 0}
CHUNKS = {"generate": 1, "baseline": 1, "sample": 1, "batch": 2,
          "batch_sample": 2, "eos": 1, "refill": 1, "streams": 2,
          "prefix": 2}
# the kinds whose host loop (and so whose eager call) may take steps past
# the one that ends the run: an EOS id stops it before its budget
OVERSHOOT = ("eos",)


@pytest.mark.parametrize("mesh", CAPTURE)
def test_faked_capture_of_mesh_steps_equals_eager(world, mesh):
    """Through a faked capture (the warm step, a capture that restores the
    state, replays running the step as the graph would) greedy
    ``generate``, ``generate_baseline``, ``generate_sample``, a two-lane
    ``generate_batch`` greedy and sampled, an EOS-ended greedy call, a
    greedy call with ``always_fwd_one=False``, a stream that runs while
    another is suspended and a call from a ``precompute_prefix`` cache
    equal their eager calls on one engine: tokens, steps and (once
    captured) branches; the collectives a call counts are the eager
    call's (a capture takes its own back, each replay adds the step's
    once), but for the EOS-ended call, whose device loop stops at the step
    that ended it while the eager host loop runs its batch out; the first
    call captures its new decode and prefill graphs (``NEW_GRAPHS``,
    ``NEW_PREFILL_GRAPHS``), a step is one replay (a device loop's
    iteration) and a prefill chunk one replay of the prefill graph (a
    capture's first step or chunk is the warm one). Every rank gives the
    same tokens, steps, branches and replays (the collectives differ
    between pp stages)."""
    ranks, _, _, _ = world
    for r in ranks:
        got_kinds = r["fake_captured"][mesh]
        assert set(got_kinds) == set(NEW_GRAPHS)
        # la's AR step and batched step run whole on every rank
        assert sum(sum(got["eager"]["collectives"].values())
                   for got in got_kinds.values()) > 0
        for kind, got in got_kinds.items():
            eager = got["eager"]
            assert eager["captured"] == eager["replays"] == 0, kind
            assert eager["prefills"] == 0, kind
            # the warm step runs the chain's body unconditionally and
            # counts no branch, so a capturing call's branches differ
            counted = (() if kind in OVERSHOOT
                       else ("collectives", "branches", "taken"))
            first_keys = ("tokens", "steps") + (
                counted[:1] if NEW_GRAPHS[kind] else counted)
            for which, keys in (("first", first_keys),
                                ("graphed", ("tokens", "steps") + counted)):
                for key in keys:
                    assert got[which][key] == eager[key], (r["rank"], kind,
                                                           which, key)
            # lanes step together; streams each step their own slot
            steps = (sum if kind == "streams" else max)(eager["steps"])
            new = NEW_GRAPHS[kind] + NEW_PREFILL_GRAPHS[kind]
            assert got["first"]["captured"] == new, kind
            assert got["graphed"]["captured"] == 0, kind
            assert got["graphed"]["replays"] == steps, kind
            assert got["first"]["replays"] == steps - NEW_GRAPHS[kind], kind
            assert got["graphed"]["prefills"] == CHUNKS[kind], kind
            assert got["first"]["prefills"] == (CHUNKS[kind]
                                                - NEW_PREFILL_GRAPHS[kind])
            first = ranks[0]["fake_captured"][mesh][kind]
            for which in got:
                for key in ("tokens", "steps", "branches", "taken",
                            "replays", "prefills"):
                    assert got[which][key] == first[which][key], (kind, key)


LOOP_KINDS = [k for k in NEW_GRAPHS if k != "streams"]


@pytest.mark.parametrize("mesh", CAPTURE)
def test_meshes_loop_on_the_device_and_streams_on_the_host(world, mesh):
    """A mesh engine whose steps capture (faked here; NCCL on the cards)
    runs the decode loop of every call but a stream on the device: greedy
    ``generate``, ``generate_baseline``, ``generate_sample``, greedy and
    sampled ``generate_batch``, an EOS-ended call, an
    ``always_fwd_one=False`` call and a prefix call each launch one device
    loop (``graphs.LoopGraph``) a call, captured or replayed, whose
    iterations are the call's steps, the same on every rank; the streams
    launch none and replay their captured step once a step, and so does
    each call's host-loop twin (``host_loop=True``) and its eager call."""
    ranks, _, _, _ = world
    for r in ranks:
        for kind, got in r["fake_captured"][mesh].items():
            loops = 0 if kind == "streams" else 1
            for which in ("first", "graphed"):
                assert got[which]["loops"] == loops, (r["rank"], kind, which)
            assert got["eager"]["loops"] == 0, (r["rank"], kind)
            assert got["graphed"]["replays"] == max(got["graphed"]["steps"]) \
                or kind == "streams", (r["rank"], kind)
            if kind != "streams":
                assert got["host"]["loops"] == 0, (r["rank"], kind)
                assert got["host"]["replays"] > 0, (r["rank"], kind)
        iters = [{kind: got["graphed"]["replays"] for kind, got in
                  x["fake_captured"][mesh].items()} for x in ranks]
        assert iters == [iters[0]] * len(ranks)


@pytest.mark.parametrize("mesh", CAPTURE)
@pytest.mark.parametrize("kind", LOOP_KINDS)
def test_mesh_device_loop_equals_its_host_loop(world, mesh, kind):
    """Each device-loop call of a faked-captured mesh engine equals the
    same call by the host loop (``host_loop=True``) and its eager call on
    every rank: tokens, steps, the pool rows [0, R) and clock its states
    ended with, the branches its chains took and the final draw counters
    of the Philox streams; the host loop counts the eager call's
    collectives and branches (both run the same batches of steps)."""
    ranks, _, _, _ = world
    for r in ranks:
        got = r["fake_captured"][mesh][kind]
        for which in ("first", "graphed", "host"):
            for key in ("tokens", "steps", "pool", "draws"):
                assert got[which][key] == got["eager"][key], (
                    r["rank"], which, key)
        # a capturing host call's warm step counts no branch
        for key in ("collectives",) + (
                () if got["host"]["captured"] else ("branches", "taken")):
            assert got["host"][key] == got["eager"][key], (r["rank"], key)
        if kind not in OVERSHOOT:
            assert got["graphed"]["taken"] == got["eager"]["taken"]
        if kind in ("sample", "batch_sample", "refill"):
            # a step that draws advances its lane's counter once
            assert got["graphed"]["draws"] == got["graphed"]["steps"], kind


@pytest.mark.parametrize("mesh", CAPTURE)
@pytest.mark.parametrize("kind", ["generate", "baseline", "batch", "eos",
                                  "refill", "prefix"])
def test_mesh_device_loop_equals_jax(world, mesh, kind):
    """Each greedy and AR call of a faked-captured mesh engine, on the
    device loop, gives the tokens and steps of JAX's unsharded engine in
    float32 on every rank, and the pool rows [0, R) JAX's run ended with
    (``generate``, the EOS-ended call, each lane of the batch): the
    EOS-ended call stops at the step that emitted its EOS id, as JAX's
    ``while_loop`` does. The ``always_fwd_one=False`` call gives JAX's
    tokens (its window refill draws from the port's own stream, so its
    steps may differ)."""
    ranks, refs, _, _ = world
    want = refs["mesh_jax"][mesh][kind]
    for r in ranks:
        got = r["fake_captured"][mesh][kind]["graphed"]
        assert got["tokens"] == want["tokens"], (r["rank"], kind)
        if kind != "refill":
            assert got["steps"] == want["steps"], (r["rank"], kind)
        if "pools" in want:
            assert got["pool_rows"] == want["pools"], (r["rank"], kind)


def test_faked_capture_of_the_dp_tp_train_step_equals_eager(world):
    """Three Adam steps at dp=2 x tp=2 through a faked capture equal three
    eager steps bit for bit on every rank (losses, parameters and optimizer
    state), call the same collectives, and share one graph."""
    ranks, _, _, _ = world
    for r in ranks:
        got = r["fake_captured_train"]
        assert got["graphed"] == got["eager"], r["rank"]
        assert sum(got["eager"]["collectives"].values()) > 0
        assert got["graphs"] == 1
    assert len({r["fake_captured_train"]["eager"]["losses"][-1]
                for r in ranks}) == 1


def test_a_failing_rank_ends_the_world():
    """A rank that raises while the others wait in a collective it never
    joins ends the world with its own error, well before the time limit."""
    import time
    t0 = time.monotonic()
    with pytest.raises(WorldError, match="rank 1 fails on purpose"):
        launch(f"{W.__file__}:fail_in_a_collective", 2, "gloo", "cpu",
               timeout=120, threads=1)
    assert time.monotonic() - t0 < 60


def test_a_teardown_that_hangs_fails_the_world():
    """A rank whose process group's teardown outlives its limit ends as
    failed, with the reason in its log: a hung teardown is no success."""
    import time
    t0 = time.monotonic()
    with pytest.raises(WorldError, match="teardown took over"):
        launch(f"{W.__file__}:hang_in_teardown", 2, "gloo", "cpu",
               timeout=60, threads=1)
    assert time.monotonic() - t0 < 30


def test_a_hung_world_reports_where_each_rank_waits():
    """A world past its time limit is killed, and the error carries each
    running rank's log with the stack it printed before the limit."""
    with pytest.raises(WorldError, match="did not finish") as e:
        launch(f"{W.__file__}:hang", 2, "gloo", "cpu", timeout=8, threads=1)
    for rank in (0, 1):
        assert f"rank {rank}:" in str(e.value)
    assert str(e.value).count("in hang") == 2


# ---------------------------------------------------------------------------
# In-process: the layout against JAX's, the int4 row shard, the kernel's
# first row
# ---------------------------------------------------------------------------

def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("model", ["small", "bias", "tied"])
def test_param_specs_equal_jaxs(model):
    cfg = (MODELS["bias"][0] if model == "bias"
           else W.small(tie_word_embeddings=model == "tied"))
    params = lt.init_params(cfg, seed=0, device="cpu")
    jparams = jax.device_get(jlt.init_params(jcfg(cfg), jax.random.PRNGKey(0)))
    got = tsh.param_specs(cfg, params)
    want = jax.tree.map(tuple, jsh.param_specs(jcfg(cfg), jparams),
                        is_leaf=lambda s: isinstance(s, jax.sharding
                                                     .PartitionSpec))
    assert got == _as_tuples(want)
    assert tsh.param_specs(cfg) == _as_tuples(jax.tree.map(
        tuple, jsh.param_specs(jcfg(cfg)),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    assert tsh.kv_cache_spec() == tuple(jsh.kv_cache_spec())


MESHES = {"tp4": dict(tp=4), "dp2_tp4": dict(dp=2, tp=4),
          "pp2_la2_tp2": dict(pp=2, tp=2, la=2), "pp4_tp2": dict(pp=4, tp=2),
          "tp2": dict(tp=2), "dp2_tp2": dict(dp=2, tp=2),
          "pp2_tp2": dict(pp=2, tp=2)}


@pytest.mark.parametrize("model,mesh", [
    (model, mesh) for model in ("pipe", "int4")
    for mesh in ("tp4", "dp2_tp4", "pp2_la2_tp2", "pp4_tp2")]
    # the bias model's 2 KV heads split evenly up to tp=2, its 2 layers
    # up to pp=2
    + [("bias", mesh) for mesh in ("tp2", "dp2_tp2", "pp2_tp2")])
def test_shard_params_equal_jaxs_named_sharding(model, mesh):
    """Rank r's shard of every leaf is, byte for byte, the slice JAX's
    NamedSharding puts on the device at r's mesh coordinates. In an int4
    tree that holds for the packed rows of the row-parallel leaves; the
    column-parallel ones before them take the two ranges those rows read
    (parallel/sharding.py)."""
    mesh_kw = MESHES[mesh]
    cfg = W.pipe() if model != "bias" else MODELS["bias"][0]
    tree = jax.device_get(jlt.init_params(jcfg(cfg), jax.random.PRNGKey(3),
                                          scale=0.1))
    params = lt.params_from_numpy(tree, cfg, "cpu")
    if model == "int4":
        # the int4 row-parallel leaves' packed bytes are JAX's slices too
        params = lt.quantize_params(params, bits=4)
        tree = {"layers": {k: {n: t.numpy() for n, t in w.items()}
                           if isinstance(w, dict) else w.numpy()
                           for k, w in params["layers"].items()},
                **{k: v.numpy() for k, v in params.items()
                   if k != "layers"}}
    jmesh = jsh.make_mesh(**mesh_kw)
    specs = jsh.param_specs(jcfg(cfg), tree)
    n = int(np.prod(list(mesh_kw.values())))
    for rank in range(n):
        mesh = W.mesh_at(rank, **mesh_kw)
        dev = jmesh.devices.reshape(-1)[rank]
        local = tsh.shard_params(params, mesh, cfg)

        def check(spec, full, mine, name):
            idx = jax.sharding.NamedSharding(jmesh, spec).devices_indices_map(
                full.shape)[dev]
            np.testing.assert_array_equal(mine.numpy(), full[idx],
                                          err_msg=f"{name} rank {rank}")
        for k in ("embed", "final_norm", "lm_head"):
            check(specs[k], tree[k], local[k], k)
        for k, spec in specs["layers"].items():
            full, mine = tree["layers"][k], local["layers"][k]
            if isinstance(full, dict):
                if spec[1] == "tp":
                    check(spec, full["q4"], mine["q4"], k)
                continue
            check(spec, full, mine, k)


@pytest.mark.parametrize("bits,pad", [(8, 0), (4, 0), (4, 64)])
def test_row_parallel_shards_sum_to_the_whole_product(bits, pad):
    """The int4 trap: rank t's block of packed rows reads x's two ranges
    [t*K/2/tp, (t+1)*K/2/tp) and the same + K/2, low nibbles first; the
    ranks' products over those x slices sum to the unsharded product
    (int8: one contiguous block). A padded int4 weight splits on its
    logical rows."""
    rng = np.random.RandomState(0)
    k, n, tp = 256, 48, 4
    w = torch.from_numpy(rng.standard_normal((1, k, n)).astype(np.float32))
    wq = quantize_weight(w, bits)
    if pad:
        wq["q4"] = torch.nn.functional.pad(wq["q4"], (0, 0, 0, pad))
        wq["q4_pad"] = torch.zeros((1, pad, 0), dtype=torch.int8)
    x = torch.from_numpy(rng.standard_normal((5, k)).astype(np.float32))
    whole = qmatmul(x, {a: b[0] for a, b in wq.items()})
    cfg = W.small(hidden_size=n, intermediate_size=k, num_hidden_layers=1)
    total = torch.zeros_like(whole)
    for t in range(tp):
        mesh = W.mesh_at(t, tp=tp)
        local = tsh.shard_params(
            {"embed": torch.zeros(128, n), "final_norm": torch.ones(n),
             "layers": {"w_down": wq}}, mesh, cfg)["layers"]["w_down"]
        if bits == 4:
            r = np.arange(t * k // 2 // tp, (t + 1) * k // 2 // tp)
            cols = np.concatenate([r, k // 2 + r])
            assert local["q4_pad"].shape[-2] == 0
        else:
            cols = np.arange(t * k // tp, (t + 1) * k // tp)
        total += qmatmul(x[:, cols], {a: b[0] for a, b in local.items()})
    torch.testing.assert_close(total, whole, atol=1e-4, rtol=1e-5)


def test_head_split_rules():
    """tp dividing Hkv splits the KV heads; tp a multiple of Hkv keeps
    each rank the KV head its query heads read; anything else raises
    naming the three numbers."""
    cfg = W.small(num_key_value_heads=2)                  # 8 query, 2 KV
    assert [tsh.head_sets(cfg, 2, t)[1].tolist() for t in range(2)] == [
        [0], [1]]
    assert [tsh.head_sets(cfg, 4, t)[1].tolist() for t in range(4)] == [
        [0], [0], [1], [1]]
    assert tsh.head_sets(W.small(), 2, 1)[0].tolist() == [4, 5, 6, 7]
    bad = W.small(num_attention_heads=12, num_key_value_heads=4,
                  hidden_size=96)
    with pytest.raises(ValueError, match="Hq=12.*Hkv=4.*tp=3"):
        tsh.head_sets(bad, 3, 0)
    with pytest.raises(ValueError, match="query heads"):
        tsh.head_sets(cfg, 3, 0)


def test_mesh_needs_a_started_world():
    with pytest.raises(RuntimeError, match="parallel.launch"):
        tsh.make_mesh(tp=2, devices="cpu")


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds the default device where there is no card")
def test_launch_runs_on_the_card_unless_asked_for_the_cpu():
    """A world started without a device puts its ranks on the card: with
    none, the rank says so and the launcher raises."""
    with pytest.raises(WorldError, match="no CUDA device"):
        launch(f"{W.__file__}:run", 1, timeout=120)


def test_train_step_on_a_one_rank_mesh_is_the_plain_step():
    """A mesh made by hand with one rank (no groups) runs the plain step:
    the f/g pair and the gathers are identities on axes of size 1."""
    cfg = W.small()
    params = lt.init_params(cfg, seed=0, scale=0.2, device="cpu")
    batch = np.random.RandomState(1).randint(0, 128, size=(2, 17))
    mesh = W.mesh_at(0)
    a = make_train_step(cfg, seq_len=32)(params, init_opt_state(params),
                                         batch)
    b = make_train_step(cfg, seq_len=32, mesh=mesh)(
        params, init_opt_state(params), batch)
    assert float(a[2]) == float(b[2])
    for k in a[0]["layers"]:
        torch.testing.assert_close(a[0]["layers"][k], b[0]["layers"][k],
                                   atol=0, rtol=0)


@pytest.mark.parametrize("mode", ["composite", "causal", "sliding"])
@pytest.mark.parametrize("int8_kv", [False, True])
def test_row0_rows_equal_the_whole_calls(mode, int8_kv):
    """The plain version at ``row0``: rows [r0, r0+n) of a call equal the
    whole call's, bit for bit (L5/W8/G4: S = 48, split as la=2 splits
    it, unevenly, and from a row inside the window)."""
    rng = np.random.RandomState(3)
    s_len, hq, hkv, d, m, kv_len = 48, 4, 2, 32, 128, 37
    q = torch.from_numpy(rng.standard_normal((s_len, hq, d)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((hkv, m, d)).astype(
        np.float32)) for _ in range(2))
    if int8_kv:
        k, v = ({"q": torch.from_numpy(rng.randint(-127, 128, (hkv, m, d))
                                       .astype(np.int8)),
                 "s": torch.from_numpy(rng.uniform(0.01, 0.02, (hkv, m, 1))
                                       .astype(np.float32))}
                for _ in range(2))
    geo = dict(level=5, window=8, guess_size=4,
               causal=mode == "causal",
               sliding_window=20 if mode == "sliding" else 0)
    lens = torch.tensor([kv_len], dtype=torch.int32)
    whole = la_ops.lookahead_attention(q, k, v, lens, **geo)
    # (a call of one row would take BLAS's matrix-vector product, whose sum
    # runs in another order: one ulp apart)
    for r0, n in ((0, 24), (24, 24), (0, 20), (20, 28), (7, 13)):
        part = la_ops.lookahead_attention(q[r0:r0 + n], k, v, lens, row0=r0,
                                          **geo)
        assert torch.equal(part, whole[r0:r0 + n]), (r0, n)
    with pytest.raises(ValueError, match="row0"):
        la_ops.lookahead_attention(q, k, v, lens, row0=-1, **geo)


def test_paged_step_on_pp_and_tp(world):
    """generate_batch (two lanes) and ContinuousBatchingEngine (three
    requests on two lanes) at pp=2 x tp=2: each lane equals the unsharded
    engine's lone generate, on every rank."""
    ranks, _, trees, _ = world
    cfg = W.pipe()
    eng = W.engine(cfg, lt.params_from_numpy(trees["pipe"], cfg, "cpu"),
                   W.LC_POOL, W.EC, "cpu")
    prompts = W.batched_requests()
    for r in ranks:
        got = r["paged_step"]
        for p, lane in zip(prompts, got["batch"]):
            assert lane["tokens"] == eng.generate(p, 24).tokens.tolist()
        for i, p in enumerate(prompts):
            assert got["lanes"][str(i)] == eng.generate(p, 20).tokens.tolist()


def test_entry_points_on_a_mesh(world):
    """generate_baseline, generate_sample, generate_stream (greedy and
    sampling) and a return_prefix second turn at dp=2 x pp=2 equal the
    unsharded engine's on every rank (pp keeps one device's bits, so the
    sampled tokens too)."""
    ranks, _, trees, _ = world
    cfg = W.pipe()
    want = W.entry_points(W.engine(
        cfg, lt.params_from_numpy(trees["pipe"], cfg, "cpu"), W.LC_POOL,
        W.EC, "cpu"))
    p = W.prompt_of("pipe")
    assert want["stream"] == want["baseline"][len(p):]
    for r in ranks:
        assert r["entry_points"] == want


def test_mesh_refusals():
    """A one-rank mesh (every axis 1, no groups) decodes as no mesh; the
    paged engine refuses a mesh, as JAX's does; a tree that is not the
    rank's shard, or a rank outside the mesh, raises."""
    cfg = W.small()
    params = lt.init_params(cfg, seed=0, scale=0.4, device="cpu")
    mesh = W.mesh_at(0)
    eng = W.engine(cfg, tsh.shard_params(params, mesh, cfg), W.LC, W.EC,
                   "cpu", mesh)
    prompt = W.prompt_of("small")
    assert (eng.generate(prompt, 16).tokens == W.engine(
        cfg, params, W.LC, W.EC, "cpu").generate(prompt, 16).tokens).all()
    with pytest.raises(ValueError, match="mesh"):
        lt.PagedServingEngine(cfg, params, lt.LookaheadConfig(**W.LC),
                              lt.EngineConfig(**W.EC, tp=2), device="cpu")
    with pytest.raises(ValueError, match="shard"):
        W.engine(cfg, params, W.LC, W.EC, "cpu", W.mesh_at(0, tp=2))
    with pytest.raises(ValueError, match="outside"):
        W.engine(cfg, params, W.LC, W.EC, "cpu", W.mesh_at(5, tp=2))
