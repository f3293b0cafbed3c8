#!/usr/bin/env python3
"""The mesh step and the decode loop captured over NCCL, one rank a card,
on four cards.

    python3 scripts/torch_parallel_nccl.py [--timeout SECONDS]

The counterpart of JAX's ``jit`` over a mesh: on a mesh whose process
groups are NCCL every rank replays its decode step and its train step as
one CUDA graph, collectives included, and runs each call's decode loop
as one CUDA-graph WHILE node, its collectives inside the body (the
``lax.while_loop`` under ``jit``; ``core/graphs.py``). This script holds
that on four H100s:

Builds the kernels, then starts one world of four ranks over NCCL
(``parallel/launch.py --backend nccl``), a rank a card, each building the
headline model (chip_smoke's phase 4 widths, bfloat16; and its int8
weights):

1. Rank 0 runs the one-process references on its card first: greedy
   ``generate`` and ``generate_baseline`` (tokens, graphed ms a step, ms
   an iteration of the device loop), ``generate_sample`` at T* (the
   temperature at which the cycle token has probability 0.85), greedy and
   sampled two-lane ``generate_batch``, a greedy call ended by an EOS id
   (the token at new position EOS_AT), a greedy ``always_fwd_one=False``
   call and four requests' lone ``generate``; every rank receives them,
   T* and the EOS id.
2. The train step (Adam; chip_smoke's check model, float32, TF32 off) on
   dp4 and dp2_tp2: three steps eager and three graphed from the same
   start, bit-equal on every rank, each within chip_smoke's card against
   CPU limits of three one-device steps on the whole batch; then ms a
   train step, graphed and eager.
3. On each decode mesh (tp4, la4 with S=240 split 60 rows a rank,
   pp2_tp2, la2_tp2, and int8_weights_tp4) every rank runs, on one
   engine (and one with ``always_fwd_one=False``), eagerly (inside
   ``graphs.eager()``), graphed (each decode loop on the device) and, for
   every call that loops on the device (LOOP_KINDS), by the host loop
   (``host_loop=True``): the calls of step 1, two greedy
   ``generate_stream`` calls of which the second runs on a second slot
   while the first is suspended, a greedy ``generate`` from a
   ``precompute_prefix`` cache and (tp4) a ``ContinuousBatchingEngine``
   of four requests on two lanes. Each call is warmed once (the graphed
   warm call captures), then run and counted alone. Checks: tokens,
   steps, the pool rows and the draw counters the states ended with,
   branches and the iterations (replays) equal across ranks, the three
   ways equal each other and the tokens the one-process run's; the
   graphed call launches one device loop whose iterations are its steps
   (the EOS-ended call's: the steps to its EOS id, where the host loop
   runs its batch out), captures nothing and replays its prefill chunks
   (``stats["prefills"]``); the host loop and the eager call count the
   same collectives and branches, and so does the device loop but for
   the EOS-ended call. Prints kernels and collectives a replay (a loop's
   iteration), and the call's wall over its steps (prefill included)
   each way.
4. On each decode mesh, and on rank 0's one process, the lookahead and
   the AR step alone in windows, as chip_smoke's phase 13 times it
   (``chip_smoke.step_windows``: a prefilled state, two timed windows of
   CAPTURE_STEPS steps each way, then one window of CAPTURE_PROFILED
   steps each way under ``torch.profiler``): ms a step graphed and eager
   a rank, kernels a step, device busy a step, the NCCL kernels' share
   of it (an NCCL kernel runs until every rank's has started, so its
   time includes waiting for the other ranks) and the idle share (1 -
   busy / the timed window's wall); beside them the device loop's ms an
   iteration (``chip_smoke.loop_iteration``: CUDA events around one
   launch over LOOP_NEW tokens, twice).

Every failed check is printed; the script exits non-zero if any failed.
Needs four CUDA cards; no test or default of chip_smoke.py depends on it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# name -> (mesh axes, chip_smoke configuration); the engine takes the same
# axes as its EngineConfig's parallel fields
DECODE = {"tp4": (dict(tp=4), "bf16"),
          "la4": (dict(la=4), "bf16"),          # S=240: 60 rows a rank
          "pp2_tp2": (dict(pp=2, tp=2), "bf16"),
          "la2_tp2": (dict(la=2, tp=2), "bf16"),
          "int8_weights_tp4": (dict(tp=4), "int8_weights")}
TRAIN = {"dp4": dict(dp=4), "dp2_tp2": dict(dp=2, tp=2)}
SERVING_MESH = "tp4"         # the mesh that also runs the scheduler
SERVING_LANES, SERVING_REQUESTS, SERVING_NEW = 2, 4, 0.25
NEW, WARM = 32, 8            # new tokens of a call, and of its warm-up
PREFIX_LEN = 40              # tokens of the "prefix" call's prefix
EOS_AT = 20                  # new position of the "eos" call's EOS id
MULTI = ("batch", "batch_sample", "streams")  # calls of two results
# calls that loop on the device, each also run by the host loop
LOOP_KINDS = ("lookahead", "ar_baseline", "sample", "batch", "batch_sample",
              "eos", "refill", "prefix")
LOOP_NEW = {"lookahead": 128, "ar_baseline": 64}   # a timed loop's tokens
TRAIN_TIMED = 20             # steps of each timed train window
WORLD = 4
COLLECTIVES = ("all_reduce", "all_gather", "send", "recv", "broadcast")


def _serving_requests(nxt):
    import lookaheaddecoding_tpu_torch as lt
    return [lt.Request(**r) for r in cs.cb_requests(
        nxt, SERVING_REQUESTS, SERVING_NEW)]


def _engine(mcfg, tree, mesh, axes, **lkw):
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.parallel import shard_params
    return lt.LookaheadEngine(
        mcfg, tree if mesh is None else shard_params(tree, mesh, mcfg),
        lt.LookaheadConfig(level=cs.LEVEL, window_size=cs.WINDOW,
                           guess_set_size=cs.GUESS, pool_from_prompt=True,
                           **lkw),
        lt.EngineConfig(max_seq_len=cs.MAX_SEQ,
                        prefill_chunk=cs.PREFILL_CHUNK, **axes), mesh=mesh)


def _streams(eng, first, second, n):
    """Two greedy streams of ``n`` new tokens: ``first`` suspended after its
    first part while ``second`` runs to its end on a second slot, then
    ``first`` resumed. Each stream's tokens and steps (its slot's)."""
    from types import SimpleNamespace
    a = eng.generate_stream(first, n)
    parts = [next(a)]                           # holds the first slot
    b = [t for part in eng.generate_stream(second, n) for t in part]
    parts += list(a)
    return [SimpleNamespace(tokens=np.array(first + [int(t) for part in parts
                                                     for t in part]),
                            steps=int(eng._slots[0].state.step_idx)),
            SimpleNamespace(tokens=np.array(second + [int(t) for t in b]),
                            steps=int(eng._slots[1].state.step_idx))]


def _calls(eng, refill, prompt, nxt, t_star, eos, serving):
    """kind -> call(n, host_loop=False): a list of GenerationResults of
    ``n`` new tokens (the scheduler's run takes its own budgets, two
    requests when ``n`` is below NEW; the streams give each stream's
    tokens and steps). A LOOP_KINDS call loops on the device where its
    step captures, and by the host loop with ``host_loop``; ``refill``
    is the engine with ``always_fwd_one=False``, ``eos`` the "eos" call's
    EOS id."""
    import lookaheaddecoding_tpu_torch as lt
    sc = lt.SamplingConfig(temperature=t_star, top_k=cs.TOP_K)
    second = cs.make_prompt(nxt, start=5, n=cs.PROMPT_LEN // 2)

    def batch(n, hl, sampled):
        return eng._batch([prompt, second], min(n, cs.PAR_BATCH_NEW), None,
                          0, [0, 1] if sampled else None, None,
                          sc if sampled else None,
                          [t_star, 0.8 * t_star] if sampled else None, None,
                          host_loop=hl)
    out = {
        "lookahead": lambda n, hl=False: [eng._run(
            "greedy", prompt, n, None, 0, return_prefix=True,
            host_loop=hl)],
        "ar_baseline": lambda n, hl=False: [eng._run(
            "ar", prompt, n, None, 0, host_loop=hl)],
        "sample": lambda n, hl=False: [eng._run(
            "sample", prompt, n, None, 0, sampling=sc, host_loop=hl)],
        "batch": lambda n, hl=False: batch(n, hl, False),
        "batch_sample": lambda n, hl=False: batch(n, hl, True),
        "eos": lambda n, hl=False: [eng._run(
            "greedy", prompt, n, eos, 0, return_prefix=True, host_loop=hl)],
        "refill": lambda n, hl=False: [refill._run(
            "greedy", prompt, n, None, 0, host_loop=hl)],
        "streams": lambda n: _streams(eng, prompt, second, n),
        # the prefill covers the prompt past the prefix's PREFIX_LEN rows
        "prefix": lambda n, hl=False: [eng._run(
            "greedy", prompt, n, None, 0,
            prefix=eng.precompute_prefix(prompt[:PREFIX_LEN]),
            host_loop=hl)],
    }
    if serving:
        # one scheduler, whose lanes (and their graph) every call reuses
        cb = lt.ContinuousBatchingEngine(eng, num_lanes=SERVING_LANES)

        def serve(n):
            reqs = _serving_requests(nxt)
            if n < NEW:               # the warm call: two requests
                reqs = reqs[:2]
            return sorted(cb.run(reqs), key=lambda r: r.request_id)
        out["serving"] = serve
    return out


def _end_state(eng, refill, kind):
    """(a hash of the pool rows [0, R) and clocks, the draw counters) that
    the states of a ``kind`` call ended with: the two-lane slot's lanes, or
    the first flat slot (``refill``'s for its kind)."""
    import hashlib
    if kind.startswith("batch"):
        st = eng._lane_slots[2].states
        h = hashlib.sha256()
        for t in (st.pool.values[:, :-1], st.pool.age[:, :-1],
                  st.pool.clock):
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest(), st.draws.tolist()
    st = (refill if kind == "refill" else eng)._slots[0].state
    return cs.pool_hash(st.pool), [int(st.draws)]


def _replay_launches(eng, kind, t_star):
    """{counter: launches a replay} of the graph the timed call of
    ``kind`` replayed (the port's kernels and the collectives): a device
    loop's iteration, or the streams' step; None for the other kinds."""
    import torch
    import lookaheaddecoding_tpu_torch as lt
    mode = {"lookahead": "greedy", "ar_baseline": "ar", "sample": "sample",
            "streams": "greedy", "prefix": "greedy"}.get(kind)
    with torch.inference_mode():
        if kind == "batch":
            return eng._lane_loop(eng._lane_slots[2], False, False,
                                  0).launches_per_replay()
        if mode is None:
            return None
        sc = lt.SamplingConfig(temperature=t_star, top_k=cs.TOP_K)
        get = eng._flat_runner if kind == "streams" else eng._flat_loop
        return get(eng._free_slot(), mode, NEW, None,
                   sc if mode == "sample" else None).launches_per_replay()


# ---------------------------------------------------------------------------
# Decode meshes: one rank
# ---------------------------------------------------------------------------

def world_rank(device):
    """One rank of the run (module docstring, steps 1-4): rank 0 first runs
    the one-process references on its card and hands them and T* to every
    rank; then the train meshes run, and each decode mesh runs each kind's
    call eager and graphed, then its steps alone in windows. Returns
    {mesh: {kind: {mode: record}, "steps": step windows}}, the train
    records, and the mismatches against the one-process run that this
    rank found (with the teacher-forced top-2 margin there: every rank of
    the mesh computes it, their tokens being the same); rank 0's also the
    references."""
    import torch
    import torch.distributed as dist
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.applications import synthetic
    from lookaheaddecoding_tpu_torch.core import graphs
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm
    from lookaheaddecoding_tpu_torch.parallel import collectives, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    mcfg, params, prompt, nxt = synthetic.build_headline(device)
    trees = {"bf16": params}
    out = {"build_s": time.perf_counter() - t0, "mismatch": []}
    shared = [None]
    if dist.get_rank() == 0:
        refs, t_star, p_star, eos = references(
            mcfg, params, prompt, nxt, {config for _, config in
                                        DECODE.values()})
        shared = [dict(refs=refs, t_star=t_star, p_star=p_star, eos=eos)]
        out.update(shared[0])
    dist.broadcast_object_list(shared, src=0)
    refs, t_star, eos = (shared[0][k] for k in ("refs", "t_star", "eos"))
    out["refs_s"] = time.perf_counter() - t0 - out["build_s"]

    print(f"{time.perf_counter() - t0:8.2f} s train", flush=True)
    out["train"] = train_part(device, list(TRAIN))
    for name, (axes, config) in DECODE.items():
        if config not in trees:
            trees[config] = lt.quantize_params(params, bits=8,
                                               quantize_lm_head=True,
                                               lm_head_bits=8)
        mesh = make_mesh(**axes, devices=device)
        eng = _engine(mcfg, trees[config], mesh, axes)
        refill = _engine(mcfg, trees[config], mesh, axes,
                         always_fwd_one=False)
        calls = _calls(eng, refill, prompt, nxt, t_star, eos,
                       name == SERVING_MESH)
        got = {}
        for kind, call in calls.items():
            got[kind] = {}
            ways = ("eager", "graphed") + (("host",) if kind in LOOP_KINDS
                                           else ())
            for which in ways:
                # progress in the rank's log, which a hung world reports
                print(f"{time.perf_counter() - t0:8.2f} s {name} {kind} "
                      f"{which}", flush=True)
                run = ((lambda n: call(n, True)) if which == "host"
                       else call)
                with cs._mode(which):
                    run(WARM)             # graphed: captures
                    torch.cuda.synchronize()
                    cs.reset_counts()
                    qm.counts.update(dict.fromkeys(qm.counts, 0))
                    before = dict(collectives.counts)
                    graphs.reset_stats()
                    t1 = time.perf_counter()
                    res = run(NEW)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t1
                    stats = graphs.read_stats()
                steps = [r.steps for r in res]
                rec = dict(
                    tokens=[r.tokens.tolist() for r in res], steps=steps,
                    call_ms_step=1e3 * wall / max(steps), stats=stats,
                    collectives={k: collectives.counts[k] - before[k]
                                 for k in before},
                    launches=dict(cs.read_counts(), **{
                        k: v for k, v in qm.counts.items() if k != "plain"}))
                if kind in LOOP_KINDS:
                    rec["pool"], rec["draws"] = _end_state(eng, refill, kind)
                if which == "graphed" and kind != "serving":
                    rec["per_replay"] = _replay_launches(eng, kind, t_star)
                got[kind][which] = rec
            if kind in ("lookahead", "ar_baseline"):
                want = refs[config][kind]
                bad = cs.divergence(eng, got[kind]["graphed"]["tokens"][0],
                                    want, len(prompt))
                if bad is not None:
                    out["mismatch"].append((name, kind, bad))
        print(f"{time.perf_counter() - t0:8.2f} s {name} steps alone",
              flush=True)
        got["steps"] = step_figures(eng, prompt)
        out[name] = got
        del eng, refill, calls
        torch.cuda.empty_cache()
    return out


def check_decode(ranks, refs, meshes, card, fail):
    """The parent's checks of every rank's decode records, and the report."""
    for name in meshes:
        axes, config = DECODE[name]
        per = [r[name] for r in ranks]
        for kind in (k for k in per[0] if k != "steps"):
            e = [p[kind]["eager"] for p in per]
            g = [p[kind]["graphed"] for p in per]
            h = [p[kind]["host"] for p in per] if kind in LOOP_KINDS else []

            def same(key, recs, label):
                if any(x[key] != recs[0][key] for x in recs):
                    fail(f"{name} {kind}: {label} {key} differ across "
                         f"ranks")
            state = ("pool", "draws") if kind in LOOP_KINDS else ()
            for label, recs in (("eager", e), ("graphed", g), ("host", h)):
                if not recs:
                    continue
                for key in ("tokens", "steps") + state:
                    same(key, recs, label)
                for key in ("branches", "taken", "replays", "loops"):
                    if any(x["stats"][key] != recs[0]["stats"][key]
                           for x in recs):
                        fail(f"{name} {kind}: {label} {key} differ across "
                             f"ranks (the iterations each rank ran: "
                             f"{[x['stats']['replays'] for x in recs]})")
            for label, other in (("graphed", g), ("host", h)):
                for key in ("tokens", "steps") + state:
                    if other and other[0][key] != e[0][key]:
                        fail(f"{name} {kind}: {label} {key} != eager")
            # the EOS call's device loop stops at the step that ended it;
            # the host loop (and the eager call) runs its batch out
            counted = (("graphed", g),) if kind != "eos" else ()
            for label, other in counted + (("host", h),):
                for key in ("branches", "taken"):
                    if other and other[0]["stats"][key] != e[0]["stats"][key]:
                        fail(f"{name} {kind}: {label} {key} "
                             f"{other[0]['stats'][key]} != eager "
                             f"{e[0]['stats'][key]}")
                if other and any(x["collectives"] != y["collectives"]
                                 for x, y in zip(e, other)):
                    fail(f"{name} {kind}: a rank's {label} call counted "
                         f"other collectives than its eager call")
            if (e[0]["stats"]["captured"] or e[0]["stats"]["replays"]
                    or e[0]["stats"]["prefills"] or e[0]["stats"]["loops"]):
                fail(f"{name} {kind}: the eager call replayed a graph")
            # streams each step their own slot; lanes step together
            steps = (sum if kind == "streams" else max)(g[0]["steps"])
            # the scheduler's fused drains loop on the device, its lanes
            # on the host
            loops = (1 if kind in LOOP_KINDS else
                     g[0]["stats"]["loops"] if kind == "serving" else 0)
            if g[0]["stats"]["captured"] or g[0]["stats"]["loops"] != loops \
                    or (kind != "serving"
                        and g[0]["stats"]["replays"] != steps):
                fail(f"{name} {kind}: graphed call captured "
                     f"{g[0]['stats']['captured']}, launched "
                     f"{g[0]['stats']['loops']} device loops and replayed "
                     f"{g[0]['stats']['replays']} times for {steps} steps")
            if h and (h[0]["stats"]["loops"] or h[0]["stats"]["captured"]
                      or h[0]["stats"]["replays"] < steps
                      or (kind != "eos"
                          and h[0]["stats"]["replays"] != steps)):
                fail(f"{name} {kind}: the host loop launched "
                     f"{h[0]['stats']['loops']} device loops and replayed "
                     f"{h[0]['stats']['replays']} times for {steps} steps")
            if kind in ("sample", "batch_sample", "refill") and \
                    g[0]["draws"] != g[0]["steps"]:
                fail(f"{name} {kind}: draws {g[0]['draws']} != steps "
                     f"{g[0]['steps']}")
            if not g[0]["stats"]["replays"]:
                fail(f"{name} {kind}: the graphed call replayed nothing")
            if not g[0]["stats"]["prefills"] or any(
                    x["stats"]["prefills"] != g[0]["stats"]["prefills"]
                    for x in g):
                fail(f"{name} {kind}: prefill chunks replayed by rank "
                     f"{[x['stats']['prefills'] for x in g]}")
            want = refs[config].get(kind)
            if want is not None:
                want = want if isinstance(want[0], list) else [want]
                if g[0]["tokens"] != want:
                    fail(f"{name} {kind}: tokens differ from the one-process "
                         f"run")
            launches = g[0]["launches"]
            if launches["plain"] or launches["attention_fma"]:
                fail(f"{name} {kind}: a plain version or the FMA design ran: "
                     f"{launches}")
            key = ("paged_attention" if kind.startswith("batch")
                   or kind == "serving" else "attention_mma")
            if not launches[key]:
                fail(f"{name} {kind}: {key} never launched")
            if config == "int8_weights" and not launches["int8_mma"]:
                fail(f"{name} {kind}: int8_mma never launched")
            per_replay = g[0].get("per_replay") or {}
            host_ms = (" | host loop " + ", ".join(
                f"{x['call_ms_step']:.3f}" for x in h)) if h else ""
            eos_line = (f"; the device loop ran {g[0]['stats']['replays']} "
                        f"iterations for the {steps} steps to the EOS id, "
                        f"the host loop {h[0]['stats']['replays']} replays"
                        if kind == "eos" else "")
            cs.log(
                f"  [{card}] {name} {kind}: {steps} steps; device loops "
                f"{g[0]['stats']['loops']}, iterations and replays by rank "
                f"{[x['stats']['replays'] for x in g]}"
                f"{eos_line}; the call's wall over its steps (prefill "
                f"included), ms by rank graphed "
                f"{', '.join(f'{x['call_ms_step']:.3f}' for x in g)}{host_ms}"
                f" | eager "
                f"{', '.join(f'{x['call_ms_step']:.3f}' for x in e)}; "
                f"prefill chunks replayed {g[0]['stats']['prefills']}; "
                f"collectives of the call {g[0]['collectives']}; branches "
                f"{g[0]['stats']['branches']}, chains taken "
                f"{g[0]['stats']['taken']}"
                + (f"; draws {g[0]['draws']}" if kind in LOOP_KINDS else "")
                + f"; the call's launches (attention, paged attention, int8 "
                f"products) by rank "
                f"{[(x['launches']['attention_mma'], x['launches']['paged_attention'], x['launches']['int8_mma']) for x in g]}"
                + (f"; a replay launches {per_replay}, collectives "
                   f"{sum(per_replay.get(k, 0) for k in COLLECTIVES)}"
                   if per_replay else ""))
        cs.log(f"  [{card}] {name}: tokens equal across the {len(per)} "
               f"ranks, device loop == host loop == eager, and against the "
               f"one-process {config} run as checked above")


# ---------------------------------------------------------------------------
# The step alone, in windows
# ---------------------------------------------------------------------------

STEP_MODES = {"lookahead": "greedy", "ar_baseline": "ar"}


def profile_mesh_steps(run, n):
    """``chip_smoke.profile_steps`` with the NCCL kernels apart: {kernels
    a step, device busy ms a step, NCCL kernels' ms a step, profiled wall
    ms a step} of ``run(n)``, n decode steps; None if the profiler records
    no kernel. The profiler's "nccl:*" annotations, which span their NCCL
    kernels, are not kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("nccl:")]
    if not kernels:
        return None
    ms = [(e.name, e.time_range.elapsed_us() / 1e3) for e in kernels]
    return dict(kernels=len(kernels) / n,
                busy_ms=sum(t for _, t in ms) / n,
                nccl_ms=sum(t for k, t in ms if "nccl" in k.lower()) / n,
                wall_ms=wall_ms / n)


def step_figures(eng, prompt):
    """The lookahead and the AR step of ``eng`` alone in windows
    (``chip_smoke.step_windows``), and its decode loop on the device:
    {kind: {"eager"|"graphed": {"ms": the two timed windows' ms a step,
    "profile": profile_mesh_steps' numbers of the profiled window},
    "loop": [(device ms an iteration, iterations) of two launches of the
    loop over LOOP_NEW[kind] tokens, CUDA events around each]}}: the
    graphed window's replays are queued by the host, the loop's
    iterations by the WHILE node."""
    out = {}
    for kind, mode in STEP_MODES.items():
        windows = cs.step_windows(cs.flat_step_run(eng, prompt, mode),
                                  cs.CAPTURE_STEPS, cs.CAPTURE_PROFILED,
                                  profiler=profile_mesh_steps)
        out[kind] = {which: dict(ms=walls, profile=profs[-1][0])
                     for which, (walls, profs) in windows.items()}
        out[kind]["loop"] = [cs.loop_iteration(eng, prompt, mode,
                                               LOOP_NEW[kind])
                             for _ in range(2)]
    return out


def step_line(label, figures):
    """One kind's step-alone figures of one rank, as text."""
    parts = []
    for which in ("graphed", "eager"):
        f = figures[which]
        wall = min(f["ms"])
        line = f"{which} {f['ms'][0]:.3f}/{f['ms'][1]:.3f} ms a step"
        p = f["profile"]
        if p is None:
            line += " (device time not measured: no kernel recorded)"
        else:
            line += (f", {p['kernels']:.0f} kernels, device busy "
                     f"{p['busy_ms']:.3f} ms, NCCL {p['nccl_ms']:.3f} ms "
                     f"(share of busy {p['nccl_ms'] / p['busy_ms']:.3f}), "
                     f"idle {1 - p['busy_ms'] / wall:.3f}")
        parts.append(line)
    ratio = min(figures["eager"]["ms"]) / min(figures["graphed"]["ms"])
    loop = figures["loop"]
    return (f"{label}: " + " | ".join(parts) + f"; eager / graphed "
            f"{ratio:.2f}x; the device loop (CUDA events) "
            f"{'/'.join(f'{ms:.3f}' for ms, _ in loop)} ms an iteration "
            f"({loop[0][1]} iterations) against "
            f"{'/'.join(f'{ms:.3f}' for ms in figures['graphed']['ms'])} "
            f"ms a host-queued replay")


def report_steps(ranks, refs, meshes, card):
    """The step-alone figures of every mesh and rank, beside the one
    process's."""
    for config, ref in refs.items():
        for kind in STEP_MODES:
            cs.log(f"  [{card}] " + step_line(
                f"one process, {config}, {kind} step alone",
                ref["steps"][kind]))
    for name in meshes:
        for kind in STEP_MODES:
            for rank, r in enumerate(ranks):
                cs.log(f"  [{card}] " + step_line(
                    f"{name} {kind} step alone, rank {rank}",
                    r[name]["steps"][kind]))


# ---------------------------------------------------------------------------
# Train meshes
# ---------------------------------------------------------------------------

def train_part(device, meshes):
    """Each train mesh on this rank: three Adam steps eager and three
    graphed (bit-equal), against three one-device steps on the whole batch
    (graphed, no mesh), then ms a step of TRAIN_TIMED steps each way."""
    import dataclasses
    import torch
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.applications import train_synthetic
    from lookaheaddecoding_tpu_torch.core import graphs
    from lookaheaddecoding_tpu_torch.parallel import (collectives, make_mesh,
                                                      shard_params)
    from lookaheaddecoding_tpu_torch.training import (init_opt_state,
                                                      make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg = dataclasses.replace(train_synthetic.model_config(torch.float32),
                               num_hidden_layers=cs.CHECK_LAYERS)
    start = lt.init_params(mcfg, seed=0, scale=0.02, device="cpu")
    start = {k: ({kk: vv.to(device) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(device))
             for k, v in start.items()}
    sampler = train_synthetic.make_markov_sampler(
        mcfg.vocab_size, order=cs.LEARNED_ORDER,
        active_vocab=cs.LEARNED_ACTIVE)
    rng = np.random.RandomState(1)
    batches = [sampler(cs.CHECK_BATCH, cs.CHECK_SEQ, rng)
               for _ in range(cs.CHECK_STEPS)]

    leaves = graphs.state_tensors
    one = make_train_step(mcfg, cs.CHECK_SEQ + 1,
                          learning_rate=cs.LEARNED_LR)
    p1, o1 = start, init_opt_state(start)
    one_losses = []
    for b in batches:
        p1, o1, loss = one(p1, o1, b)
        one_losses.append(float(loss))
    out = {}
    for name in meshes:
        mesh = make_mesh(**TRAIN[name], devices=device)
        dp, rows = mesh.coords["dp"], cs.CHECK_BATCH // mesh.shape["dp"]
        local = [b[dp * rows:(dp + 1) * rows] for b in batches]
        shards = shard_params(start, mesh, mcfg)
        step = make_train_step(mcfg, cs.CHECK_SEQ + 1, mesh=mesh,
                               learning_rate=cs.LEARNED_LR)
        runs = {}
        for which in ("eager", "graphed"):
            p, o, losses = shards, init_opt_state(shards), []
            before = dict(collectives.counts)
            with cs._mode(which):
                for b in local:
                    p, o, loss = step(p, o, b)
                    losses.append(float(loss))
            runs[which] = (p, o, losses, {k: collectives.counts[k] - before[k]
                                          for k in before})
        (pe, oe, le, ce), (pg, og, lg, cg) = runs["eager"], runs["graphed"]
        bit_equal = le == lg and all(
            torch.equal(a, b) for a, b in zip(leaves((pe, oe)),
                                              leaves((pg, og))))
        want = shard_params(p1, mesh, mcfg)
        diff = torch.cat([(a - b).abs().flatten() for a, b in
                          zip(leaves(pg), leaves(want))]).cpu().numpy()
        times = {}
        for which in ("eager", "graphed"):
            with cs._mode(which):
                p, o = pg, og
                p, o, _ = step(p, o, local[0])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(TRAIN_TIMED):
                    p, o, _ = step(p, o, local[i % len(local)])
                torch.cuda.synchronize()
                times[which] = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED
        out[name] = dict(
            bit_equal=bit_equal, losses=lg, one_losses=one_losses,
            loss_rel=float(np.max(np.abs(np.array(lg) - one_losses)
                                  / np.abs(one_losses))),
            worst=float(diff.max()), q999=float(np.quantile(diff, 0.999)),
            collectives_eager=ce, collectives_graphed=cg,
            graphs=len(step.graphs), ms_step=times,
            captured=graphs.stats["captured"])
    return out


def check_train(ranks, meshes, card, fail):
    limit = 2 * cs.LEARNED_LR * cs.CHECK_STEPS
    q_limit = cs.LEARNED_LR * 1e-3 * cs.CHECK_STEPS
    for name in meshes:
        per = [r[name] for r in ranks]
        for rank, p in enumerate(per):
            if not p["bit_equal"]:
                fail(f"{name} rank {rank}: the graphed train step is not "
                     f"bit-equal to the eager one after {cs.CHECK_STEPS} "
                     f"steps")
            if p["collectives_eager"] != p["collectives_graphed"]:
                fail(f"{name} rank {rank}: graphed collectives "
                     f"{p['collectives_graphed']} != eager "
                     f"{p['collectives_eager']}")
            if p["graphs"] != 1:
                fail(f"{name} rank {rank}: {p['graphs']} train graphs")
            if p["loss_rel"] > cs.CHECK_LOSS_RTOL:
                fail(f"{name} rank {rank}: loss {p['loss_rel']:.3g} from "
                     f"the one-device step (limit {cs.CHECK_LOSS_RTOL:g})")
            if p["worst"] > limit or p["q999"] > q_limit:
                fail(f"{name} rank {rank}: parameters {p['worst']:.3g} / "
                     f"99.9% {p['q999']:.3g} from the one-device step "
                     f"(limits {limit:g} / {q_limit:g})")
        cs.log(f"  [{card}] train {name}, Adam, {cs.CHECK_STEPS} steps, "
               f"batch {cs.CHECK_BATCH} x {cs.CHECK_SEQ}: graphed bit-equal "
               f"to eager on ranks "
               f"{[p['bit_equal'] for p in per]}; losses "
               f"{np.round(per[0]['losses'], 6).tolist()} (one device "
               f"{np.round(per[0]['one_losses'], 6).tolist()}, worst "
               f"relative {max(p['loss_rel'] for p in per):.3g}); "
               f"parameters against the one-device step: worst "
               f"{max(p['worst'] for p in per):.3g} (limit {limit:g}), 99.9% "
               f"within {max(p['q999'] for p in per):.3g} (limit "
               f"{q_limit:g}); collectives in 3 steps "
               f"{per[0]['collectives_graphed']}; ms a train step by rank "
               f"graphed {', '.join(f'{p['ms_step']['graphed']:.3f}' for p in per)}"
               f" | eager {', '.join(f'{p['ms_step']['eager']:.3f}' for p in per)}")


# ---------------------------------------------------------------------------
# The one-process references and the run
# ---------------------------------------------------------------------------

def references(mcfg, params, prompt, nxt, configs):
    """The one-process run on this rank's card (rank 0's, before the
    meshes): each configuration's tokens of every call, its steps alone in
    windows, and T*."""
    import torch
    import lookaheaddecoding_tpu_torch as lt

    refs, t_star, p_star, eos = {}, None, None, None
    for config in sorted(configs):
        tree = params if config == "bf16" else lt.quantize_params(
            params, bits=8, quantize_lm_head=True, lm_head_bits=8)
        eng = _engine(mcfg, tree, None, {})
        refill = _engine(mcfg, tree, None, {}, always_fwd_one=False)
        if t_star is None:
            t_star, p_star, _ = cs.cycle_temperature(eng, prompt)
            eos = int(eng.generate(prompt, NEW).tokens[len(prompt) + EOS_AT])
        calls = _calls(eng, refill, prompt, nxt, t_star, eos, False)
        refs[config] = {"steps": step_figures(eng, prompt)}
        for kind, call in calls.items():
            call(WARM)
            torch.cuda.synchronize()
            res = call(NEW)
            refs[config][kind] = ([r.tokens.tolist() for r in res]
                                  if kind in MULTI else
                                  res[0].tokens.tolist())
        refs[config]["serving"] = [
            eng.generate(r.prompt, r.max_new_tokens).tokens.tolist()
            for r in sorted(_serving_requests(nxt),
                            key=lambda r: r.request_id)]
        del eng, refill
    torch.cuda.empty_cache()
    return refs, t_star, p_star, eos


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the world of ranks may take")
    a = ap.parse_args(argv)
    if torch.cuda.device_count() < WORLD:
        print("needs four CUDA cards", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor
    from lookaheaddecoding_tpu_torch.ops import _build
    from lookaheaddecoding_tpu_torch.parallel.launch import WorldError, launch

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; count "
           f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}; {card}")
    failures = []

    def fail(msg):
        failures.append(msg)
        cs.log(f"  FAILED: {msg}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SIGNATURES)) as ex:
        list(ex.map(_build.build, _build.SIGNATURES))
    cs.log(f"[seconds] build: {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    try:
        ranks = launch(f"{os.path.abspath(__file__)}:world_rank", WORLD,
                       "nccl", "cuda", timeout=a.timeout)
    except WorldError as e:
        cs.log(f"the world failed: {str(e)[-8000:]}")
        return 1
    cs.log(f"[seconds] world: {time.perf_counter() - t0:.1f} (model built "
           f"on each rank in {', '.join(f'{r['build_s']:.1f}' for r in ranks)}"
           f" s; rank 0's one-process references "
           f"{ranks[0]['refs_s']:.1f} s)")
    refs = ranks[0]["refs"]
    cs.log(f"  [{card}] T* = {ranks[0]['t_star']:.4f} gives the cycle "
           f"token p = {ranks[0]['p_star']:.4f}")
    for rank, r in enumerate(ranks):
        for name, kind, bad in r["mismatch"]:
            fail(f"{name} {kind} rank {rank}: differs from the one-process "
                 f"run at {bad}")
    check_decode(ranks, refs, list(DECODE), card, fail)
    report_steps(ranks, refs, list(DECODE), card)
    check_train([r["train"] for r in ranks], list(TRAIN), card, fail)
    cs.log(card)
    if failures:
        cs.log(f"{len(failures)} check(s) failed")
        return 1
    cs.log("every check passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
