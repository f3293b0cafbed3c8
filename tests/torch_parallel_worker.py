"""Rank functions of ``tests/test_torch_parallel.py`` and of the parallel
cases of ``test_torch_compat.py`` and ``test_torch_applications.py``.

Each runs on every rank of a world started by
``lookaheaddecoding_tpu_torch.parallel.launch`` (gloo, on the CPU) and
returns JSON. It imports the port alone: the parent test holds the JAX
references and hands the models over as ``.npz`` files of the JAX
package's trees (``save_tree``).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import lookaheaddecoding_tpu_torch as lt
from lookaheaddecoding_tpu_torch.core.graphs import state_tensors
from lookaheaddecoding_tpu_torch.ops.graph_cond import if_node as _if_node
from lookaheaddecoding_tpu_torch.parallel import collectives
from lookaheaddecoding_tpu_torch.parallel.sharding import (
    AXES, Mesh, _coords, make_mesh, make_multihost_mesh, shard_params)
from lookaheaddecoding_tpu_torch.training.train_step import (
    init_opt_state, make_train_step)

F32 = dict(dtype=torch.float32)


def mesh_at(rank: int, dp: int = 1, tp: int = 1, la: int = 1, pp: int = 1,
            device="cpu") -> Mesh:
    """The mesh of ``make_mesh`` as rank ``rank`` sees it, without process
    groups: for sharding a tree outside a world."""
    ranks = np.arange(dp * pp * la * tp).reshape(dp, pp, la, tp)
    return Mesh(dict(zip(AXES, ranks.shape)), _coords(ranks, rank),
                torch.device(device), ranks)


def small(**kw):
    """The JAX sharding tests' model: vocab 128, hidden 64, 2 layers, 8
    query heads on 4 KV heads."""
    arch = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=4, max_position_embeddings=128)
    return lt.LlamaConfig(**{**arch, **kw}, **F32)


def pipe(layers=4):
    """test_pipeline.py's model: vocab 256, 4 layers, 8/4 heads."""
    return small(vocab_size=256, num_hidden_layers=layers,
                 max_position_embeddings=256)


def multihost(**kw):
    """test_multihost.py's model: 4 query heads on 2 KV heads."""
    return small(**{"num_attention_heads": 4, "num_key_value_heads": 2,
                    "max_position_embeddings": 256, **kw})


def la_rows():
    """The la partition check's model (S = 48 at L5/W8/G4)."""
    return small(vocab_size=256, hidden_size=128, intermediate_size=256,
                 max_position_embeddings=256)


# (model, engine settings, prompt, new tokens) of each decode case; the
# parent builds the same ones for its references. The window is seeded
# with ``order_copy_from``: the default ``copy_from`` draws from each
# framework's own generator, and the steps are compared with JAX's.
LC = dict(level=4, window_size=5, guess_set_size=4,
          window_init="order_copy_from")
LC_POOL = dict(LC, pool_from_prompt=True)
EC = dict(max_seq_len=128, prefill_chunk=16)


def prompt_of(name):
    rs = np.random.RandomState
    return {"small": list(rs(0).randint(0, 128, size=12)),
            "la": list(rs(4).randint(0, 128, size=12)),
            "bias": list(rs(2).randint(0, 128, size=10)),
            "pipe": list(rs(3).randint(1, 256, size=12)),
            "multihost": list(range(1, 17))}[name]


def prefix_prompt():
    rng = np.random.RandomState(9)
    system = list(rng.randint(1, 256, size=24))
    return system, system + list(rng.randint(1, 256, size=8))


# name -> (model file, config, lookahead, engine, prompt, new tokens, mesh,
# EngineConfig's parallel fields)
DECODE = {
    "tp4": ("small", small(), LC, EC, "small", 40, dict(tp=4), dict(tp=4)),
    "tp4_kv2": ("small_kv2", small(num_key_value_heads=2), LC, EC, "small",
                40, dict(tp=4), dict(tp=4)),
    # test_review_regressions.py's bias model (4 query heads on 2 KV)
    "tp4_bias": ("bias", multihost(attention_bias=True,
                                   max_position_embeddings=512),
                 LC, EC, "bias", 20, dict(tp=4), dict(tp=4)),
    "pp2": ("pipe", pipe(), LC_POOL, EC, "pipe", 32, dict(pp=2), dict(pp=2)),
    "pp2_tp2": ("pipe", pipe(), LC_POOL, EC, "pipe", 32, dict(pp=2, tp=2),
                dict(pp=2, tp=2)),
    "pp4_int8kv": ("pipe", pipe(), LC_POOL, dict(EC, kv_quant="int8"),
                   "pipe", 32, dict(pp=4), dict(pp=4)),
    "la2_tp2": ("la", small(), LC_POOL, EC, "la", 40, dict(tp=2, la=2),
                dict(tp=2, la=2)),
    "multihost_tp4": ("multihost", multihost(),
                      dict(LC_POOL, guess_set_size=5),
                      dict(max_seq_len=256, prefill_chunk=64), "multihost",
                      32, dict(tp=4), dict(tp=4)),
}


def save_tree(path, tree) -> None:
    """A parameter tree of numpy arrays as one ``.npz``."""
    flat = {k: v for k, v in tree.items() if k != "layers"}
    flat.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_tree(path, cfg, device="cpu"):
    with np.load(path) as z:
        tree = {"layers": {}}
        for k in z.files:
            if k.startswith("layers/"):
                tree["layers"][k[7:]] = z[k]
            else:
                tree[k] = z[k]
    return lt.params_from_numpy(tree, cfg, device)


def engine(cfg, params, lc, ec, device, mesh=None, par=None):
    return lt.LookaheadEngine(
        cfg, params, lt.LookaheadConfig(**lc),
        lt.EngineConfig(**ec, **(par or {})), device=device, mesh=mesh)


def _result(r):
    return {"tokens": r.tokens.tolist(), "steps": r.steps,
            "compression": r.compression_ratio}


def _decode(name, data, device):
    model, cfg, lc, ec, prompt, n, mesh_kw, par = DECODE[name]
    mesh = make_mesh(**mesh_kw, devices=device)
    if mesh.coords is None:
        return None
    params = shard_params(load_tree(Path(data) / f"{model}.npz", cfg), mesh,
                          cfg)
    return _result(engine(cfg, params, lc, ec, device, mesh,
                          par).generate(prompt_of(prompt), n))


def _refusals(data, device):
    """The engine's pp checks, with JAX's messages."""
    out = {}
    cfg3 = pipe(layers=3)
    mesh2 = make_mesh(pp=2, devices=device)
    mesh4 = make_mesh(pp=4, devices=device)
    params3 = lt.init_params(cfg3, seed=0, scale=0.1, device=device)
    params4 = load_tree(Path(data) / "pipe.npz", pipe())
    for case, cfg, params, mesh, pp in (
            ("divisible", cfg3, params3, mesh2, 2),
            ("no_mesh", pipe(), params4, None, 2),
            ("axis_size", pipe(), params4, mesh4, 2)):
        if mesh is not None and mesh.coords is None:
            continue
        try:
            lt.LookaheadEngine(cfg, params, lt.LookaheadConfig(**LC_POOL),
                               lt.EngineConfig(**EC, pp=pp), device=device,
                               mesh=mesh)
            out[case] = None
        except ValueError as e:
            out[case] = str(e)
    return out


def _prefix(data, device):
    system, prompt = prefix_prompt()
    out = {}
    for key, kw in (("pp2", dict(pp=2)), ("pp2_tp2", dict(pp=2, tp=2))):
        mesh = make_mesh(**kw, devices=device)
        if mesh.coords is None:
            out[key] = None
            continue
        params = shard_params(load_tree(Path(data) / "pipe.npz", pipe()),
                              mesh, pipe())
        eng = engine(pipe(), params, LC_POOL, EC, device, mesh, kw)
        pc = eng.precompute_prefix(system)
        out[key] = _result(eng.generate(prompt, 24, prefix=pc))
    return out


def _la_rows(data, device):
    """Rows of every matrix product of one la=2 decode step at S=48."""
    cfg = la_rows()
    mesh = make_mesh(la=2, devices=device)
    if mesh.coords is None:
        return None
    params = shard_params(load_tree(Path(data) / "la_rows.npz", cfg), mesh,
                          cfg)
    eng = engine(cfg, params, dict(level=5, window_size=8, guess_set_size=4,
                                   pool_from_prompt=True), EC, device, mesh,
                 dict(la=2))
    assert eng.layout.seq_len == 48
    out_buf, n, fill = eng._host_args(list(range(1, 13)), 16)
    rows = []
    products = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)

    class Rows(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in products:
                rows.append(int(args[0].shape[-2]))
            return func(*args, **(kwargs or {}))

    with torch.inference_mode():
        state = eng._prepare(out_buf, n, 0, fill)
        eos = torch.full((4,), -1, dtype=torch.int32)
        with Rows():
            eng._fns.decode_step(eng.params, state, 16, eos)
    return rows


def _logits(data, device):
    """One causal forward over the pipe model's prompt on each mesh and on
    the whole tree: whether the logits are bit-equal to the whole tree's,
    their largest difference, and their bytes' hash (every rank of a mesh
    must hold the same)."""
    import hashlib

    from lookaheaddecoding_tpu_torch.models import llama

    cfg = pipe()
    params = load_tree(Path(data) / "pipe.npz", cfg)
    tokens = torch.tensor(prompt_of("pipe"))
    cos, sin = llama.rope_tables(cfg, 64, "cpu")

    def run(tree, mesh=None, split=False):
        k, v = llama.make_kv_cache(cfg, 64, "cpu", params=tree)
        meta = dict(level=4, window=5, guess_size=3, sliding_window=0,
                    causal=True, kv_len=torch.zeros(1, dtype=torch.int32))
        with torch.inference_mode():
            return llama.forward(tree, cfg, tokens, torch.arange(len(tokens)),
                                 k, v, 0, cos, sin, meta, mesh=mesh,
                                 split_rows=split)[0]
    whole = run(params)
    out = {}
    for name, kw in (("pp2", dict(pp=2)), ("pp4", dict(pp=4)),
                     ("tp4", dict(tp=4)), ("la2_tp2", dict(la=2, tp=2))):
        mesh = make_mesh(**kw, devices=device)
        if mesh.coords is None:
            out[name] = None
            continue
        got = run(shard_params(params, mesh, cfg), mesh, "la" in kw)
        out[name] = {"equal": bool(torch.equal(got, whole)),
                     "max_diff": float((got - whole).abs().max()),
                     "sha": hashlib.sha256(got.numpy().tobytes()).hexdigest()}
    return out


def batched_requests():
    """Prompts of the paged-step case: two lanes of generate_batch, three
    scheduler requests on two lanes."""
    rs = np.random.RandomState(11)
    return [list(rs.randint(1, 256, size=n)) for n in (12, 9, 15)]


def _paged_step(data, device):
    """generate_batch and ContinuousBatchingEngine (two lanes) on the
    paged step at pp=2 x tp=2."""
    cfg = pipe()
    mesh = make_mesh(pp=2, tp=2, devices=device)
    eng = engine(cfg, shard_params(load_tree(Path(data) / "pipe.npz", cfg),
                                   mesh, cfg), LC_POOL, EC, device, mesh,
                 dict(pp=2, tp=2))
    prompts = batched_requests()
    batch = eng.generate_batch(prompts[:2], 24)
    lanes = lt.ContinuousBatchingEngine(eng, num_lanes=2).run(
        [lt.Request(prompt=p, max_new_tokens=20, request_id=i)
         for i, p in enumerate(prompts)])
    return {"batch": [_result(r) for r in batch],
            "lanes": {str(r.request_id): r.tokens.tolist() for r in lanes}}


def entry_points(eng):
    """The flat engine's other entry points on the pipe model's prompt:
    the AR baseline, sampling, greedy and sampling streams, a carried
    second turn. Tokens as lists."""
    p = prompt_of("pipe")
    sc = lt.SamplingConfig(temperature=0.9, top_k=20, top_p=0.95)
    first = eng.generate(p, 16, return_prefix=True)
    turn2 = list(first.tokens) + [5, 6]
    return {
        "baseline": eng.generate_baseline(p, 24).tokens.tolist(),
        "sample": eng.generate_sample(p, 24, sc, seed=3).tokens.tolist(),
        "stream": [int(t) for part in eng.generate_stream(
            p, 24, steps_per_yield=2) for t in part],
        "stream_sample": [int(t) for part in eng.generate_stream(
            p, 24, sampling=sc, seed=3) for t in part],
        "turn2": eng.generate(turn2, 16, prefix=first.prefix).tokens.tolist(),
    }


def _entry_points(data, device):
    """:func:`entry_points` at dp=2 x pp=2: pp keeps one device's bits, so
    even the sampled tokens equal the unsharded engine's."""
    cfg = pipe()
    mesh = make_mesh(dp=2, pp=2, devices=device)
    return entry_points(engine(
        cfg, shard_params(load_tree(Path(data) / "pipe.npz", cfg), mesh,
                          cfg), LC_POOL, EC, device, mesh, dict(pp=2)))


def _quantized(data, device):
    """int8 and int4 weights quantized by the port, at tp=2 (dp=2 x tp=2:
    both dp replicas decode)."""
    cfg = small()
    mesh = make_mesh(dp=2, tp=2, devices=device)
    out = {}
    for bits in (8, 4):
        q = lt.quantize_params(load_tree(Path(data) / "small.npz", cfg),
                               bits=bits, quantize_lm_head=True,
                               lm_head_bits=bits)
        params = shard_params(q, mesh, cfg)
        out[f"int{bits}"] = _result(engine(cfg, params, LC, EC, device, mesh,
                                           dict(tp=2)).generate(
            prompt_of("small"), 40))
    return out


# name -> (model file, config, mesh) of each sharded train step
TRAIN = {"dp2_tp2": ("train", small(), dict(dp=2, tp=2)),
         "pp2_tp2": ("train", small(), dict(pp=2, tp=2)),
         # two tp ranks hold each KV head: their gradients are summed
         "tp4_kv2": ("small_kv2", small(num_key_value_heads=2), dict(tp=4))}


OPTIMIZERS = {"adam": 1e-3, "sgd": 0.1}      # optimizer -> learning rate


def _train(name, data, device):
    """One step of ``TRAIN[name]`` on this rank's dp rows with each
    optimizer of OPTIMIZERS (SGD's update is the gradient itself, Adam's
    nearly its sign); the updated shards go to
    ``train_{name}_{optimizer}_rank{r}.npz``."""
    model, cfg, mesh_kw = TRAIN[name]
    mesh = make_mesh(**mesh_kw, devices=device)
    params = shard_params(load_tree(Path(data) / f"{model}.npz", cfg), mesh,
                          cfg)
    batch = np.load(Path(data) / "batch.npy")
    rows = len(batch) // mesh.shape["dp"]
    dp = mesh.coords["dp"]
    out = {}
    for opt, lr in OPTIMIZERS.items():
        step = make_train_step(cfg, seq_len=64, mesh=mesh, learning_rate=lr,
                               optimizer=opt)
        new, _, loss = step(params, init_opt_state(params, opt),
                            batch[dp * rows:(dp + 1) * rows])
        flat = {k: v.numpy() for k, v in new.items() if k != "layers"}
        flat.update({f"layers/{k}": v.numpy()
                     for k, v in new["layers"].items()})
        np.savez(Path(data) / f"train_{name}_{opt}_rank{dist.get_rank()}.npz",
                 **flat)
        out[opt] = float(loss)
    return out


def _multihost_train(data, device):
    """make_multihost_mesh(dp_hosts=2, tp=2): two steps on the host's
    rows."""
    cfg = multihost()
    mesh = make_multihost_mesh(dp_hosts=2, tp=2, devices=device)
    params = shard_params(load_tree(Path(data) / "multihost.npz", cfg), mesh,
                          cfg)
    batch = np.load(Path(data) / "batch.npy")
    rows = len(batch) // 2
    dp = mesh.coords["dp"]
    local = batch[dp * rows:(dp + 1) * rows]
    step = make_train_step(cfg, seq_len=32, mesh=mesh, learning_rate=1e-3)
    params2, opt, loss = step(params, init_opt_state(params), local)
    _, _, loss2 = step(params2, opt, local)
    return {"coords": mesh.coords, "loss": float(loss),
            "loss_after_step": float(loss2)}


# ---------------------------------------------------------------------------
# What capturing a mesh step needs (CUDA graphs on an NCCL mesh), held on
# the gloo world: fixed addresses, no-op steps after ``finished``, no host
# read but the cond predicate, the same branches on every rank, and a
# faked capture equal to the eager step
# ---------------------------------------------------------------------------

# name -> (model file, config, mesh, EngineConfig's parallel fields): every
# rank of the world is in each mesh (dp fills the rest)
CAPTURE_MESHES = {
    "tp2": ("small", small(), dict(dp=2, tp=2), dict(tp=2)),
    "pp2": ("pipe", pipe(), dict(dp=2, pp=2), dict(pp=2)),
    "la2": ("la", small(), dict(dp=2, la=2), dict(la=2)),
    "la2_tp2": ("la", small(), dict(la=2, tp=2), dict(tp=2, la=2)),
}
SAMPLING = dict(temperature=0.9, top_k=20, top_p=0.95)


def _capture_engine(name, data, device, **lkw):
    model, cfg, mesh_kw, par = CAPTURE_MESHES[name]
    mesh = make_mesh(**mesh_kw, devices=device)
    params = shard_params(load_tree(Path(data) / f"{model}.npz", cfg), mesh,
                          cfg)
    return engine(cfg, params, dict(LC_POOL, **lkw), EC, device, mesh, par)


def prepared(eng, p, n_new, seed=0):
    """A flat slot prepared for ``p`` with the call's max_new and EOS."""
    from lookaheaddecoding_tpu_torch.core.engine import _eos_vec
    out_buf, n, fill = eng._host_args(p, n_new)
    slot = eng._free_slot()
    eng._prepare(out_buf, n, seed, fill, slot=slot)
    slot.max_new.fill_(n_new)
    slot.eos.copy_(_eos_vec(None))
    return slot


def _step_kinds(eng, n_new=24):
    """{kind: (state tree, one step)} of the three flat steps and the two
    batched ones, each on a state of its own, freshly prepared for
    ``n_new`` new tokens."""
    from lookaheaddecoding_tpu_torch.core.engine import lane_slot, write_lane
    temps, top_p, top_k = eng._warp(lt.SamplingConfig(**SAMPLING))
    fns, params = eng._fns, eng.params
    out = {}
    for kind in ("decode_step", "sample_step", "baseline_step"):
        slot = prepared(eng, prompt_of("small"), n_new)
        eng._slots.remove(slot)     # the next kind prepares a slot of its own
        st = slot.state
        out[kind] = (slot, {
            "decode_step": lambda st=st, slot=slot: fns.decode_step(
                params, st, slot.max_new, slot.eos),
            "sample_step": lambda st=st, slot=slot: fns.sample_step(
                params, st, slot.max_new, slot.eos, temps, top_p, top_k),
            "baseline_step": lambda st=st, slot=slot: fns.baseline_step(
                params, st, slot.max_new, slot.eos)}[kind])
    bfns = eng._batch_fns()
    for kind in ("decode_batch", "sample_batch"):
        lanes = lane_slot(eng, 2)
        for b, p in enumerate((prompt_of("small"), prompt_of("la"))):
            out_buf, n, fill = eng._host_args(p[:10 + b], n_new)
            write_lane(lanes, lanes.index[b:b + 1],
                       eng._prepare(out_buf, n, 3 + b, fill))
        lanes.max_new.fill_(n_new)
        args = (params, lanes.k_pool, lanes.v_pool, lanes.states,
                lanes.max_new, lanes.eos)
        out[kind] = (lanes, (lambda a=args: bfns.decode_batch(*a))
                     if kind == "decode_batch" else
                     (lambda a=args, lanes=lanes: bfns.sample_batch(
                         *a, lanes.temperature, lanes.top_p,
                         SAMPLING["top_k"])))
    return out


class HostReads(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the ops that read a tensor's value back to the host or
    whose output shape depends on data: a captured step may make none.
    A copy to the CPU device (``graphs.fetch``, a call's read back) is
    recorded as ``fetch``."""

    SYNCING = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
               "item")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name.lstrip("_") in self.SYNCING or name in self.SYNCING:
            self.seen.append(func.__name__)
        elif (name in ("to", "_to_copy") and (kwargs or {}).get("copy")
              and kwargs.get("device") == torch.device("cpu")):
            self.seen.append("fetch")
        return func(*args, **(kwargs or {}))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _still_after_finished(eng, kind, tree, step):
    """Whether, once ``finished`` holds (the flat steps: by max_new; the
    batched ones: set), three more steps leave every buffer bit-equal but
    the cache rows past the committed ones and the pools' write-only trash
    rows (``test_torch_graphs.py``'s rules)."""
    if kind.endswith("batch"):
        tree.states.finished.fill_(True)
        M = eng.ecfg.max_seq_len
        kv = tree.states.kv_len.tolist()
        caches = state_tensors((tree.k_pool, tree.v_pool))
        committed = [t[:, :, b * M:b * M + kv[b]] for t in caches
                     for b in range(len(kv))]
        pool = tree.states.pool
        others = [t for t in state_tensors((tree.states, tree.max_new, tree.eos))
                  if t is not pool.values and t is not pool.age]
        others += [pool.values[:, :-1], pool.age[:, :-1]]
    else:
        state = tree.state
        for _ in range(40):
            step()
            if bool(state.finished):
                break
        if not bool(state.finished):
            return False
        kv = int(state.kv_len)
        caches = state_tensors((state.k_cache, state.v_cache))
        committed = [c[..., :kv, :] for c in caches]
        pool = state.pool
        others = [t for t in state_tensors(tree)
                  if not any(t is c for c in caches + [pool.values,
                                                       pool.age])]
        others += [pool.values[:-1], pool.age[:-1]]
    kept = [t.clone() for t in committed + others]
    for _ in range(3):
        step()
    return _equal(committed + others, kept)


def _mesh_steps(name, data, device):
    """Each step kind at mesh ``name``: whether every state tensor kept its
    address across three steps (and the steps changed the state); the ops
    that read back to the host in one step, with ``graphs.cond``'s
    predicate replaced by a call that runs the body unread (the one read a
    capture turns into an IF node), and those calls' predicate shapes;
    and whether steps after ``finished`` changed nothing."""
    from lookaheaddecoding_tpu_torch.core import graphs
    eng = _capture_engine(name, data, device, pool_key_len=2,
                          pool_hash_size=97, always_fwd_one=False)
    out = {}
    cond, conds = graphs.cond, []

    def unread(pred, body):
        conds.append(list(pred.shape))
        body()
    with torch.inference_mode():
        for kind, (tree, step) in _step_kinds(eng).items():
            before = [t.data_ptr() for t in state_tensors(tree)]
            old = [t.clone() for t in state_tensors(tree)]
            for _ in range(3):
                step()
            kept = [t.data_ptr() for t in state_tensors(tree)] == before
            changed = not _equal(state_tensors(tree), old)
            step()
            conds.clear()
            graphs.cond = unread
            try:
                with HostReads() as mode:
                    step()
            finally:
                graphs.cond = cond
            out[kind] = {"addresses_kept": kept, "changed": changed,
                         "host_reads": mode.seen, "conds": list(conds)}
        for kind, (tree, step) in _step_kinds(eng, n_new=6).items():
            out[kind]["after_finished_unchanged"] = _still_after_finished(
                eng, kind, tree, step)
    return out


def _branches(name, data, device):
    """Eager ``generate`` and ``generate_batch`` at mesh ``name``: every
    ``graphs.cond`` predicate the rank read, in order, and the branch
    counts."""
    from lookaheaddecoding_tpu_torch.core import graphs
    eng = _capture_engine(name, data, device, pool_key_len=2,
                          pool_hash_size=97)
    preds = []
    cond = graphs.cond

    def recorded(pred, body):
        preds.append(bool(pred))
        cond(pred, body)
    graphs.reset_stats()
    graphs.cond = recorded
    try:
        eng.generate(prompt_of("la"), 40)
        eng.generate_batch([prompt_of("small"), prompt_of("la")[:9]], 24)
    finally:
        graphs.cond = cond
    got = graphs.read_stats()
    return {"preds": preds, "branches": got["branches"], "taken": got["taken"]}


# set while a faked graph replays: a faked WHILE node then loops
_replaying: list = []


def _fake_while(finished, cap, iters, body, body_stream, pool=None):
    """``ops.graph_cond.while_node`` under :func:`faked_capture`. Captured,
    it records its body as the card does: the body runs once (a faked
    capture restores the state after it) and the WHILE node's two
    condition kernels are counted. Replayed, it runs its body while any of
    ``finished`` is clear and fewer than ``cap`` iterations have run,
    counting them in ``iters``, as the device would."""
    from torch.utils._python_dispatch import _disable_current_modes
    from lookaheaddecoding_tpu_torch.ops import graph_cond
    if not _replaying:
        graph_cond.counts["set_while"] += 2
        body()
        return

    def live():                 # the condition kernel's: no host read
        with _disable_current_modes():
            return (bool((~finished).any())
                    and int(iters) < int(cap.view(-1)[0]))
    iters.zero_()
    while live():
        body()
        iters.add_(1)


def _fake_if(pred, body, body_stream):
    """``ops.graph_cond.if_node`` under :func:`faked_capture`: the real one
    (its plain version on the CPU) but in a replay, whose predicate the IF
    node's condition kernel reads on the device, not the host."""
    from torch.utils._python_dispatch import _disable_current_modes
    if not _replaying:
        return _if_node(pred, body, body_stream)
    with _disable_current_modes():
        taken = bool(pred)
    if taken:
        body()


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU. It records the
    generators registered with it, and a replay runs ``step`` (what the
    capture recorded, or one a test puts there) as the graph would: its
    conds as IF nodes (the body runs when the predicate holds and ticks
    the graph's device counter: :func:`_fake_if`), a loop graph's WHILE
    node as a loop (:func:`_fake_while`) and no launch counted by Python (a
    replay runs none). The nodes' own condition reads are hidden from a
    dispatch mode (:class:`HostReads`), the step's ops are not."""

    def __init__(self):
        self.owner, self.step, self.generators = None, None, []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        from lookaheaddecoding_tpu_torch.core import graphs
        owner = self.owner
        tallies = [dict(t) for t in graphs._TALLIES]
        conds = owner.conds
        graphs._active = (owner, True)
        _replaying.append(True)
        try:
            self.step()
        finally:
            _replaying.pop()
            graphs._active = None
            for t, old in zip(graphs._TALLIES, tallies):
                t.update(old)
            owner.conds = conds


@contextlib.contextmanager
def faked_capture():
    """torch.cuda's streams and graphs on the CPU, and ``graphs.capturable``
    true: engines and train steps made inside capture. The warm step runs;
    the capture (with the cycle collector off) runs what it records (the
    step, or a loop graph's WHILE node with its body once:
    :func:`_fake_while`), its collectives too on every rank alike, and then
    restores the state, its generators and the counts (a capture launches
    nothing); a replay is :class:`_FakeGraph`'s. Yields the graphs made, in
    order."""
    import gc
    from lookaheaddecoding_tpu_torch.core import graphs
    from lookaheaddecoding_tpu_torch.ops import graph_cond
    from lookaheaddecoding_tpu_torch.training import train_step

    made, capturing = [], []
    capture = graphs.StepGraph._capture

    def tracked(self):
        capturing.append(self)
        try:
            capture(self)
        finally:
            capturing.pop()

    class Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode="global"):
        # no collection during a capture: destroying an unreachable graph
        # then would invalidate it
        assert not gc.isenabled()
        made.append(g)
        owner = g.owner = capturing[-1]
        g.step = owner._record
        kept = [(t, t.clone()) for t in graphs.state_tensors(owner.state)]
        gens = [(x, x.get_state())
                for x in graphs.state_generators(owner.state)]
        try:
            yield
        finally:
            for t, old in kept:
                t.copy_(old)
            for x, st in gens:
                x.set_state(st)

    patches = [(graphs.StepGraph, "_capture", tracked),
               (graphs, "capturable", lambda device, mesh=None: True),
               (train_step, "_graphed",
                lambda dev, mesh: not graphs.eager_depth()),
               (torch.cuda, "Stream", Stream),
               (torch.cuda, "current_stream", lambda: Stream()),
               (torch.cuda, "stream", lambda s: contextlib.nullcontext()),
               (torch.cuda, "CUDAGraph", _FakeGraph),
               (graph_cond, "while_node", _fake_while),
               (graph_cond, "if_node", _fake_if),
               (torch.cuda, "graph", graph),
               (torch.cuda, "graph_pool_handle", lambda: None)]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, value in patches:
        setattr(obj, attr, value)
    try:
        yield made
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)


def _counted(fn):
    """(fn's results, collectives called, graphs stats) of one call."""
    from lookaheaddecoding_tpu_torch.core import graphs
    calls = dict(collectives.counts)
    graphs.reset_stats()
    res = fn()
    got = graphs.read_stats()
    return (res if isinstance(res, list) else [res],
            {k: collectives.counts[k] - calls[k] for k in calls}, got)


def _streams(eng, p, q):
    """A greedy ``generate_stream`` of ``p`` suspended after its first
    part while a second one, of ``q``, runs to its end on a second slot,
    then the first resumed: each stream's tokens and steps (its slot's
    step count)."""
    from types import SimpleNamespace
    first = eng.generate_stream(p, 24)
    parts = [next(first)]                       # holds the first slot
    second = [t for part in eng.generate_stream(q, 16) for t in part]
    parts += list(first)
    return [SimpleNamespace(tokens=np.array(p + [int(t) for part in parts
                                                 for t in part]),
                            steps=int(eng._slots[0].state.step_idx)),
            SimpleNamespace(tokens=np.array(q + [int(t) for t in second]),
                            steps=int(eng._slots[1].state.step_idx))]


# new tokens of each of _mesh_calls' kinds (the streams apart); the new
# position whose greedy token is the "eos" call's EOS id
MESH_NEW = {"generate": 32, "baseline": 24, "sample": 32, "batch": 24,
            "prefix": 24, "batch_sample": 16, "eos": 20, "refill": 20}
EOS_AT = 6


def _mesh_calls(eng, refill, p, q, eos):
    """kind -> (the call, its host-loop twin or None) of :func:`_fake_captured`
    on ``eng`` (``refill``: the same mesh with ``always_fwd_one=False``):
    every entry point that loops on the device where its step captures,
    each twin the same call by the host loop (``host_loop=True``); the
    streams keep the host loop and have no twin."""
    sc, n = lt.SamplingConfig(**SAMPLING), MESH_NEW

    def prefixed(host_loop):
        pc = eng.precompute_prefix(p[:8])
        return eng._run("greedy", p, n["prefix"], None, 0, prefix=pc,
                        host_loop=host_loop)

    def batch(kind, sampled, host_loop):
        return eng._batch([p, q], n[kind], None, 0,
                          [5, 6] if sampled else None, None,
                          sc if sampled else None,
                          [0.7, 1.2] if sampled else None, None,
                          host_loop=host_loop)
    sampled = dict(seeds=[5, 6], sampling=sc, temperatures=[0.7, 1.2])
    return {
        "generate": (lambda: eng.generate(p, n["generate"],
                                          return_prefix=True),
                     lambda: eng._run("greedy", p, n["generate"], None, 0,
                                      return_prefix=True, host_loop=True)),
        "baseline": (lambda: eng.generate_baseline(p, n["baseline"]),
                     lambda: eng._run("ar", p, n["baseline"], None, 0,
                                      host_loop=True)),
        "sample": (lambda: eng.generate_sample(p, n["sample"], sc, seed=3),
                   lambda: eng._run("sample", p, n["sample"], None, 3,
                                    sampling=sc, host_loop=True)),
        "batch": (lambda: eng.generate_batch([p, q], n["batch"]),
                  lambda: batch("batch", False, True)),
        "batch_sample": (lambda: eng.generate_batch(
                             [p, q], n["batch_sample"], **sampled),
                         lambda: batch("batch_sample", True, True)),
        "eos": (lambda: eng.generate(p, n["eos"], eos_token_id=eos,
                                     return_prefix=True),
                lambda: eng._run("greedy", p, n["eos"], eos, 0,
                                 return_prefix=True, host_loop=True)),
        "refill": (lambda: refill.generate(p, n["refill"], seed=4),
                   lambda: refill._run("greedy", p, n["refill"], None, 4,
                                       host_loop=True)),
        "streams": (lambda: _streams(eng, p, q), None),
        "prefix": (lambda: prefixed(False), lambda: prefixed(True)),
    }


def _end_state(eng, refill, kind):
    """(the pool rows [0, R) and clock each result's state ended with, as
    lists; the states' draw counters) after a call of ``kind``: the lanes
    of ``generate_batch``'s two-lane slot, or the first flat slot (of
    ``refill`` for its kind)."""
    if kind.startswith("batch"):
        st = eng._lane_slots[2].states
        pools = [[st.pool.values[b, :-1].tolist(),
                  st.pool.age[b, :-1].tolist(), int(st.pool.clock[b])]
                 for b in range(2)]
        return pools, st.draws.tolist()
    st = (refill if kind == "refill" else eng)._slots[0].state
    return ([[st.pool.values[:-1].tolist(), st.pool.age[:-1].tolist(),
              int(st.pool.clock)]], [int(st.draws)])


def _fake_captured(name, data, device):
    """At mesh ``name`` on engines made inside :func:`faked_capture`, each
    call of :func:`_mesh_calls`: eager (``graphs.eager()``), then graphed
    twice (the first call captures) and by the host loop. Each call's
    tokens, steps, collectives called, branch counts, the graphed calls'
    captures and replays of decode steps and of prefill chunks, the
    device loops they launched, and the pool rows and draw counters its
    states ended with (the rows themselves for the graphed call, a hash
    otherwise)."""
    import hashlib
    import json
    from lookaheaddecoding_tpu_torch.core import graphs
    p, q = prompt_of("la"), prompt_of("small")[:9]
    out = {}
    with faked_capture():
        eng = _capture_engine(name, data, device, pool_key_len=2,
                              pool_hash_size=97)
        refill = _capture_engine(name, data, device, pool_key_len=2,
                                 pool_hash_size=97, always_fwd_one=False)
        with graphs.eager():
            eos = int(eng.generate(p, MESH_NEW["eos"]).tokens[
                len(p) + EOS_AT])
        for kind, (fn, host) in _mesh_calls(eng, refill, p, q, eos).items():
            ways = [("eager", fn), ("first", fn), ("graphed", fn)]
            out[kind] = {}
            for which, call in ways + ([("host", host)] if host else []):
                with (graphs.eager() if which == "eager"
                      else contextlib.nullcontext()):
                    res, calls_, st = _counted(call)
                rec = out[kind][which] = {
                    "tokens": [r.tokens.tolist() for r in res],
                    "steps": [r.steps for r in res],
                    "collectives": calls_, "branches": st["branches"],
                    "taken": st["taken"], "captured": st["captured"],
                    "replays": st["replays"], "prefills": st["prefills"],
                    "loops": st["loops"]}
                if kind != "streams":
                    pools, rec["draws"] = _end_state(eng, refill, kind)
                    rec["pool"] = hashlib.sha256(
                        json.dumps(pools).encode()).hexdigest()
                    if which == "graphed":
                        rec["pool_rows"] = pools
    return out


def _fake_captured_train(data, device):
    """Three Adam steps at dp=2 x tp=2, eager and through
    :func:`faked_capture`: each step's loss and the final shards' hash
    (bit for bit), and the graphs the captured step made."""
    import hashlib
    from lookaheaddecoding_tpu_torch.core import graphs
    cfg = small()
    mesh = make_mesh(dp=2, tp=2, devices=device)
    params = shard_params(load_tree(Path(data) / "train.npz", cfg), mesh, cfg)
    batch = np.load(Path(data) / "batch.npy")
    rows = len(batch) // 2
    local = batch[mesh.coords["dp"] * rows:(mesh.coords["dp"] + 1) * rows]
    out = {}
    with faked_capture():
        step = make_train_step(cfg, seq_len=64, mesh=mesh)
        for which in ("eager", "graphed"):
            p, o, losses = params, init_opt_state(params), []
            calls = dict(collectives.counts)
            with (graphs.eager() if which == "eager"
                  else contextlib.nullcontext()):
                for _ in range(3):
                    p, o, loss = step(p, o, local)
                    losses.append(float(loss))
            sha = hashlib.sha256()
            for t in state_tensors((p, o)):
                sha.update(t.numpy().tobytes())
            out[which] = {"losses": losses, "sha": sha.hexdigest(),
                          "collectives": {k: collectives.counts[k] - calls[k]
                                          for k in calls}}
        out["graphs"] = len(step.graphs)
    return out


def run(device, data):
    """Every case of ``test_torch_parallel.py``, in one order on every
    rank (each mesh's ``new_group`` calls are collective over the world)."""
    torch.manual_seed(0)
    out = {"rank": dist.get_rank(), "world": dist.get_world_size()}
    for name in DECODE:
        out[name] = _decode(name, data, device)
    out["refusals"] = _refusals(data, device)
    out["prefix"] = _prefix(data, device)
    out["la_rows"] = _la_rows(data, device)
    out["logits"] = _logits(data, device)
    out["paged_step"] = _paged_step(data, device)
    out["entry_points"] = _entry_points(data, device)
    out["quantized"] = _quantized(data, device)
    out["train"] = {name: _train(name, data, device) for name in TRAIN}
    out["multihost_train"] = _multihost_train(data, device)
    out["collectives"] = dict(collectives.counts)
    out["mesh_steps"] = {n: _mesh_steps(n, data, device)
                         for n in CAPTURE_MESHES}
    out["branches"] = {n: _branches(n, data, device) for n in CAPTURE_MESHES}
    out["fake_captured"] = {n: _fake_captured(n, data, device)
                            for n in CAPTURE_MESHES}
    out["fake_captured_train"] = _fake_captured_train(data, device)
    return out


def hang(device):
    """Every rank sleeps past the world's time limit."""
    import time
    time.sleep(120)


def hang_in_teardown(device):
    """Every rank returns, then its process group's teardown hangs past
    the launcher's limit for it (set to one second here)."""
    import sys
    import time
    sys.modules["__main__"].TEARDOWN_S = 1.0    # the rank's launch module
    dist.destroy_process_group = lambda *a, **k: time.sleep(60)
    return "done"


def fail_in_a_collective(device):
    """Rank 1 raises while rank 0 waits in an all-reduce that rank 1 never
    joins: the world must end with rank 1's error."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return "unreachable"


# ---------------------------------------------------------------------------
# compat.get_engine and the eval harness with DIST_WORKERS / --tp 2, on a
# stubbed loader (test_torch_compat.py, test_torch_applications.py)
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)


def _stub_loader(data, device):
    cfg = lt.LlamaConfig(**TINY, **F32)
    params = load_tree(Path(data) / "tiny.npz", cfg, device)
    calls = []

    def load(path, dtype=None, device=None):
        calls.append(str(device))
        return cfg, params, "tok"
    return load, calls


def compat_tp2(device, data, prompt, n):
    """``compat.get_engine`` with ``DIST_WORKERS=2``: the rank's mesh, its
    shard and its tokens."""
    import lookaheaddecoding_tpu_torch.compat as lade
    import lookaheaddecoding_tpu_torch.models.convert as convert

    convert.load_pretrained, calls = _stub_loader(data, device)
    lade.config_lade(LEVEL=4, WINDOW_SIZE=5, GUESS_SET_SIZE=4,
                     POOL_FROM_PROMPT=1, USE_FLASH=1, MAX_SEQ_LEN=256,
                     DEBUG=0, DIST_WORKERS=2)
    eng, tok = lade.get_engine("some/model", device=device)
    r = eng.generate(prompt, n)
    return {"tp": eng.mesh.shape["tp"], "coords": eng.mesh.coords,
            "embed_rows": eng.params["embed"].shape[0], "tok": tok,
            "loaded_on": calls, "tokens": r.tokens.tolist(), "steps": r.steps}


def eval_tp2(device, data, prompt, n):
    """``eval_common.make_engine`` with ``--tp 2``."""
    from lookaheaddecoding_tpu_torch.applications import eval_common

    lt.load_pretrained, calls = _stub_loader(data, device)
    args = eval_common.base_parser().parse_args(
        ["--tp", "2", "--device", device, "--max-seq-len", "256"])
    eng, tok, log = eval_common.make_engine(args)
    r = eng.generate(prompt, n)
    return {"tp": eng.ecfg.tp, "coords": eng.mesh.coords,
            "wq_cols": eng.params["layers"]["wq"].shape[-1],
            "loaded_on": calls, "tokens": r.tokens.tolist()}


# ---------------------------------------------------------------------------
# On the card (test_torch_gpu.py): two ranks on one card over gloo
# ---------------------------------------------------------------------------

def card_tp2(device):
    """tp=2 decode of a transition-cycle model in bfloat16 on the card:
    the rank's tokens, the unsharded engine's on the same card, and the
    sharded run's attention launches by design."""
    from lookaheaddecoding_tpu_torch.applications import synthetic
    from lookaheaddecoding_tpu_torch.ops import lookahead_attention as la

    cfg = lt.LlamaConfig(vocab_size=512, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         dtype=torch.bfloat16)
    params = lt.init_params(cfg, seed=0, scale=0.002, device=device)
    embed, head, nxt = synthetic.transition_embed_head(0, 256, 512)
    params["embed"] = torch.from_numpy(embed * 16.0).to(device, cfg.dtype)
    params["lm_head"] = torch.from_numpy(head).to(device, cfg.dtype)
    prompt = synthetic.make_prompt(nxt, n=16)
    lc = lt.LookaheadConfig(level=4, window_size=5, guess_set_size=4,
                            pool_from_prompt=True)
    ec = dict(max_seq_len=256, prefill_chunk=16)
    mesh = make_mesh(tp=2)
    eng = lt.LookaheadEngine(cfg, shard_params(params, mesh, cfg), lc,
                             lt.EngineConfig(**ec, tp=2), mesh=mesh)
    la.counts.update(dict.fromkeys(la.counts, 0))
    r = eng.generate(prompt, 48)
    launches = dict(la.counts)
    one = lt.LookaheadEngine(cfg, params, lc, lt.EngineConfig(**ec),
                             device=device).generate(prompt, 48)
    return {"device": str(eng.device), "tokens": r.tokens.tolist(),
            "steps": r.steps, "one": one.tokens.tolist(),
            "cycle": all(int(nxt[a]) == b for a, b in zip(
                r.tokens[15:-1], r.tokens[16:])), "launches": launches}


def card_nccl_train_one_rank(device):
    """A one-rank NCCL world on the card: three Adam train steps on
    ``make_mesh(tp=1)`` (an NCCL process group, no collective), eager and
    graphed. Whether they are bit-equal, and the graphs captured."""
    from lookaheaddecoding_tpu_torch.core import graphs

    mesh = make_mesh(tp=1)
    cfg = small()
    start = lt.init_params(cfg, seed=0, scale=0.2, device=device)
    batch = np.random.RandomState(1).randint(0, 128, size=(4, 33))
    step = make_train_step(cfg, seq_len=64, mesh=mesh)
    runs = {}
    for which in ("eager", "graphed"):
        p, o = start, init_opt_state(start)
        with (graphs.eager() if which == "eager"
              else contextlib.nullcontext()):
            for _ in range(3):
                p, o, loss = step(p, o, batch)
        runs[which] = (p, o, float(loss))
    return {"backend": dist.get_backend(),
            "train_bit_equal": runs["eager"][2] == runs["graphed"][2] and all(
                torch.equal(a, b) for a, b in zip(
                    state_tensors(runs["eager"][:2]),
                    state_tensors(runs["graphed"][:2]))),
            "train_graphs": len(step.graphs)}
