"""Rank functions of ``tests/test_torch_parallel.py`` and of the parallel
cases of ``test_torch_compat.py`` and ``test_torch_applications.py``.

Each runs on every rank of a world started by
``lookaheaddecoding_tpu_torch.parallel.launch`` (gloo, on the CPU) and
returns JSON. It imports the port alone: the parent test holds the JAX
references and hands the models over as ``.npz`` files of the JAX
package's trees (``save_tree``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import lookaheaddecoding_tpu_torch as lt
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
    return out


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
