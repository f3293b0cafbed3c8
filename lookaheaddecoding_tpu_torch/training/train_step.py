"""Next-token training step.

The counterpart of ``lookaheaddecoding_tpu.training.train_step``: a
functional step on a parameter tree (a dict of tensors, as the engines
take it), used to fit benchmark models on the card to synthetic corpora
where no pretrained weights are reachable
(``applications/train_synthetic.py``). Gradients come from autograd through
``models/llama.py:forward_train``.

Adam is optax's ``adam`` written out in optax's order of operations (b1 0.9,
b2 0.999, eps 1e-8, eps_root 0; bias correction by the step count), SGD the
JAX package's momentum variant. With a mesh (``parallel.make_mesh``) the
same step runs on every rank on the rank's shards, with the collectives of
``parallel/collectives.py``.

On the card the step is the counterpart of ``jax.jit(step)`` (and, on a
mesh whose groups are NCCL, of ``jax.jit(step, in_shardings=...)``):
forward, backward, the collectives of both and of the gradient sync, and
the optimizer step are captured once into a CUDA graph on each rank
(``core/graphs.py``'s ``StepGraph``) over static buffers, and each call
copies its arguments in, replays, and clones the results out. On the CPU,
on a mesh with a gloo group (gloo cannot be captured) and inside
``graphs.eager()`` it runs op by op.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..core import graphs
from ..models import llama
from ..parallel import collectives
from ..parallel.sharding import Mesh, split_sizes

B1, B2, EPS = 0.9, 0.999, 1e-8     # optax.adam's defaults (eps_root 0)
OPTIMIZERS = ("adam", "sgd")


def next_token_loss(params, cfg: llama.LlamaConfig, batch: torch.Tensor,
                    rope_cos, rope_sin, mesh=None) -> torch.Tensor:
    """Mean causal cross-entropy over [B, T] token batches (this rank's
    rows on a mesh)."""
    logits = llama.forward_train(params, cfg, batch[:, :-1], rope_cos,
                                 rope_sin, mesh=mesh)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch[:, 1:].reshape(-1).long())


def _leaves(tree, prefix=()) -> List[Tuple[tuple, torch.Tensor]]:
    """(path, tensor) of every leaf, in the tree's key order."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in _leaves(v, prefix + (k,))]
    return [(prefix, tree)]


def _rebuild(paths, tensors) -> Dict:
    out: Dict = {}
    for path, t in zip(paths, tensors):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def _check_optimizer(optimizer: str) -> None:
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {OPTIMIZERS}, "
                         f"got {optimizer!r}")


def make_train_step(
    cfg: llama.LlamaConfig,
    seq_len: int,
    mesh=None,
    learning_rate: float = 1e-3,
    optimizer: str = "adam",
) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, loss)``. The step is functional: it returns new tensors and
    leaves its arguments as they were. It runs where ``params`` live (the
    card, as ``init_params`` places them by default); ``batch`` (a [B, T]
    integer tensor or numpy array, T <= ``seq_len``) is moved there. Adam
    by default (plain SGD stalls on transformer attention patterns);
    ``optimizer="sgd"`` keeps the dependency-free momentum variant.

    On the card (without a mesh, or on one whose groups are all NCCL)
    the step replays a CUDA graph of forward, backward, their collectives
    and optimizer step, captured at the first call of each graph
    key (the optimizer, each leaf's path, dtype and shape in ``params`` and
    ``opt_state``, the batch's shape and dtype) after one warm step; the
    returned step's ``graphs`` holds them by key. A call copies its
    arguments into the graph's static buffers and clones the results out,
    so the contract above holds. A failed capture raises.

    With ``mesh`` every rank of the mesh calls the step with its shards
    (``parallel.shard_params``) and its optimizer state
    (``init_opt_state`` of those shards). ``batch`` is this rank's rows of
    the dp axis: ranks that share a dp coordinate pass the same rows (the
    convention of JAX's multi-process runtime). The forward wraps its tp
    products in Megatron's f/g pair (``models/llama.py:forward_train``); a
    layer stack split over pp is gathered for the step, each stage keeping
    the gradient of its own layers. After the backward the gradient of a
    KV head that several tp ranks hold is summed over them, every gradient
    is averaged over dp, and Adam or SGD steps each local shard. The loss
    is the global mean, the same on every rank."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be the port's parallel.sharding.Mesh "
            f"(parallel.make_mesh), got {type(mesh).__name__}")
    _check_optimizer(optimizer)
    tables = {}      # device -> rope tables of seq_len rows
    captured = {}    # graph key -> (StepGraph, its static buffers)

    def eager(params, opt_state, batch):
        paths, leaves = zip(*_leaves(params))
        dev = leaves[0].device
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            tree = _rebuild(paths, live)
            if mesh is not None:
                tree = _whole_stack(tree, cfg, mesh)
            loss = next_token_loss(tree, cfg, batch, *tables[dev], mesh=mesh)
            grads = torch.autograd.grad(loss, live)
        if mesh is not None:
            grads = _sync_grads(paths, grads, cfg, mesh)
            dp = mesh.group("dp")
            loss = collectives.all_reduce(loss.detach().reshape(1),
                                          dp)[0] / mesh.shape["dp"]
        with torch.no_grad():
            update = _adam if optimizer == "adam" else _sgd
            new, opt_state = update(paths, leaves, grads, opt_state,
                                    learning_rate)
        return _rebuild(paths, new), opt_state, loss.detach()

    def replayed(params, opt_state, batch):
        key = (optimizer, _signature(params), _signature(opt_state),
               tuple(batch.shape), batch.dtype)
        got = captured.get(key)
        if got is None:
            static = dict(params=_clone(params), opt=_clone(opt_state),
                          batch=batch.clone(),
                          loss=torch.zeros((), device=batch.device))

            def body():
                new, opt, loss = eager(static["params"], static["opt"],
                                       static["batch"])
                with torch.no_grad():
                    _copy_into(static["params"], new)
                    _copy_into(static["opt"], opt)
                    static["loss"].copy_(loss)
            got = captured[key] = (graphs.StepGraph(body, static), static)
        else:
            static = got[1]
            _copy_into(static["params"], params)
            _copy_into(static["opt"], opt_state)
            static["batch"].copy_(batch)
        got[0].run(1)
        return (_clone(static["params"]), _clone(static["opt"]),
                static["loss"].clone())

    def step(params, opt_state, batch):
        dev = _leaves(params)[0][1].device
        if dev not in tables:
            tables[dev] = llama.rope_tables(cfg, seq_len, dev)
        batch = torch.as_tensor(batch, device=dev)
        if _graphed(dev, mesh):
            return replayed(params, opt_state, batch)
        return eager(params, opt_state, batch)

    step.graphs = captured
    return step


def _graphed(dev, mesh) -> bool:
    """Whether a step on ``dev`` replays a captured graph: on the card,
    without a mesh or on an NCCL one (``graphs.capturable``), outside
    ``graphs.eager()``."""
    return graphs.capturable(dev, mesh) and not graphs.eager_depth()


def _signature(tree) -> tuple:
    """What a captured step's static buffers depend on: each leaf's path,
    dtype and shape."""
    return tuple((path, t.dtype, tuple(t.shape)) for path, t in _leaves(tree))


def _clone(tree):
    paths, leaves = zip(*_leaves(tree))
    return _rebuild(paths, [t.detach().clone() for t in leaves])


def _copy_into(dst, src) -> None:
    """Each leaf of ``src`` into the leaf of ``dst`` at its path."""
    for path, d in _leaves(dst):
        d.copy_(_get(src, path))


def _whole_stack(params, cfg, mesh):
    """The layer stack gathered over pp (the gradient of each stage's
    slice reaches its own layers alone)."""
    pp = mesh.group("pp")
    if pp is None:
        return params
    sizes = split_sizes(cfg.num_hidden_layers, mesh.shape["pp"])
    layers = {k: collectives.gather_from_region(v, pp, 0, sizes)
              for k, v in params["layers"].items()}
    return {**params, "layers": layers}


def _sync_grads(paths, grads, cfg, mesh):
    """Gradients of the rank's shards, made whole: a KV head held by
    several tp ranks (tp > Hkv) sums the gradients of its copies over
    them, then every gradient is averaged over dp."""
    tp, dp = mesh.group("tp"), mesh.group("dp")
    share = mesh.shape["tp"] // cfg.num_key_value_heads
    out = []
    for path, g in zip(paths, grads):
        if tp is not None and share > 1 and path[-1] in ("wk", "wv"):
            h = mesh.coords["tp"] // share
            g = collectives.all_gather(g[None], tp)[h * share:
                                                    (h + 1) * share].sum(0)
        if dp is not None:
            g = collectives.all_reduce(g, dp) / mesh.shape["dp"]
        out.append(g)
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _adam(paths, params, grads, state, lr):
    """optax.adam, leaf by leaf in optax's order of operations:
    mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, count + 1,
    u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps), and
    p + (-lr) u in p's dtype."""
    count = state["count"] + 1
    c = count.float()
    # float32 bias corrections on the device: no host read or copy a step
    bc1 = 1 - torch.pow(torch.full_like(c, B1), c)
    bc2 = 1 - torch.pow(torch.full_like(c, B2), c)
    new, mus, nus = [], [], []
    for path, p, g in zip(paths, params, grads):
        mu = (1 - B1) * g + B1 * _get(state["mu"], path)
        nu = (1 - B2) * (g * g) + B2 * _get(state["nu"], path)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        new.append((p + (-lr) * u).to(p.dtype))
        mus.append(mu)
        nus.append(nu)
    return new, {"count": count, "mu": _rebuild(paths, mus),
                 "nu": _rebuild(paths, nus)}


def _sgd(paths, params, grads, state, lr):
    """The JAX package's momentum SGD: m = 0.9 m + g (float32), then
    p = (p - lr m) in p's dtype."""
    ms = [0.9 * _get(state, path) + g.float()
          for path, g in zip(paths, grads)]
    new = [(p - lr * m).to(p.dtype) for p, m in zip(params, ms)]
    return new, _rebuild(paths, ms)


def init_opt_state(params, optimizer: str = "adam",
                   learning_rate: float = 1e-3):
    """Adam: optax's ``ScaleByAdamState`` fields as a dict, ``count`` (an
    int32 scalar) and ``mu`` / ``nu`` (zero trees shaped like ``params``).
    SGD: a float32 zero tree."""
    _check_optimizer(optimizer)
    paths, leaves = zip(*_leaves(params))
    if optimizer == "sgd":
        return _rebuild(paths, [torch.zeros_like(p, dtype=torch.float32)
                                for p in leaves])
    return {"count": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device),
            "mu": _rebuild(paths, [torch.zeros_like(p) for p in leaves]),
            "nu": _rebuild(paths, [torch.zeros_like(p) for p in leaves])}
