"""The mesh and the sharding of parameters and caches over it.

The counterpart of ``lookaheaddecoding_tpu.parallel.sharding``. JAX
expresses every parallel mode as one ``jax.sharding.Mesh`` with the named
axes ``("dp", "pp", "la", "tp")`` and lets XLA insert the collectives; here
a process is a rank, a rank owns one device, and the mesh is that rank's
view of a grid of ranks over the default process group:

  dp - data parallel: the train step's batch rows (replicas when decoding)
  pp - pipeline parallel: the stacked layer axis of parameters and caches
  la - lookahead parallel: the composite step's rows (the reference's
       ``DIST_WORKERS`` mode)
  tp - tensor parallel: Megatron's layout (column-parallel q/k/v, gate/up
       and their biases, row-parallel o/down, the embedding over the
       vocabulary, the LM head over its output columns)

Parameters are plain local tensors, the rank's own shard
(:func:`shard_params`); ``parallel/collectives.py`` holds every collective
the forward and the train step call.

Which heads a tp rank holds. Rank t's query heads are a contiguous block
of Hq/tp heads and its KV heads those that the block reads: Hkv/tp of them
when tp divides Hkv, else the one KV head that all of its query heads
share (tp > Hkv with tp % Hkv == 0: the KV head is held by tp/Hkv ranks,
the rule vLLM follows). Any other split raises a ``ValueError`` that names
Hq, Hkv and tp.

The int4 row-parallel trap. ``wo`` and ``w_down`` are split over their
input rows. An int4 weight is packed split-half, ``[K/2, N]`` bytes whose
packed row j holds input row j in its low nibble and input row j + K/2 in
its high one, so rank t's contiguous block of packed rows
``[t*K/2/tp, (t+1)*K/2/tp)`` holds the input rows of that range AND of the
same range offset by K/2. The rank's slice of x is the concatenation of
those two ranges, not one contiguous block. Here the rank keeps that block
of packed bytes as they are (JAX's ``NamedSharding`` slice of the leaf),
and the column-parallel weights before it take the same two ranges as
their output columns: ``w_gate`` and ``w_up`` before an int4 ``w_down``,
the query heads of the two ranges (and their KV heads) before an int4
``wo``. The rank's activations are then exactly the x slice its packed
rows read, in the split-half order: the low-nibble range first. A padded
int4 weight (``ops/quant.py:pad_packed_rows``) is split on its logical
rows and its shards carry no pad rows.
"""

from __future__ import annotations

import dataclasses
import os
from typing import ClassVar, Dict, Optional, Tuple

import numpy as np
import torch

from .collectives import GRAPH_MIXING

AXES = ("dp", "pp", "la", "tp")

_LAYER_SPECS = {
    # the leading axis is the stacked layer axis, split over "pp"
    "input_norm": ("pp", None),
    "post_norm": ("pp", None),
    "wq": ("pp", None, "tp"),
    "wk": ("pp", None, "tp"),
    "wv": ("pp", None, "tp"),
    "wo": ("pp", "tp", None),
    "w_gate": ("pp", None, "tp"),
    "w_up": ("pp", None, "tp"),
    "w_down": ("pp", "tp", None),
    "bq": ("pp", "tp"),
    "bk": ("pp", "tp"),
    "bv": ("pp", "tp"),
    "bqkv": ("pp", "tp"),
    "wqkv": ("pp", None, "tp"),
    "w_gate_up": ("pp", None, "tp"),
}
_FUSED = ("wqkv", "w_gate_up", "bqkv")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a grid of ranks with the axes ``AXES``.

    ``shape`` maps each axis to its size; ``coords`` are this rank's
    coordinates (None for a rank of the world outside the mesh);
    ``ranks`` is the grid of global ranks, ``np.arange(n).reshape(dp, pp,
    la, tp)`` for :func:`make_mesh`; ``groups`` holds one process group an
    axis of size above 1 (the ranks that differ from this one only on that
    axis). A mesh made by hand without groups (``groups={}``) serves
    :func:`shard_params` alone."""

    shape: Dict[str, int]
    coords: Optional[Dict[str, int]]
    device: torch.device
    ranks: np.ndarray
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)
    axis_names: ClassVar[Tuple[str, ...]] = AXES

    def group(self, axis: str):
        """The process group of ``axis``, None for an axis of size 1."""
        return self.groups.get(axis)

    def peer(self, axis: str, index: int) -> int:
        """Global rank of the rank at this one's coordinates with ``axis``
        set to ``index``."""
        at = dict(self.coords, **{axis: index})
        return int(self.ranks[tuple(at[a] for a in AXES)])

    def split(self, axis: str, n: int) -> Tuple[int, int]:
        """(start, length) of this rank's part of ``n`` rows split over
        ``axis`` as ``torch.tensor_split`` splits them."""
        sizes = split_sizes(n, self.shape[axis])
        i = self.coords[axis]
        return sum(sizes[:i]), sizes[i]


def split_sizes(n: int, parts: int):
    """Part sizes of ``n`` rows in ``parts``, as ``torch.tensor_split``."""
    q, r = divmod(n, parts)
    return [q + (i < r) for i in range(parts)]


def _coords(ranks: np.ndarray, rank: int) -> Optional[Dict[str, int]]:
    hit = np.argwhere(ranks == rank)
    return None if not len(hit) else dict(zip(AXES, map(int, hit[0])))


def _device(devices, rank: int) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % cards}`` by default, or a
    device type ("cpu", "cuda"), or ``devices[rank]`` of a sequence."""
    if devices is None or devices == "cuda" or (
            isinstance(devices, torch.device) and devices.type == "cuda"
            and devices.index is None):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the mesh runs on CUDA devices and none is available; pass "
                "devices='cpu' to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices)
    return torch.device(devices[rank])


def _world():
    """``torch.distributed``, once the default process group is up."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a started process group: run every rank with "
            "`python -m lookaheaddecoding_tpu_torch.parallel.launch --nproc "
            "N --backend {gloo,nccl} --device {cuda,cpu} module:function`, "
            "or under torchrun, or call torch.distributed."
            "init_process_group first")
    return dist


def _build(ranks: np.ndarray, devices) -> Mesh:
    """Groups over the grid ``ranks``. ``new_group`` is collective over the
    world, so every rank of the world calls it for every group, in the same
    order; a rank outside the grid keeps none."""
    dist = _world()

    # before the groups' first collective: NCCL's graph mixing off, so a
    # captured collective can sit in a decode loop's WHILE body
    # (parallel/collectives.py)
    os.environ.update([GRAPH_MIXING])
    me = dist.get_rank()
    groups = {}
    for ai, axis in enumerate(AXES):
        if ranks.shape[ai] == 1:
            continue
        for members in np.moveaxis(ranks, ai, -1).reshape(-1, ranks.shape[ai]):
            g = dist.new_group([int(r) for r in members])
            if me in members:
                groups[axis] = g
    coords = _coords(ranks, me)
    device = _device(devices, me) if coords is not None else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)   # the kernels launch on the current one
    return Mesh(dict(zip(AXES, ranks.shape)), coords, device, ranks, groups)


def make_mesh(dp: int = 1, tp: int = 1, la: int = 1, pp: int = 1,
              devices=None) -> Mesh:
    """The mesh over the first ``dp*pp*la*tp`` ranks of the default process
    group (``init_process_group`` must have run), rank r at the
    coordinates ``np.arange(n).reshape(dp, pp, la, tp)`` gives r, as JAX's
    ``make_mesh`` orders ``devices[:n]``. Every rank of the world calls
    it; the ranks past n get a mesh with ``coords`` None."""
    dist = _world()
    n = dp * pp * tp * la
    have = dist.get_world_size()
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return _build(np.arange(n).reshape(dp, pp, la, tp), devices)


def make_multihost_mesh(dp_hosts: int = 1, tp: int = 1, la: int = 1,
                        pp: int = 1, devices=None) -> Mesh:
    """Data parallelism across hosts, pp/la/tp inside one (JAX's hybrid
    mesh): :func:`make_mesh` with ``dp=dp_hosts``. Ranks are numbered host
    by host (torchrun's convention, rank // LOCAL_WORLD_SIZE is the host),
    so dp, the slowest axis of the grid, runs across hosts."""
    n = dp_hosts * pp * la * tp
    world = _world().get_world_size()
    if world < n:
        raise ValueError(
            f"need {n} devices for dp_hosts={dp_hosts} pp={pp} "
            f"la={la} tp={tp}, have {world}")
    return make_mesh(dp=dp_hosts, tp=tp, la=la, pp=pp, devices=devices)


def param_specs(cfg, params=None) -> Dict:
    """Megatron's layout over ``tp`` and the layer axis over ``pp``: the
    tree of JAX's ``param_specs`` with each ``PartitionSpec`` as a tuple
    of axis names (or None), one per dimension. With ``params`` the tree
    has its exact keys (biases, fused layouts, a tied embedding)."""
    layer_keys = (params["layers"].keys() if params is not None
                  else ("input_norm", "post_norm", "wq", "wk", "wv", "wo",
                        "w_gate", "w_up", "w_down"))
    specs = {"embed": ("tp", None),
             "layers": {k: _LAYER_SPECS[k] for k in layer_keys},
             "final_norm": (None,),
             "lm_head": (None, "tp")}
    if params is not None and "lm_head" not in params:
        del specs["lm_head"]
    return specs


def kv_cache_spec() -> Tuple:
    """KV cache [L, Hkv, M, D]: layers over pp, KV heads over tp;
    replicated over la and dp."""
    return ("pp", "tp", None, None)


def head_sets(cfg, tp: int, t: int, wo_int4_k2: Optional[int] = None):
    """(query heads, KV heads) of tp rank ``t``, as index arrays. With
    ``wo_int4_k2`` (an int4 ``wo``'s logical packed rows) the query heads
    are the two ranges its packed-row block reads (module docstring)."""
    hq, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    if hq % tp:
        raise ValueError(
            f"cannot split Hq={hq} query heads on Hkv={hkv} KV heads over "
            f"tp={tp}: tp must divide the query heads")
    if wo_int4_k2 is None:
        qh = np.arange(t * hq // tp, (t + 1) * hq // tp)
    else:
        cols = _two_ranges(wo_int4_k2, tp, t)
        if (wo_int4_k2 // tp) % d:
            raise ValueError(
                f"an int4 wo splits into whole heads only when 2*tp divides "
                f"the query heads (Hq={hq}, Hkv={hkv}, tp={tp})")
        qh = cols[::d] // d
    rep = hq // hkv
    kvh = np.unique(qh // rep)
    # the rank's GQA: local query head i reads local KV head i // rep_l
    rep_l = len(qh) // len(kvh)
    if len(qh) % len(kvh) or not np.array_equal(
            qh // rep, kvh[np.arange(len(qh)) // rep_l]):
        raise ValueError(
            f"cannot split Hq={hq} query heads on Hkv={hkv} KV heads over "
            f"tp={tp}: tp must divide Hkv, or be a multiple of it")
    return qh, kvh


def _two_ranges(k2: int, tp: int, t: int) -> np.ndarray:
    """Input rows of an int4 row-parallel weight that rank ``t``'s block of
    packed rows holds: its range of the low nibbles, then the same range of
    the high nibbles (offset by ``k2``)."""
    if k2 % tp:
        raise ValueError(f"tp={tp} must divide the {k2} packed rows of an "
                         f"int4 row-parallel weight")
    r = np.arange(t * k2 // tp, (t + 1) * k2 // tp)
    return np.concatenate([r, k2 + r])


def _int4_k2(w) -> Optional[int]:
    if isinstance(w, dict) and "q4" in w:
        return w["q4"].shape[-2] - (w["q4_pad"].shape[-2]
                                    if "q4_pad" in w else 0)
    return None


def _cols(heads: np.ndarray, d: int) -> np.ndarray:
    return (heads[:, None] * d + np.arange(d)).reshape(-1)


def shard_params(params: Dict, mesh: Mesh, cfg) -> Dict:
    """This rank's local shard of every leaf, by :func:`param_specs`, on
    the mesh's device, each a contiguous tensor of its own. The layer
    axis and the vocabulary split as ``torch.tensor_split`` splits them;
    heads and MLP columns as the module docstring says. Quantized leaves
    are split leaf by leaf: an int8 ``q`` as its weight, its ``scale``
    along the weight's output axis (whole for a row-parallel weight); an
    int4 column-parallel ``q4`` on its columns, a row-parallel one by
    packed rows."""
    if mesh.coords is None:
        raise ValueError("this rank lies outside the mesh")
    tp, t = mesh.shape["tp"], mesh.coords["tp"]
    lp = params["layers"]
    if tp > 1 and any(k in lp for k in _FUSED):
        raise ValueError("shard an unfused tree: fused projections "
                         "(wqkv, w_gate_up) have no tensor-parallel layout")
    d = cfg.head_dim
    wo_k2, down_k2 = _int4_k2(lp.get("wo")), _int4_k2(lp.get("w_down"))
    qh, kvh = head_sets(cfg, tp, t, wo_k2)
    if down_k2 is None:
        start, n = mesh.split("tp", cfg.intermediate_size)
        mlp = np.arange(start, start + n)
    else:
        mlp = _two_ranges(down_k2, tp, t)
    # the tp index set of each layer leaf's tp axis
    tp_index = {"wq": _cols(qh, d), "bq": _cols(qh, d),
                "wk": _cols(kvh, d), "bk": _cols(kvh, d),
                "wv": _cols(kvh, d), "bv": _cols(kvh, d),
                "wo": _cols(qh, d), "w_gate": mlp, "w_up": mlp,
                "w_down": mlp}
    l0, nl = mesh.split("pp", cfg.num_hidden_layers)
    dev = mesh.device

    def take(x, axis, index):
        if index is None:
            return x
        if isinstance(index, slice):
            return x.narrow(axis, index.start, index.stop - index.start)
        return x.index_select(axis, torch.as_tensor(index, device=x.device))

    def piece(x, spec, index):
        for axis, name in enumerate(spec):
            if name == "pp":
                x = take(x, axis, slice(l0, l0 + nl))
            elif name == "tp" and tp > 1:
                x = take(x, axis, index)
        return x.to(dev).contiguous()

    def layer_leaf(key, w):
        spec = _LAYER_SPECS[key]
        index = tp_index.get(key)     # None: a norm, or any leaf at tp=1
        if not isinstance(w, dict):
            return piece(w, spec, index)
        row_parallel = spec[1] == "tp"
        out = {}
        for name, leaf in w.items():
            if name == "scale":
                # [L, 1, N]: along the output axis, whole if row-parallel
                out[name] = piece(leaf, ("pp", None, None if row_parallel
                                         else "tp"), index)
            elif name == "q4_pad":
                # [L, pad, 0]: a row-parallel shard carries no pad rows
                pad = (slice(0, 0) if row_parallel else None)
                out[name] = piece(leaf, ("pp", "tp", None), pad)
            elif name == "q4" and row_parallel:
                k2 = _int4_k2(w)
                out[name] = piece(leaf, spec, slice(t * k2 // tp,
                                                    (t + 1) * k2 // tp))
            else:
                out[name] = piece(leaf, spec, index)
        return out

    v0, nv = mesh.split("tp", cfg.vocab_size)
    vocab = slice(v0, v0 + nv)
    out = {"embed": piece(params["embed"], ("tp", None), vocab),
           "final_norm": piece(params["final_norm"], (None,), None),
           "layers": {k: layer_leaf(k, w) for k, w in lp.items()}}
    if "lm_head" in params:
        head = params["lm_head"]
        if isinstance(head, dict):
            # q / q4 and scale over the vocabulary; an int4 head's
            # [pad, 0] sentinel has no vocabulary axis
            out["lm_head"] = {name: piece(leaf, (None, None if name ==
                                                 "q4_pad" else "tp"), vocab)
                              for name, leaf in head.items()}
        else:
            out["lm_head"] = piece(head, (None, "tp"), vocab)
    return out


def local_dims(params: Dict, cfg) -> Tuple[int, int, int]:
    """(layers, query heads, KV heads) that a (sharded or whole) tree
    holds, read from its leaves."""
    lp = params["layers"]

    def width(w):
        w = w if not isinstance(w, dict) else w.get("q", w.get("q4"))
        return w.shape[-1]
    if "wqkv" in lp:
        return (lp["input_norm"].shape[0], cfg.num_attention_heads,
                cfg.num_key_value_heads)
    d = cfg.head_dim
    return (lp["input_norm"].shape[0], width(lp["wq"]) // d,
            width(lp["wk"]) // d)
