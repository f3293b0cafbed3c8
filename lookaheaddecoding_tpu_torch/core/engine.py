"""LookaheadEngine: lookahead generation, greedy and sampling, and its AR
baseline.

    eng = LookaheadEngine(mcfg, params, LookaheadConfig(level=5,
                          window_size=7, guess_set_size=7))
    out = eng.generate(prompt_ids, max_new_tokens=256)
    out = eng.generate_sample(prompt_ids, 256, SamplingConfig(0.8, top_p=0.9))

The engine runs on ``cuda`` unless it is given ``device="cpu"``; without a
CUDA device it raises rather than carry on on the CPU. ``generate`` builds
the KV caches and the pool, seeds the window, fills the pool from the
prompt, prefills, then runs the decode loop; the result comes back in one
device-to-host transfer. ``generate_stream`` yields the new tokens as the
steps confirm them, ``generate_batch`` decodes several prompts with one
batched forward a step, and a :class:`PrefixCache` lets prompts that share
a prefix prefill only their suffix.

On the card every decode loop replays its step as a CUDA graph
(``core/graphs.py``: the counterpart of the JAX engine's ``jax.jit(...,
donate_argnums=...)``) over a static state the engine owns and writes each
call into in place: a :class:`FlatSlot` (a second one only while a
suspended ``generate_stream`` holds the first) and a :class:`LaneSlot` for
each lane count of ``generate_batch``, made at first use. On a ``mesh``
whose groups are NCCL each rank replays its own graph, collectives
included (JAX's ``jit`` over the mesh); the graphs live in a memory pool
of the engine's own, so two engines on one rank never share one.

The request's preparation is JAX's fused prepare call
(``jax.jit(self._make_fused(None))``: caches, window, pool fill and the
prefill ``fori_loop``) in three parts, none of which reads the device
from the host: the host-to-device copies (the prompt's output buffer and
the pool fill's rows, from pinned memory, ``graphs.upload``); the resets
of the caches and the pool (or copies of a prefix's), the window seeding
and the fill, launched eagerly; then the prefill, whose chunks read their
start from device counters, replays of one captured chunk a slot. Every
step runs eagerly on the CPU, on a mesh with a gloo group and inside
``graphs.eager()``.

The decode loop is JAX's ``lax.while_loop`` on ``~finished``: on the card
outside ``graphs.eager()``, on one card or on a mesh whose groups are all
NCCL (each rank its own loop, the collectives inside it),
``generate``, ``generate_sample``, ``generate_baseline`` and
``generate_batch``, greedy or sampled, launch their whole loop once, a
``graphs.LoopGraph`` (a CUDA-graph WHILE node around the captured step),
and read the device once, in the call's final transfer, which also brings
back the loop's iteration count. A sampling step draws from the request's
Philox stream in the state (``ops/philox.py``), whose kernel reads the
draw counter on the device, so every iteration draws fresh numbers. The
rest loops on the host (``step.run_loop``), replaying the captured step
where it captures: ``generate_stream`` (which yields every
``steps_per_yield`` steps, as JAX's does), meshes with a gloo group, the
CPU and ``graphs.eager()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..config import EngineConfig, LookaheadConfig, SamplingConfig
from ..models import llama
from ..ops.lookahead_attention import KERNEL_HEAD_DIMS
from ..ops import philox
from . import graphs
from .layout import Layout, build_layout
from .paged_step import PagedLaneState, build_paged_step_fns
from .pool import (PoolState, apply_host_fill, host_prompt_fill, pool_init,
                   pool_table_rows, upload_fill)
from .state import DecodeState
from .step import build_step_fns, host_batch, run_loop

MAX_EOS_IDS = 4
_INT32_MAX = 2**31 - 1


def _eos_vec(eos_token_id, device="cpu") -> torch.Tensor:
    """Fixed-width EOS id vector (pad -1); any listed id stops generation."""
    if eos_token_id is None:
        ids = []
    elif isinstance(eos_token_id, (int, np.integer)):
        ids = [int(eos_token_id)]
    else:
        ids = [int(i) for i in eos_token_id]
        if len(ids) > MAX_EOS_IDS:
            raise ValueError(
                f"at most {MAX_EOS_IDS} eos ids supported, got {len(ids)}")
    v = np.full((MAX_EOS_IDS,), -1, np.int32)
    v[: len(ids)] = ids
    return torch.from_numpy(v).to(device)


@dataclasses.dataclass
class GenerationResult:
    """Output of one generate call with the acceleration accounting."""

    tokens: np.ndarray          # full sequence: prompt + generated
    prompt_len: int
    steps: int
    wall_time_s: float = 0.0
    request_id: object = None    # set by the serving scheduler
    error: Optional[str] = None  # set when a request fails admission
    # serving latency (set by the serving scheduler): time from submit to
    # the first confirmed new token, and to completion
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None
    # a PagedPrefix over this result's confirmed tokens, when the request
    # asked for it (``return_prefix``): the next turn of a conversation
    # prefills only the new message
    prefix: Optional[object] = None

    @property
    def new_tokens(self) -> np.ndarray:
        return self.tokens[self.prompt_len:]

    @property
    def num_generated(self) -> int:
        return len(self.tokens) - self.prompt_len

    @property
    def compression_ratio(self) -> float:
        return self.num_generated / max(self.steps, 1)

    @property
    def tokens_per_sec(self) -> float:
        return self.num_generated / self.wall_time_s if self.wall_time_s else 0.0


@dataclasses.dataclass(frozen=True)
class PrefixCache:
    """Precomputed KV for a shared prompt prefix (a system prompt, or the
    earlier turns of a conversation).

    Built by :meth:`LookaheadEngine.precompute_prefix`, or returned by a
    call with ``return_prefix=True``. A later call whose prompt starts with
    ``tokens`` prefills only the rest. The caches are full-capacity buffers
    of the engine (one request's KV memory); every call that uses them
    copies them (and the pool) into its own state first and never writes
    them, so one PrefixCache serves any number of calls. The paged engine
    has its own kind, ``PagedPrefix``, whose rows live in the shared page
    pool."""

    tokens: np.ndarray       # [P0] int32, the prefix token ids
    k_cache: object          # [L, Hkv, M, D] or an int8 {"q", "s"} dict
    v_cache: object
    length: int
    # the warm n-gram pool of the turn that produced this prefix
    # (return_prefix results only; precompute_prefix leaves it None): the
    # next turn's guesses hit from its first step
    pool: Optional[PoolState] = None


def _clone(cache):
    """A copy of a plain cache buffer or of an int8 {"q", "s"} dict."""
    if isinstance(cache, dict):
        return {name: t.clone() for name, t in cache.items()}
    return cache.clone()


def _leaf_pairs(dst, src):
    """(destination, source) buffers of two caches of one kind: plain
    tensors or int8 {"q", "s"} dicts."""
    if isinstance(dst, dict):
        return [(dst[name], src[name]) for name in dst]
    return [(dst, src)]


def _clear_cache(cache) -> None:
    """A cache back to ``make_kv_cache``'s contents, in place: zeros, and
    the int8 cache's scales at 1e-8."""
    if isinstance(cache, dict):
        cache["q"].zero_()
        cache["s"].fill_(1e-8)
    else:
        cache.zero_()


@dataclasses.dataclass
class FlatSlot:
    """A flat decode state and every other tensor the step reads, at fixed
    addresses: a request is written into it in place (``_prepare``), and
    the engine's captured steps and prefill chunk (``graphs``) run over it.
    ``max_new`` is a 0-d int32 tensor, ``eos`` [MAX_EOS_IDS] int32,
    ``temperature`` and ``top_p`` [1] float32; ``start0`` (the prefill's
    first row: 0, or a prefix's length) and ``chunk`` (the prefill chunk
    under way) 0-d int32."""

    state: DecodeState
    max_new: torch.Tensor
    eos: torch.Tensor
    temperature: torch.Tensor
    top_p: torch.Tensor
    start0: torch.Tensor
    chunk: torch.Tensor
    graphs: dict = dataclasses.field(default_factory=dict)
    busy: bool = False


@dataclasses.dataclass
class LaneSlot:
    """B lanes laid out as ``generate_batch`` and the continuous-batching
    scheduler lay them: the lanes' flat caches side by side as one pool
    ``[L, Hkv, (B+1)*M, D]``, lane b on page b of M slots and one trash page
    after them; their bookkeeping, each lane's ``max_new``, EOS ids,
    temperature and top_p, and the captured batched steps (``graphs``), at
    fixed addresses."""

    k_pool: object
    v_pool: object
    states: PagedLaneState
    max_new: torch.Tensor       # [B] int32
    eos: torch.Tensor           # [B, MAX_EOS_IDS] int32
    temperature: torch.Tensor   # [B] float32
    top_p: torch.Tensor         # [B] float32
    graphs: dict = dataclasses.field(default_factory=dict)


def lane_slot(eng: "LookaheadEngine", lanes: int) -> LaneSlot:
    """``lanes`` idle lanes of ``eng``: finished, each on its own page, with
    an empty pool and its own stream (``key``, ``draws``)."""
    B, dev = lanes, eng.device
    M, lay = eng.ecfg.max_seq_len, eng.layout
    # B lanes and a trash page of M slots; on a mesh, the rank's shard
    k_pool, v_pool = llama.make_kv_cache(eng.mcfg, (B + 1) * M, dev,
                                         quant=eng.ecfg.kv_quant,
                                         params=eng.params)
    one = pool_init(eng._pool_rows(), lay.guess_set_size, lay.guess_size,
                    dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    states = PagedLaneState(
        table=torch.arange(B, dtype=torch.int32, device=dev)[:, None],
        cap=torch.full((B,), M, dtype=torch.int32, device=dev),
        trash=torch.full((B,), B * M, dtype=torch.int32, device=dev),
        kv_len=zeros(B), window=zeros(B, lay.n_window),
        pool=PoolState(values=one.values[None].repeat(B, 1, 1, 1),
                       age=one.age[None].repeat(B, 1, 1),
                       clock=one.clock[None].repeat(B)),
        out_buf=zeros(B, M + lay.guess_size),
        n_confirmed=zeros(B) + 1, init_len=zeros(B) + 1, step_idx=zeros(B),
        finished=torch.ones(B, dtype=torch.bool, device=dev),
        key=zeros(B, 2), draws=torch.zeros(B, dtype=torch.int64, device=dev))
    return LaneSlot(k_pool=k_pool, v_pool=v_pool, states=states,
                    max_new=zeros(B), eos=zeros(B, MAX_EOS_IDS) - 1,
                    temperature=torch.ones(B, dtype=torch.float32, device=dev),
                    top_p=torch.ones(B, dtype=torch.float32, device=dev))


def write_lane(slot: LaneSlot, lane: int, state: DecodeState) -> None:
    """A prepared flat state (caches, bookkeeping, pool, stream) copied
    into lane ``lane`` of ``slot``, in place."""
    M = _leaf_pairs(state.k_cache, state.k_cache)[0][0].shape[2]
    for pool, cache in ((slot.k_pool, state.k_cache),
                        (slot.v_pool, state.v_cache)):
        for dst, src in _leaf_pairs(pool, cache):
            dst[:, :, lane * M:(lane + 1) * M] = src
    st = slot.states
    for name in ("kv_len", "window", "out_buf", "n_confirmed", "init_len",
                 "step_idx", "finished", "key", "draws"):
        getattr(st, name)[lane] = getattr(state, name)
    for name in ("values", "age", "clock"):
        getattr(st.pool, name)[lane] = getattr(state.pool, name)


def _loop_done(loop: graphs.LoopGraph, finished: bool, iters: int,
               max_new: int) -> None:
    """Count a device loop's ``iters`` iterations, read in the call's final
    transfer, and refuse a loop that stopped at its cap (``max_new``
    iterations: every live step confirms a token) with a lane unfinished;
    it is never run again from the host."""
    loop.account(iters)
    if not finished:
        raise RuntimeError(
            f"the device decode loop stopped at its cap of "
            f"{min(max_new, _INT32_MAX)} iterations with a lane unfinished")


class LookaheadEngine:
    def __init__(
        self,
        model_cfg: llama.LlamaConfig,
        params,
        lookahead: Optional[LookaheadConfig] = None,
        engine: Optional[EngineConfig] = None,
        log=None,
        device=None,
        mesh=None,
    ):
        """``log`` (a ``utils.logging.DecodeLog``, or anything with
        ``append``) takes every result of ``generate``,
        ``generate_sample``, ``generate_baseline`` and ``generate_batch``,
        and those of a ``ContinuousBatchingEngine`` on this engine.

        ``mesh`` (``parallel.make_mesh``) runs the engine on every rank of
        a mesh, each with its shards (``parallel.shard_params``) on the
        mesh's device unless ``device`` says otherwise: tp splits heads,
        MLP columns and the vocabulary, pp the layers (``EngineConfig.pp``
        must equal the mesh's pp axis), la with ``EngineConfig.la > 1``
        the composite step's rows (of the flat step; ``generate_batch``'s
        paged step runs them whole). Every rank calls the same methods
        with the same arguments and gets the same tokens."""
        if mesh is not None and device is None:
            device = mesh.device
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LookaheadEngine runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        self.mcfg = model_cfg
        self.params = params
        self.lcfg = lookahead or LookaheadConfig()
        self.ecfg = engine or EngineConfig()
        self.log = log
        if self.lcfg.attention_impl == "auto":
            # the kernel on the card, the plain version on the CPU; a card
            # never falls back to the dense path unless asked for it
            self.lcfg = dataclasses.replace(
                self.lcfg, attention_impl="kernel"
                if self.device.type == "cuda" else "dense")
        if (self.lcfg.attention_impl == "kernel"
                and self.device.type == "cuda"
                and model_cfg.head_dim not in KERNEL_HEAD_DIMS):
            raise ValueError(
                f"the attention kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                f"got {model_cfg.head_dim}; pass attention_impl='dense' to "
                f"run the plain version on the card")
        e = self.ecfg
        self.mesh = mesh
        self.layout: Layout = build_layout(self.lcfg)
        if e.max_seq_len < self.layout.seq_len + 8:
            raise ValueError("max_seq_len too small for the composite step")
        if e.prefill_chunk > e.max_seq_len:
            raise ValueError("prefill_chunk must not exceed max_seq_len")
        if (model_cfg.sliding_window is not None
                and self.layout.seq_len > model_cfg.sliding_window):
            # committed keys respect the window bound; within the composite
            # block the speculative positions span < S, so S must fit
            raise ValueError(
                "composite step size exceeds the model's sliding window; "
                "reduce level/window_size/guess_set_size")
        if e.pp > 1:
            if mesh is None or "pp" not in mesh.axis_names:
                raise ValueError("pp > 1 requires a mesh with a 'pp' axis")
            if mesh.shape["pp"] != e.pp:
                raise ValueError(
                    f"mesh 'pp' axis size {mesh.shape['pp']} != "
                    f"EngineConfig.pp {e.pp}")
            if model_cfg.num_hidden_layers % e.pp != 0:
                raise ValueError(
                    "num_hidden_layers must be divisible by pp "
                    f"({model_cfg.num_hidden_layers} % {e.pp})")
        if mesh is not None:
            self._check_shards(mesh)
        # a mesh-sharded tree stays unfused
        if e.fuse_projections and mesh is None:
            self.params = llama.fuse_params(self.params)
        self._fns = build_step_fns(model_cfg, self.lcfg, e, self.layout,
                                   self.device, mesh=mesh)
        self._paged_fns = None      # generate_batch's, built on first use
        # On the card, alone or on an NCCL mesh, every decode step is a
        # replayed CUDA graph over a static state (core/graphs.py); on the
        # CPU and on a mesh with a gloo group (gloo's collectives cannot be
        # captured) it runs eagerly.
        self._graphed = graphs.capturable(self.device, mesh)
        self._graph_pool = None     # the graphs' memory pool, at first use
        self._loop_pool = None      # the loop bodies' MemPool, at first use
        self._slots = []            # FlatSlot: one, or one a live stream
        self._lane_slots = {}       # generate_batch's LaneSlot, by lanes

    def _check_shards(self, mesh):
        """The tree must be this rank's shard of the mesh: the layer count
        and embedding rows that ``shard_params`` leaves a rank."""
        from ..parallel.sharding import local_dims
        if mesh.coords is None:
            raise ValueError("this rank lies outside the mesh")
        layers = mesh.split("pp", self.mcfg.num_hidden_layers)[1]
        vocab = mesh.split("tp", self.mcfg.vocab_size)[1]
        if (local_dims(self.params, self.mcfg)[0] != layers
                or self.params["embed"].shape[0] != vocab):
            raise ValueError(
                "params are not this rank's shard of the mesh: pass "
                "parallel.shard_params(params, mesh, cfg)")

    # ------------------------------------------------------------------
    def _host_args(self, prompt_ids, max_new_tokens: int,
                   prefix: Optional[PrefixCache] = None):
        """Validate the prompt; build the output buffer and the pool fill.
        ``max_new_tokens`` beyond capacity is legal (the loop stops at the
        KV budget) but must be at least 1. With a prefix that carries a
        warm pool, the fill covers the new suffix only (plus ``level``
        tokens of context across the boundary): everything before it was
        offered to that pool already."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        P = len(prompt)
        M = self.ecfg.max_seq_len
        if P < 1:
            raise ValueError("empty prompt")
        if P - 1 + self.layout.seq_len > M:
            raise ValueError(
                f"prompt ({P}) + composite step ({self.layout.seq_len}) "
                f"exceeds max_seq_len ({M})")
        if prompt.min() < 0 or prompt.max() >= self.mcfg.vocab_size:
            # an out-of-range id would be a device-side assert on CUDA
            raise ValueError(
                f"prompt token ids must lie in [0, {self.mcfg.vocab_size})")
        if prefix is not None:
            self._reject_dynamic_prefix()
        if prefix is not None and not isinstance(prefix, PrefixCache):
            raise ValueError(
                "the flat engine needs a PrefixCache (from precompute_prefix "
                "or a return_prefix result), not a paged-engine PagedPrefix")
        if prefix is not None and (
                P < prefix.length
                or not np.array_equal(prompt[:prefix.length], prefix.tokens)):
            raise ValueError(
                "prompt does not start with the precomputed prefix")
        out_buf = np.zeros((M + self.layout.guess_size,), np.int32)
        out_buf[:P] = prompt
        fill = None
        if self.lcfg.pool_from_prompt:
            start = 0
            if prefix is not None and prefix.pool is not None:
                start = max(0, prefix.length - self.lcfg.level)
            fill = host_prompt_fill(
                prompt[start:], self.lcfg.level, self.layout.guess_set_size,
                pad_to=M, key_len=self.lcfg.pool_key_len,
                table_rows=self._pool_rows())
        return out_buf, P, fill

    def _reject_dynamic_prefix(self):
        if llama.is_dynamic_rope(self.mcfg):
            # dynamic-NTK keys the prefill's rotation on the full prompt
            # length: prefix rows computed at the prefix's own length would
            # differ from a prefill from scratch past the threshold
            raise ValueError(
                "prefix caching is not supported with dynamic-NTK rope "
                "scaling (the rope base depends on the full prompt length)")

    def _pool_rows(self) -> int:
        return pool_table_rows(self.mcfg.vocab_size, self.lcfg.pool_key_len,
                               self.lcfg.pool_hash_size)

    def _new_slot(self) -> FlatSlot:
        dev, M, lay = self.device, self.ecfg.max_seq_len, self.layout
        k_cache, v_cache = llama.make_kv_cache(
            self.mcfg, M, dev, quant=self.ecfg.kv_quant, params=self.params)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        state = DecodeState(
            k_cache=k_cache, v_cache=v_cache, kv_len=zeros(),
            window=zeros(lay.n_window),
            pool=pool_init(self._pool_rows(), lay.guess_set_size,
                           lay.guess_size, dev),
            out_buf=zeros(M + lay.guess_size), n_confirmed=zeros(),
            init_len=zeros(), step_idx=zeros(),
            finished=torch.ones((), dtype=torch.bool, device=dev),
            key=zeros(2), draws=zeros(dtype=torch.int64))
        return FlatSlot(state=state, max_new=zeros(),
                        eos=zeros(MAX_EOS_IDS) - 1,
                        temperature=zeros(1, dtype=torch.float32) + 1,
                        top_p=zeros(1, dtype=torch.float32) + 1,
                        start0=zeros(), chunk=zeros())

    def _free_slot(self) -> FlatSlot:
        """A FlatSlot no call holds, made at first use (a second one only
        while a suspended ``generate_stream`` holds the first)."""
        for slot in self._slots:
            if not slot.busy:
                return slot
        self._slots.append(self._new_slot())
        return self._slots[-1]

    @contextlib.contextmanager
    def _slot(self):
        """A FlatSlot held for one call."""
        slot = self._free_slot()
        slot.busy = True
        try:
            yield slot
        finally:
            slot.busy = False

    def _prepare(self, out_buf: np.ndarray, prompt_len: int, seed: int,
                 fill, prefix: Optional[PrefixCache] = None,
                 slot: Optional[FlatSlot] = None) -> DecodeState:
        """Caches, pool, window seeding, prompt fill and prefill, written in
        place into ``slot``'s state (by default a free slot's), which is
        returned: JAX's fused prepare call. The caches and the pool start as
        new ones would, or as copies of a prefix's (the prefill's last chunk
        may rewrite some of its rows, and the fill merges into its pool's
        rows); the stream's key is ``seed`` and its counter 0. The host's
        arrays go to the device first, without a wait; the prefill replays
        the slot's captured chunk (:meth:`_prefill`)."""
        slot = slot or self._free_slot()
        state, dev = slot.state, self.device
        out_buf = graphs.upload(out_buf, dev)
        if fill is not None:
            fill = upload_fill(*fill, dev)
        if prefix is None:
            _clear_cache(state.k_cache)
            _clear_cache(state.v_cache)
        else:
            for dst, src in (_leaf_pairs(state.k_cache, prefix.k_cache)
                             + _leaf_pairs(state.v_cache, prefix.v_cache)):
                dst.copy_(src)
        pool = state.pool
        if prefix is not None and prefix.pool is not None:
            for name in ("values", "age", "clock"):
                getattr(pool, name).copy_(getattr(prefix.pool, name))
        else:
            pool.values.zero_()
            pool.age.zero_()
            pool.clock.fill_(1)
        philox.start(state.key, state.draws, seed)
        self._fns.init_state(state, out_buf, prompt_len)
        if fill is not None:
            apply_host_fill(pool, *fill, merge=prefix is not None)
        return self._prefill(slot, prompt_len,
                             0 if prefix is None else prefix.length)

    def _prefill(self, slot: FlatSlot, prompt_len: int,
                 start0: int) -> DecodeState:
        """prompt[start0:-1] into ``slot``'s caches: on the card the slot's
        captured prefill chunk (captured by the first chunk that needs it,
        which is its warm step) replayed once a chunk, over the slot's
        ``start0`` and ``chunk`` counters; a prompt of one token has no
        chunk and captures nothing."""
        fns, params, st = self._fns, self.params, slot.state

        def chunk():
            fns.prefill_chunk(params, st, slot.start0, slot.chunk)
        steps = self._runner(slot.graphs, "prefill", chunk, slot, "prefills")
        return fns.prefill_from(params, st, prompt_len, start0,
                                (slot.start0, slot.chunk), steps.run)

    def _runner(self, cache: dict, key, step, state, counter="replays"):
        if self._graphed and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return graphs.runner(cache, key, step, state, self._graphed,
                             self._graph_pool, counter)

    def _loops(self, mode: str) -> bool:
        """Whether a ``mode`` call ("greedy", "sample" or "ar") runs its
        decode loop on the device: wherever its step is captured (on the
        card, on one card or a mesh whose groups are all NCCL, outside
        ``graphs.eager()``). Every mode qualifies: the random draws of a
        sampling step and of the ``always_fwd_one=False`` refill read
        their counter on the device, and on a mesh every rank's loop runs
        the same iterations (``graphs.LoopGraph``)."""
        return (mode in ("greedy", "sample", "ar") and self._graphed
                and not graphs.eager_depth())

    def _loop(self, cache: dict, key, step, state, finished, cap):
        """The :class:`graphs.LoopGraph` of ``key`` in ``cache``; its body
        allocates in the engine's MemPool (made at first use)."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        if self._loop_pool is None and self.device.type == "cuda":
            self._loop_pool = torch.cuda.MemPool()
        return graphs.loop_runner(cache, key, step, state, finished, cap,
                                  self._graph_pool, self._loop_pool,
                                  self.mesh)

    def _flat_runner(self, slot: FlatSlot, mode: str, max_new: int,
                     eos_token_id, sampling: Optional[SamplingConfig] = None):
        """The step runner of ``mode`` ("greedy", "sample" or "ar") over
        ``slot``, with the call's ``max_new``, EOS ids and warpers written
        into the slot's buffers."""
        step, key = self._flat_step(slot, mode, max_new, eos_token_id,
                                    sampling)
        return self._runner(slot.graphs, key, step, slot)

    def _flat_loop(self, slot: FlatSlot, mode: str, max_new: int,
                   eos_token_id, sampling: Optional[SamplingConfig] = None
                   ) -> graphs.LoopGraph:
        """The decode loop of ``mode`` ("greedy", "sample" or "ar") over
        ``slot`` on the device, with the call's ``max_new`` (the loop's
        cap: every live step confirms a token), EOS ids and warpers written
        into the slot's buffers."""
        step, key = self._flat_step(slot, mode, max_new, eos_token_id,
                                    sampling)
        return self._loop(slot.graphs, key, step, slot, slot.state.finished,
                          slot.max_new)

    def _flat_step(self, slot: FlatSlot, mode: str, max_new: int,
                   eos_token_id, sampling: Optional[SamplingConfig] = None):
        """(one step of ``mode`` over ``slot``, its graph key), with the
        call's buffers written."""
        fns, params, st = self._fns, self.params, slot.state
        slot.max_new.fill_(min(max_new, _INT32_MAX))
        slot.eos.copy_(graphs.upload(_eos_vec(eos_token_id), self.device))
        top_p, top_k = None, 0
        if mode == "sample":
            temps, top_p, top_k = self._warp(sampling)
            slot.temperature.copy_(temps)
            if top_p is not None:
                top_p = slot.top_p.copy_(top_p)
        if mode == "greedy":
            def step():
                fns.decode_step(params, st, slot.max_new, slot.eos)
        elif mode == "ar":
            def step():
                fns.baseline_step(params, st, slot.max_new, slot.eos)
        else:
            def step():
                fns.sample_step(params, st, slot.max_new, slot.eos,
                                slot.temperature, top_p, top_k)
        return step, (mode, top_p is not None, top_k)

    def _lane_runner(self, slot: LaneSlot, sampled: bool, top_p_on: bool,
                     top_k: int):
        """The batched step runner over ``slot``'s lanes: greedy, or
        sampling with the slot's temperatures, its top_p when
        ``top_p_on`` and ``top_k``."""
        step, key = self._lane_step(slot, sampled, top_p_on, top_k)
        return self._runner(slot.graphs, key, step, slot)

    def _lane_loop(self, slot: LaneSlot, sampled: bool, top_p_on: bool,
                   top_k: int) -> graphs.LoopGraph:
        """The batched decode loop over ``slot``'s lanes on the device
        (greedy, or sampling as :meth:`_lane_runner`), while any lane is
        unfinished; its cap is the lanes' shared ``max_new`` (lane 0's)."""
        step, key = self._lane_step(slot, sampled, top_p_on, top_k)
        return self._loop(slot.graphs, key, step, slot, slot.states.finished,
                          slot.max_new)

    def _lane_step(self, slot: LaneSlot, sampled: bool, top_p_on: bool,
                   top_k: int):
        """(one batched step over ``slot``'s lanes, its graph key)."""
        fns, params = self._batch_fns(), self.params
        top_p = slot.top_p if top_p_on else None
        if sampled:
            def step():
                fns.sample_batch(params, slot.k_pool, slot.v_pool,
                                 slot.states, slot.max_new, slot.eos,
                                 slot.temperature, top_p, top_k)
        else:
            def step():
                fns.decode_batch(params, slot.k_pool, slot.v_pool,
                                 slot.states, slot.max_new, slot.eos)
        return step, (sampled, top_p_on, top_k)

    def _finalize(self, state: DecodeState, max_new: int, t0: float,
                  return_prefix: bool = False,
                  loop: Optional[graphs.LoopGraph] = None) -> GenerationResult:
        # one device-to-host transfer for the scalars and the tokens (and,
        # after a device loop, ``finished`` and its iterations)
        scalars = [state.n_confirmed, state.init_len, state.step_idx,
                   state.kv_len]
        if loop is not None:
            scalars += [state.finished.int(), loop.iters[0]]
        host = graphs.fetch(torch.cat([torch.stack(scalars), state.out_buf]))
        n_confirmed, init_len, steps, kv_len = (int(x) for x in host[:4])
        if loop is not None:
            _loop_done(loop, bool(host[4]), int(host[5]), max_new)
        host = host[len(scalars):]
        total = min(n_confirmed, init_len + max_new)   # trim overshoot
        res = GenerationResult(tokens=host[:total].copy(),
                               prompt_len=init_len, steps=steps,
                               wall_time_s=time.perf_counter() - t0)
        if return_prefix:
            res.prefix = self._prefix_of(state, host, kv_len, total)
        if self.log is not None:
            self.log.append(res)
        return res

    @staticmethod
    def _prefix_of(state: DecodeState, out_buf, kv_len: int,
                   total: int) -> PrefixCache:
        """Copies of the run's caches and pool (the slot's own are written
        by the next call) as a PrefixCache over its committed KV rows
        [0, kv_len), clamped to the trimmed result so that the prefix
        tokens are a prefix of the result's."""
        length = min(kv_len, total)
        pool = state.pool
        return PrefixCache(tokens=out_buf[:length].astype(np.int32),
                           k_cache=_clone(state.k_cache),
                           v_cache=_clone(state.v_cache), length=length,
                           pool=PoolState(pool.values.clone(),
                                          pool.age.clone(),
                                          pool.clock.clone()))

    def _warp(self, sampling: SamplingConfig, lanes: int = 1,
              temperatures=None, top_ps=None):
        """(temperature [B], top_p [B] or None, top_k) on the device for a
        sampling step: the config's values, or one a lane. ``top_p`` is
        None when no lane asks for it (host data), which skips the sort;
        any lane below 1 applies to that lane."""
        temps = ([sampling.temperature] * lanes if temperatures is None
                 else list(temperatures))
        tops = [sampling.top_p] * lanes if top_ps is None else list(top_ps)
        temps, top_p = (graphs.upload(np.asarray(v, np.float32), self.device)
                        for v in (temps, tops))
        return temps, top_p if min(tops) < 1.0 else None, sampling.top_k

    def _run(self, mode, prompt_ids, max_new_tokens, eos_token_id, seed,
             prefix=None, return_prefix=False, sampling=None,
             host_loop=False):
        """One call of ``mode``. ``host_loop`` decodes the call by the host
        loop even where it would loop on the device: a profiler records no
        kernel inside a CUDA-graph WHILE body (``chip_smoke.py``'s
        profiles), and the host loop is the device loop's comparison."""
        t0 = time.perf_counter()
        if return_prefix:
            self._reject_dynamic_prefix()
        out_buf, P, fill = self._host_args(prompt_ids, max_new_tokens, prefix)
        with torch.inference_mode(), self._slot() as slot:
            state = self._prepare(out_buf, P, seed, fill, prefix, slot=slot)
            if self._loops(mode) and not host_loop:
                loop = self._flat_loop(slot, mode, max_new_tokens,
                                       eos_token_id, sampling)
                loop.run()
                return self._finalize(state, max_new_tokens, t0,
                                      return_prefix, loop)
            steps = self._flat_runner(slot, mode, max_new_tokens,
                                      eos_token_id, sampling)
            run_loop(steps.run, state, max_new_tokens, P - 1,
                     *self._per_step(mode))
            return self._finalize(state, max_new_tokens, t0, return_prefix)

    def _per_step(self, mode: str):
        """(tokens a ``mode`` step confirms at most, the largest ``kv_len``
        at which it runs without a capacity stop: M - S, the AR step's S
        being 1)."""
        if mode == "ar":
            return 1, self.ecfg.max_seq_len - 1
        return (self.layout.guess_size,
                self.ecfg.max_seq_len - self.layout.seq_len)

    # ------------------------------------------------------------------
    def precompute_prefix(self, prefix_ids: Sequence[int]) -> PrefixCache:
        """Prefill a shared prompt prefix once into fresh KV buffers; see
        :class:`PrefixCache`. K/V depend on the tokens and positions alone,
        so no seed is involved."""
        self._reject_dynamic_prefix()
        prefix = np.asarray(prefix_ids, np.int64).reshape(-1)
        P0 = len(prefix)
        M = self.ecfg.max_seq_len
        if P0 < 1:
            raise ValueError("empty prefix")
        if P0 + 1 + self.layout.seq_len > M:
            raise ValueError(
                f"prefix ({P0}) leaves no room for a suffix + composite "
                f"step ({self.layout.seq_len}) within max_seq_len ({M})")
        if prefix.min() < 0 or prefix.max() >= self.mcfg.vocab_size:
            raise ValueError(
                f"prefix token ids must lie in [0, {self.mcfg.vocab_size})")
        out_buf = np.zeros((M + self.layout.guess_size,), np.int32)
        out_buf[:P0] = prefix
        with torch.inference_mode(), self._slot() as slot:
            # a prompt length of P0 + 1 makes the prefill cover [0, P0)
            state = self._prepare(out_buf, P0 + 1, 0, None, slot=slot)
            return PrefixCache(tokens=prefix.astype(np.int32),
                               k_cache=_clone(state.k_cache),
                               v_cache=_clone(state.v_cache), length=P0)

    # ------------------------------------------------------------------
    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int,
                 eos_token_id=None, seed: int = 0,
                 prefix: Optional[PrefixCache] = None,
                 return_prefix: bool = False) -> GenerationResult:
        """Greedy lookahead generation. ``seed`` seeds the window (the
        ``copy_from`` and ``random_set`` seedings); the tokens do not
        depend on it. ``prefix`` reuses a :class:`PrefixCache`: the prefill
        covers only the prompt past it. ``return_prefix`` attaches
        ``result.prefix``, a PrefixCache over this result's committed
        tokens, with which the next turn of a conversation prefills only
        its new message."""
        return self._run("greedy", prompt_ids, max_new_tokens, eos_token_id,
                         seed, prefix, return_prefix)

    def generate_sample(self, prompt_ids: Sequence[int], max_new_tokens: int,
                        sampling: Optional[SamplingConfig] = None,
                        eos_token_id=None, seed: int = 0,
                        prefix: Optional[PrefixCache] = None,
                        return_prefix: bool = False) -> GenerationResult:
        """Sampling lookahead generation with SpecInfer verification: the
        tokens follow the model's temperature / top-k / top-p distribution.
        ``seed`` is the key of the run's Philox stream (``ops/philox.py``:
        the window seeding and every draw), which gives the same numbers on
        the CPU and on the card; the tokens differ from the JAX package's
        (threefry) for the same seed. On one card, and on a mesh whose
        groups are all NCCL, the whole loop runs on the device, one launch
        and one read a call."""
        return self._run("sample", prompt_ids, max_new_tokens, eos_token_id,
                         seed, prefix, return_prefix,
                         sampling or SamplingConfig())

    def generate_baseline(self, prompt_ids: Sequence[int],
                          max_new_tokens: int, eos_token_id=None,
                          seed: int = 0, prefix: Optional[PrefixCache] = None,
                          return_prefix: bool = False) -> GenerationResult:
        """Plain autoregressive greedy decoding on the same weights and KV
        machinery: the comparison target for exactness and speedup."""
        return self._run("ar", prompt_ids, max_new_tokens, eos_token_id,
                         seed, prefix, return_prefix)

    # ------------------------------------------------------------------
    def generate_stream(self, prompt_ids: Sequence[int], max_new_tokens: int,
                        eos_token_id=None, seed: int = 0,
                        lookahead: bool = True,
                        sampling: Optional[SamplingConfig] = None,
                        prefix: Optional[PrefixCache] = None,
                        return_prefix: bool = False,
                        steps_per_yield: int = 1) -> Iterator[np.ndarray]:
        """Yields the newly confirmed token ids every ``steps_per_yield``
        decode steps (one host read each time); the concatenated output is
        the same for any ``steps_per_yield``. ``lookahead=False`` streams
        the AR baseline; ``sampling`` streams the sampling decode. With
        ``return_prefix=True`` the generator's ``StopIteration`` value is a
        :class:`PrefixCache` over the finished run (``pc = yield from
        eng.generate_stream(...)``)."""
        if return_prefix:
            self._reject_dynamic_prefix()
        if steps_per_yield < 1:
            raise ValueError("steps_per_yield must be >= 1")
        if sampling is not None and not lookahead:
            raise ValueError(
                "sampling streaming requires lookahead=True (the baseline "
                "streaming loop is greedy)")
        out_buf, P, fill = self._host_args(prompt_ids, max_new_tokens, prefix)
        mode = ("sample" if sampling is not None
                else "greedy" if lookahead else "ar")
        # inference mode only around device work: a generator that held it
        # across a yield would leak it into the caller's code; the slot is
        # held until the stream ends or is closed
        with self._slot() as slot:
            with torch.inference_mode():
                state = self._prepare(out_buf, P, seed, fill, prefix,
                                      slot=slot)
                steps = self._flat_runner(slot, mode, max_new_tokens,
                                          eos_token_id, sampling)
            served, end, kv_len = P, P + max_new_tokens, P - 1
            per_step, last_start = self._per_step(mode)
            while True:
                with torch.inference_mode():
                    # no step after a capacity stop (step.host_batch)
                    steps.run(host_batch(steps_per_yield * per_step,
                                         per_step, kv_len, last_start))
                    host = graphs.fetch(torch.cat([torch.stack([
                        state.finished.int(), state.n_confirmed,
                        state.kv_len]), state.out_buf]))
                n, kv_len = min(int(host[1]), end), int(host[2])
                if n > served:
                    yield host[3 + served:3 + n].copy()
                    served = n
                if host[0]:
                    break
            if return_prefix:
                with torch.inference_mode():
                    return self._prefix_of(state, host[3:], int(host[2]),
                                           served)

    # ------------------------------------------------------------------
    def _batch_fns(self):
        """The paged step functions over pages of one lane's capacity, M
        slots: ``generate_batch``'s lanes lie side by side in one pool,
        lane b on page b (built on first use)."""
        if self._paged_fns is None:
            self._paged_fns = build_paged_step_fns(
                self.mcfg, self.lcfg, self.ecfg, self.layout,
                self.ecfg.max_seq_len, self.device, mesh=self.mesh)
        return self._paged_fns

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int, eos_token_id=None, seed: int = 0,
                       seeds: Optional[Sequence[int]] = None,
                       prefix: Optional[PrefixCache] = None,
                       sampling: Optional[SamplingConfig] = None,
                       temperatures: Optional[Sequence[float]] = None,
                       top_ps: Optional[Sequence[float]] = None) -> list:
        """Decode several prompts together: each lane keeps its own window,
        pool, stream and KV cache, and every decode step is one batched
        forward over all lanes. Lane i gives the tokens of a lone call with
        ``seed=seeds[i]`` (default ``seed + i``): ``generate``, or
        ``generate_sample`` with ``sampling`` and the lane's
        ``temperatures[i]`` / ``top_ps[i]`` when given. ``prefix`` is one
        PrefixCache that every prompt starts with.

        The lanes' caches lie side by side in one pool ``[L, Hkv, B*M, D]``
        (lane b on page b of M slots, one trash page after them) and each
        step is the paged engine's batched step (``core/paged_step.py``,
        the paged attention kernel on the card). The prefill is each
        lane's own, as in the lone call."""
        return self._batch(prompts, max_new_tokens, eos_token_id, seed,
                           seeds, prefix, sampling, temperatures, top_ps)

    def _batch(self, prompts, max_new_tokens, eos_token_id, seed, seeds,
               prefix, sampling, temperatures, top_ps, host_loop=False):
        """:meth:`generate_batch`; ``host_loop`` as in :meth:`_run`."""
        t0 = time.perf_counter()
        if not prompts:
            raise ValueError("generate_batch needs at least one prompt")
        if seeds is not None and len(seeds) != len(prompts):
            raise ValueError("seeds must match prompts in length")
        if seeds is None:
            seeds = [seed + i for i in range(len(prompts))]
        if sampling is None and (temperatures is not None
                                 or top_ps is not None):
            raise ValueError(
                "temperatures/top_ps need sampling=SamplingConfig(...)")
        B = len(prompts)
        if sampling is not None:
            for vals in (temperatures, top_ps):
                if vals is not None and len(vals) != B:
                    raise ValueError(
                        "temperatures/top_ps must match prompts in length")
            for i in range(B):
                # SamplingConfig's own validation, lane by lane
                dataclasses.replace(
                    sampling,
                    temperature=(sampling.temperature if temperatures is None
                                 else temperatures[i]),
                    top_p=sampling.top_p if top_ps is None else top_ps[i])
        args = [self._host_args(p, max_new_tokens, prefix) for p in prompts]
        with torch.inference_mode():
            lanes = self._lane_slots.get(B)
            if lanes is None:
                lanes = self._lane_slots[B] = lane_slot(self, B)
            # each lane prepared as its lone call, then copied to its page
            with self._slot() as flat:
                for b, ((buf, n, fill), s) in enumerate(zip(args, seeds)):
                    write_lane(lanes, b, self._prepare(buf, n, s, fill,
                                                       prefix, slot=flat))
            lanes.max_new.fill_(min(max_new_tokens, _INT32_MAX))
            lanes.eos.copy_(graphs.upload(_eos_vec(eos_token_id),
                                          self.device).expand(B, -1))
            top_p, top_k = None, 0
            if sampling is not None:
                temps, top_p, top_k = self._warp(sampling, B, temperatures,
                                                 top_ps)
                lanes.temperature.copy_(temps)
                if top_p is not None:
                    lanes.top_p.copy_(top_p)
            states = lanes.states
            columns = [states.n_confirmed, states.init_len, states.step_idx]
            loop = None
            if (self._loops("greedy" if sampling is None else "sample")
                    and not host_loop):
                loop = self._lane_loop(lanes, sampling is not None,
                                       top_p is not None, top_k)
                loop.run()
                columns += [states.finished.int(), loop.iters.expand(B)]
            else:
                steps = self._lane_runner(lanes, sampling is not None,
                                          top_p is not None, top_k)
                # as run_loop, over the slowest unfinished lane
                generated = 0
                while True:
                    steps.run(max(1, -(-(max_new_tokens - generated)
                                       // self.layout.guess_size)))
                    host = graphs.fetch(torch.stack([
                        states.finished.int(),
                        states.n_confirmed - states.init_len]))
                    if host[0].all():
                        break
                    generated = int(host[1][host[0] == 0].min())
            host = graphs.fetch(torch.cat([torch.stack(columns, dim=1),
                                           states.out_buf], dim=1))
            if loop is not None:
                _loop_done(loop, bool(host[:, 3].all()), int(host[0, 4]),
                           max_new_tokens)
                host = np.concatenate([host[:, :3], host[:, 5:]], axis=1)
        wall = time.perf_counter() - t0
        out = []
        for row in host:
            total = min(int(row[0]), int(row[1]) + max_new_tokens)
            out.append(GenerationResult(tokens=row[3:3 + total].copy(),
                                        prompt_len=int(row[1]),
                                        steps=int(row[2]), wall_time_s=wall))
            if self.log is not None:
                self.log.append(out[-1])
        return out
