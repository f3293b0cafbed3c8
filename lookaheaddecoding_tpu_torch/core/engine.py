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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..config import EngineConfig, LookaheadConfig, SamplingConfig
from ..models import llama
from ..ops.lookahead_attention import KERNEL_HEAD_DIMS
from .layout import Layout, build_layout
from .paged_step import PagedLaneState, build_paged_step_fns
from .pool import (PoolState, apply_host_fill, host_prompt_fill, pool_init,
                   pool_table_rows)
from .state import DecodeState
from .step import build_step_fns

MAX_EOS_IDS = 4


def _eos_vec(eos_token_id, device) -> torch.Tensor:
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


def _cat_slots(caches, trash):
    """Lane caches [L, Hkv, M, D] laid side by side as one paged pool of
    pages of M slots, with ``trash`` (a zeroed cache) as the last page."""
    if isinstance(trash, dict):
        return {name: torch.cat([c[name] for c in caches] + [trash[name]],
                                dim=2) for name in trash}
    return torch.cat(list(caches) + [trash], dim=2)


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

    def _prepare(self, out_buf: np.ndarray, prompt_len: int, seed: int,
                 fill, prefix: Optional[PrefixCache] = None) -> DecodeState:
        """Caches, pool, window seeding, prompt fill and prefill. A prefix's
        caches and pool are copied (the prefill's last chunk may rewrite
        some of its rows), and the fill merges into its pool's rows."""
        dev = self.device
        if prefix is None:
            k_cache, v_cache = llama.make_kv_cache(
                self.mcfg, self.ecfg.max_seq_len, dev,
                quant=self.ecfg.kv_quant, params=self.params)
        else:
            k_cache, v_cache = _clone(prefix.k_cache), _clone(prefix.v_cache)
        if prefix is not None and prefix.pool is not None:
            pool = PoolState(prefix.pool.values.clone(),
                             prefix.pool.age.clone(), prefix.pool.clock.clone())
        else:
            pool = pool_init(self._pool_rows(), self.layout.guess_set_size,
                             self.layout.guess_size, dev)
        rng = torch.Generator(device=dev)
        rng.manual_seed(seed)
        state = self._fns.init_state(
            k_cache, v_cache, pool, torch.from_numpy(out_buf).to(dev),
            prompt_len, rng)
        if fill is not None:
            apply_host_fill(state.pool, *fill, merge=prefix is not None)
        return self._fns.prefill_from(self.params, state, prompt_len,
                                      0 if prefix is None else prefix.length)

    def _finalize(self, state: DecodeState, max_new: int, t0: float,
                  return_prefix: bool = False) -> GenerationResult:
        # one device-to-host transfer for the scalars and the tokens
        host = torch.cat([torch.stack([state.n_confirmed, state.init_len,
                                       state.step_idx, state.kv_len]),
                          state.out_buf]).cpu().numpy()
        n_confirmed, init_len, steps, kv_len = (int(x) for x in host[:4])
        total = min(n_confirmed, init_len + max_new)   # trim overshoot
        res = GenerationResult(tokens=host[4:4 + total].copy(),
                               prompt_len=init_len, steps=steps,
                               wall_time_s=time.perf_counter() - t0)
        if return_prefix:
            res.prefix = self._prefix_of(state, host[4:], kv_len, total)
        if self.log is not None:
            self.log.append(res)
        return res

    @staticmethod
    def _prefix_of(state: DecodeState, out_buf, kv_len: int,
                   total: int) -> PrefixCache:
        """The run's own caches and pool as a PrefixCache over its
        committed KV rows [0, kv_len), clamped to the trimmed result so
        that the prefix tokens are a prefix of the result's."""
        length = min(kv_len, total)
        return PrefixCache(tokens=out_buf[:length].astype(np.int32),
                           k_cache=state.k_cache, v_cache=state.v_cache,
                           length=length, pool=state.pool)

    def _warp(self, sampling: SamplingConfig, lanes: int = 1,
              temperatures=None, top_ps=None):
        """(temperature [B], top_p [B] or None, top_k) on the device for a
        sampling step: the config's values, or one a lane. ``top_p`` is
        None when no lane asks for it (host data), which skips the sort;
        any lane below 1 applies to that lane."""
        temps = ([sampling.temperature] * lanes if temperatures is None
                 else list(temperatures))
        tops = [sampling.top_p] * lanes if top_ps is None else list(top_ps)
        temps, top_p = (torch.tensor(v, dtype=torch.float32,
                                     device=self.device)
                        for v in (temps, tops))
        return temps, top_p if min(tops) < 1.0 else None, sampling.top_k

    def _run(self, loop, prompt_ids, max_new_tokens, eos_token_id, seed,
             prefix=None, return_prefix=False):
        t0 = time.perf_counter()
        if return_prefix:
            self._reject_dynamic_prefix()
        out_buf, P, fill = self._host_args(prompt_ids, max_new_tokens, prefix)
        with torch.inference_mode():
            state = self._prepare(out_buf, P, seed, fill, prefix)
            state = loop(self.params, state, max_new_tokens,
                         _eos_vec(eos_token_id, self.device))
            return self._finalize(state, max_new_tokens, t0, return_prefix)

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
        with torch.inference_mode():
            # a prompt length of P0 + 1 makes the prefill cover [0, P0)
            state = self._prepare(out_buf, P0 + 1, 0, None)
        return PrefixCache(tokens=prefix.astype(np.int32),
                           k_cache=state.k_cache, v_cache=state.v_cache,
                           length=P0)

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
        return self._run(self._fns.decode_loop, prompt_ids, max_new_tokens,
                         eos_token_id, seed, prefix, return_prefix)

    def generate_sample(self, prompt_ids: Sequence[int], max_new_tokens: int,
                        sampling: Optional[SamplingConfig] = None,
                        eos_token_id=None, seed: int = 0,
                        prefix: Optional[PrefixCache] = None,
                        return_prefix: bool = False) -> GenerationResult:
        """Sampling lookahead generation with SpecInfer verification: the
        tokens follow the model's temperature / top-k / top-p distribution.
        ``seed`` seeds the run's generator (window seeding and every draw);
        on a CUDA device the stream is the card's, so the tokens differ
        from the CPU's (and from the JAX package's) for the same seed."""
        warp = self._warp(sampling or SamplingConfig())

        def loop(params, state, max_new, eos):
            return self._fns.sample_loop(params, state, max_new, eos, *warp)

        return self._run(loop, prompt_ids, max_new_tokens, eos_token_id,
                         seed, prefix, return_prefix)

    def generate_baseline(self, prompt_ids: Sequence[int],
                          max_new_tokens: int, eos_token_id=None,
                          seed: int = 0, prefix: Optional[PrefixCache] = None,
                          return_prefix: bool = False) -> GenerationResult:
        """Plain autoregressive greedy decoding on the same weights and KV
        machinery: the comparison target for exactness and speedup."""
        return self._run(self._fns.baseline_loop, prompt_ids, max_new_tokens,
                         eos_token_id, seed, prefix, return_prefix)

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
        eos = _eos_vec(eos_token_id, self.device)
        fns, params = self._fns, self.params
        if sampling is not None:
            warp = self._warp(sampling)

            def step(s):
                return fns.sample_step(params, s, max_new_tokens, eos, *warp)
        else:
            one = fns.decode_step if lookahead else fns.baseline_step

            def step(s):
                return one(params, s, max_new_tokens, eos)
        # inference mode only around device work: a generator that held it
        # across a yield would leak it into the caller's code
        with torch.inference_mode():
            state = self._prepare(out_buf, P, seed, fill, prefix)
        served, end = P, P + max_new_tokens
        while True:
            with torch.inference_mode():
                for _ in range(steps_per_yield):
                    state = step(state)
                host = torch.cat([torch.stack([
                    state.finished.int(), state.n_confirmed, state.kv_len]),
                    state.out_buf]).cpu().numpy()
            n = min(int(host[1]), end)
            if n > served:
                yield host[3 + served:3 + n].copy()
                served = n
            if host[0]:
                break
        if return_prefix:
            return self._prefix_of(state, host[3:], int(host[2]), served)

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
        pool, generator and KV cache, and every decode step is one batched
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
        fns, dev = self._batch_fns(), self.device
        with torch.inference_mode():
            lanes = [self._prepare(buf, n, s, fill, prefix)
                     for (buf, n, fill), s in zip(args, seeds)]
            trash = llama.make_kv_cache(self.mcfg, self.ecfg.max_seq_len, dev,
                                        quant=self.ecfg.kv_quant,
                                        params=self.params)
            k_pool = _cat_slots([st.k_cache for st in lanes], trash[0])
            v_pool = _cat_slots([st.v_cache for st in lanes], trash[1])
            M = self.ecfg.max_seq_len

            def stack(name):
                return torch.stack([getattr(st, name) for st in lanes])
            states = PagedLaneState(
                table=torch.arange(B, dtype=torch.int32, device=dev)[:, None],
                cap=torch.full((B,), M, dtype=torch.int32, device=dev),
                trash=torch.full((B,), B * M, dtype=torch.int32, device=dev),
                kv_len=stack("kv_len"), window=stack("window"),
                pool=PoolState(*(torch.stack([getattr(st.pool, f)
                                              for st in lanes])
                                 for f in ("values", "age", "clock"))),
                out_buf=stack("out_buf"), n_confirmed=stack("n_confirmed"),
                init_len=stack("init_len"), step_idx=stack("step_idx"),
                finished=stack("finished"), rng=[st.rng for st in lanes])
            del lanes       # their caches are copied into the pool
            max_new = torch.full((B,), max_new_tokens, dtype=torch.int32,
                                 device=dev)
            eos = _eos_vec(eos_token_id, dev).expand(B, -1).contiguous()
            if sampling is None:
                def step():
                    fns.decode_batch(self.params, k_pool, v_pool, states,
                                     max_new, eos)
            else:
                warp = self._warp(sampling, B, temperatures, top_ps)

                def step():
                    fns.sample_batch(self.params, k_pool, v_pool, states,
                                     max_new, eos, *warp)
            # as _run_loop, over the slowest unfinished lane
            generated = 0
            while True:
                for _ in range(max(1, -(-(max_new_tokens - generated)
                                        // self.layout.guess_size))):
                    step()
                host = torch.stack([states.finished.int(),
                                    states.n_confirmed - states.init_len]
                                   ).cpu().numpy()
                if host[0].all():
                    break
                generated = int(host[1][host[0] == 0].min())
            host = torch.cat([torch.stack([states.n_confirmed,
                                           states.init_len,
                                           states.step_idx], dim=1),
                              states.out_buf], dim=1).cpu().numpy()
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
