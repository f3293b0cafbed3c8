"""Continuous batching over the paged (shared-pool) KV cache.

    eng = PagedServingEngine(mcfg, params, lookahead, engine, num_lanes=4,
                             page_size=128, n_pages=24)
    results = eng.run([Request(prompt=ids, max_new_tokens=128), ...])

Every lane, cached prefix and conversation turn shares one physical page
pool (core/paged.py): admission allocates exactly the pages a request can
touch, sharing a prefix is a reference count plus one copied page, and when
the pool is exhausted requests wait in the queue (admission backpressure)
instead of the device running out of memory.

Scheduling is the fairness lane policy: every active lane advances each
step through one batched decode step (core/paged_step.py),
``steps_per_sync`` steps between host reads, with per-request streaming.
Verification is greedy, or SpecInfer sampling when the engine is built
with a ``SamplingConfig``; a request may then set its own ``temperature``
and ``top_p``. On the card the batched step is a replayed CUDA graph
(``core/graphs.py``) over the lanes, pools and buffers made here, which
admission and harvest write in place.

Admission is JAX's one-dispatch prepare (``_get_prepare``: lane init, pool
fill, the prefill ``fori_loop`` and the insertion into the batched lanes),
and nothing on its way to the first batched step reads the device from the
host: the request's arrays go into the engine's admission record
(``core/paged_step.py:PagedAdmission``) from pinned memory
(``graphs.upload``); the lane's pool reset or warm copy, its fill and its
row are launched eagerly; then the prefill replays one captured chunk a
chunk, its start read from the record's counters. ``precompute_prefix``
takes the same record and chunk.

The engine runs on ``cuda`` unless it is given ``device="cpu"``; without a
CUDA device it raises rather than carry on on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import EngineConfig, LookaheadConfig, SamplingConfig
from ..models import llama
from ..ops.lookahead_attention import KERNEL_HEAD_DIMS
from . import graphs
from .engine import _INT32_MAX, MAX_EOS_IDS, GenerationResult, _eos_vec
from .layout import build_layout
from .paged import (BlockAllocator, OutOfPages, copy_page, make_paged_pool,
                    pages_needed)
from .paged_step import PagedLaneState, build_paged_step_fns, new_admission
from .pool import (PoolState, apply_host_fill, host_prompt_fill, pool_init,
                   pool_table_rows, upload_fill)
from .serving import Request


@dataclasses.dataclass(frozen=True)
class PagedPrefix:
    """A precomputed KV prefix that lives in the shared page pool.

    It holds ``ceil(length / page_size)`` reference-counted pages: admitting
    a request that reuses it adds a reference to the full pages and copies
    at most one page. Call :meth:`PagedServingEngine.release_prefix` when
    done with it: page lifetime is explicit, not garbage-collected."""

    tokens: np.ndarray
    pages: tuple            # physical page ids covering [0, length)
    length: int
    pool: Optional[PoolState] = None   # the carried warm n-gram pool


class PagedServingEngine:
    def __init__(
        self,
        model_cfg: llama.LlamaConfig,
        params,
        lookahead: Optional[LookaheadConfig] = None,
        engine: Optional[EngineConfig] = None,
        num_lanes: int = 4,
        page_size: int = 256,
        n_pages: Optional[int] = None,
        steps_per_sync: int = 4,
        sampling: Optional[SamplingConfig] = None,
        log=None,
        device=None,
    ):
        """``n_pages`` is the data-page budget (the memory knob; the
        per-lane trash pages come on top). Default: the flat engine's
        capacity, ``num_lanes * ceil(max_seq_len / page_size)``; the saving
        comes from setting it to the workload's real token volume.
        ``sampling`` switches every lane to sampling verification with its
        warpers; a request's ``temperature`` / ``top_p`` override them for
        that request (its ``top_p`` applies whatever the engine's is)."""
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PagedServingEngine runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        self.mcfg = model_cfg
        self.params = params
        self.lcfg = lookahead or LookaheadConfig()
        self.ecfg = engine or EngineConfig()
        self.log = log
        self.num_lanes = num_lanes
        self.page_size = page_size
        self.steps_per_sync = steps_per_sync
        self.sampling = sampling

        if llama.is_dynamic_rope(self.mcfg):
            raise ValueError(
                "paged serving does not support dynamic-NTK rope scaling "
                "(prefix sharing would key the rope base on the wrong "
                "length); use the flat LookaheadEngine")
        e = self.ecfg
        if e.pp > 1 or e.tp > 1 or e.la > 1:
            raise ValueError(
                "paged serving is single-chip in this version; use the "
                "flat LookaheadEngine for pp/tp/la meshes")
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
        self.layout = build_layout(self.lcfg)
        S, M = self.layout.seq_len, e.max_seq_len
        if M < S + 8:
            raise ValueError("max_seq_len too small for the composite step")
        if (self.mcfg.sliding_window is not None
                and S > self.mcfg.sliding_window):
            raise ValueError(
                "composite step size exceeds the model's sliding window")
        if e.fuse_projections:
            self.params = llama.fuse_params(self.params)

        self._NB = -(-M // page_size)
        if n_pages is None:
            n_pages = num_lanes * self._NB
        self._total_pages = n_pages + num_lanes
        self.alloc = BlockAllocator(self._total_pages, reserved=num_lanes)
        self._fns = build_paged_step_fns(self.mcfg, self.lcfg, e, self.layout,
                                         page_size, self.device)
        self._k_pool, self._v_pool = make_paged_pool(
            self.mcfg, self._total_pages, page_size, self.device,
            quant=e.kv_quant)

        # idle lanes: finished, every logical page on the lane's trash page
        B, NB, dev = num_lanes, self._NB, self.device
        self._pool_rows = pool_table_rows(
            self.mcfg.vocab_size, self.lcfg.pool_key_len,
            self.lcfg.pool_hash_size)
        G, GS = self.layout.guess_set_size, self.layout.guess_size
        one = pool_init(self._pool_rows, G, GS, dev)
        lanes = torch.arange(B, dtype=torch.int32, device=dev)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)
        self._states = PagedLaneState(
            table=lanes[:, None].repeat(1, NB),
            cap=torch.full((B,), S + 1, dtype=torch.int32, device=dev),
            trash=lanes * page_size,
            kv_len=zeros(B), window=zeros(B, self.layout.n_window),
            pool=PoolState(
                values=one.values[None].repeat(B, 1, 1, 1),
                age=one.age[None].repeat(B, 1, 1),
                clock=one.clock[None].repeat(B)),
            out_buf=zeros(B, M + GS),
            n_confirmed=zeros(B) + 1, init_len=zeros(B) + 1,
            step_idx=zeros(B),
            finished=torch.ones(B, dtype=torch.bool, device=dev),
            rng=[torch.Generator(device=dev) for _ in range(B)])
        self._max_new = zeros(B)
        self._eos = zeros(B, MAX_EOS_IDS) - 1
        # each lane's temperature and top_p (sampling engines), on the
        # device for the step and top_p on the host for the sort's skip
        self._temp = torch.ones(B, dtype=torch.float32, device=dev)
        self._topp = torch.ones(B, dtype=torch.float32, device=dev)
        self._topp_host = np.ones(B, np.float32)
        # each lane's finished flag on the host, as the last host read saw
        # it and as admission changed it since
        self._finished = np.ones(B, bool)
        # the admission record the prefill chunk reads (core/paged_step.py)
        self._rec = new_admission(NB, M + GS, dev)
        # on the card the batched step is a replayed CUDA graph over the
        # fields above (core/graphs.py), by mode, top-p and top-k, and so is
        # the prefill chunk (key "prefill")
        self._graphed = graphs.capturable(self.device)
        self._graphs: dict = {}
        self._graph_pool = None

        self._queue: Deque = deque()
        self._iqueue: Deque = deque()      # interactive requests go first
        self._results: List[GenerationResult] = []
        self._meta: Dict[int, dict] = {}       # lane -> admission record
        self._first_tok: Dict[int, float] = {}
        # times an admission found too few free pages and left the request
        # queued (backpressure), and batched decode steps taken
        self.admission_waits = 0
        self.steps_run = 0

    # ------------------------------------------------------------------
    @property
    def pages_free(self) -> int:
        return self.alloc.free_pages

    def memory_stats(self) -> dict:
        """Pool occupancy, and the flat engine's equivalent beside it."""
        leaf_bytes = 0
        for pool in (self._k_pool, self._v_pool):
            for x in (pool.values() if isinstance(pool, dict) else [pool]):
                leaf_bytes += x.numel() * x.element_size()
        per_page = leaf_bytes // self._total_pages
        return {
            "page_size": self.page_size,
            "pages_total": self._total_pages - self.num_lanes,
            "pages_used": self.alloc.used_pages,
            "pages_free": self.alloc.free_pages,
            "pool_bytes": leaf_bytes,
            "bytes_per_page": per_page,
            "flat_equiv_bytes": per_page * self._NB * self.num_lanes,
        }

    # ------------------------------------------------------------------
    def _host_fill(self, prompt: np.ndarray, prefix) -> Optional[tuple]:
        if not self.lcfg.pool_from_prompt:
            return None
        start = 0
        if prefix is not None and prefix.pool is not None:
            # a warm pool is carried: the fill covers the new suffix only
            # (plus ``level`` tokens of context across the boundary); the
            # merging fill keeps the warm entries it does not displace
            start = max(0, prefix.length - self.lcfg.level)
        return host_prompt_fill(
            prompt[start:], self.lcfg.level, self.layout.guess_set_size,
            pad_to=self.ecfg.max_seq_len, key_len=self.lcfg.pool_key_len,
            table_rows=self._pool_rows)

    def _validate(self, req: Request):
        prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        P = len(prompt)
        S, M = self.layout.seq_len, self.ecfg.max_seq_len
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if P < 1:
            raise ValueError("empty prompt")
        if P - 1 + S > M:
            raise ValueError(
                f"prompt ({P}) + composite step ({S}) exceeds "
                f"max_seq_len ({M})")
        if prompt.min() < 0 or prompt.max() >= self.mcfg.vocab_size:
            # an out-of-range id would be a device-side assert on CUDA
            raise ValueError(
                f"prompt token ids must lie in [0, {self.mcfg.vocab_size})")
        eos = _eos_vec(req.eos_token_id)
        if self.sampling is None and (req.temperature is not None
                                      or req.top_p is not None):
            raise ValueError(
                "request sets temperature/top_p but the engine was built "
                "without a SamplingConfig (greedy mode)")
        temp = topp = 1.0
        if self.sampling is not None:
            temp = (self.sampling.temperature if req.temperature is None
                    else req.temperature)
            topp = self.sampling.top_p if req.top_p is None else req.top_p
            # SamplingConfig's own validation of the request's values
            dataclasses.replace(self.sampling, temperature=temp, top_p=topp)
        prefix = req.prefix
        if prefix is not None:
            if not isinstance(prefix, PagedPrefix):
                raise ValueError(
                    "paged serving needs a PagedPrefix (from "
                    "PagedServingEngine.precompute_prefix or a "
                    "return_prefix result)")
            if (P < prefix.length
                    or not np.array_equal(prompt[:prefix.length],
                                          np.asarray(prefix.tokens))):
                raise ValueError(
                    "prompt does not start with the paged prefix")
        return prompt, eos, temp, topp

    def _fail(self, req: Request, err: Exception) -> None:
        res = GenerationResult(
            tokens=np.asarray(req.prompt, np.int32),
            prompt_len=len(req.prompt), steps=0)
        res.request_id = req.request_id
        res.error = str(err)
        self._results.append(res)

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        """``request.interactive`` jumps the admission queue (latency
        class); page-allocation backpressure still applies."""
        q = self._iqueue if request.interactive else self._queue
        q.append((request, time.perf_counter()))

    def _lane_pool(self, lane: int) -> PoolState:
        """Lane ``lane``'s n-gram pool as views into the stacked pool."""
        pool = self._states.pool
        return PoolState(pool.values[lane], pool.age[lane], pool.clock[lane])

    def _admit(self) -> None:
        """Requests onto free lanes while pages last: JAX's one-dispatch
        prepare, with no host read on the way (see the module's
        docstring)."""
        if not (self._queue or self._iqueue):
            return
        st, rec = self._states, self._rec
        BS, dev = self.page_size, self.device
        S, M = self.layout.seq_len, self.ecfg.max_seq_len
        for lane in range(self.num_lanes):
            src = self._iqueue if self._iqueue else self._queue
            if not src:
                break
            if lane in self._meta or not self._finished[lane]:
                continue
            req, t_submit = src[0]
            try:
                prompt, eos, temp, topp = self._validate(req)
            except ValueError as e:
                src.popleft()
                self._fail(req, e)
                continue
            prefix = req.prefix
            plen = prefix.length if prefix is not None else 0
            # the first logical slot the lane writes: its prefill starts at
            # the prefix's end, and when the prompt is the prefix itself the
            # first decode step rewrites the last prompt token's slot
            write_from = min(plen, len(prompt) - 1)
            npages, first_page = pages_needed(
                len(prompt), req.max_new_tokens, S, BS, M, write_from)
            if npages > self._total_pages - self.num_lanes:
                src.popleft()
                self._fail(req, OutOfPages(
                    f"request needs {npages} pages but the pool only has "
                    f"{self._total_pages - self.num_lanes}"))
                continue
            try:
                priv = self.alloc.alloc(npages)
            except OutOfPages:
                # admission backpressure: requests wait (first in, first
                # out within their class) until pages come free
                self.admission_waits += 1
                break
            src.popleft()

            table = np.full((self._NB,), lane, np.int32)   # trash default
            shared: List[int] = []
            if prefix is not None:
                shared = list(prefix.pages[:first_page])
                if shared:
                    self.alloc.share(shared)
                    table[:first_page] = shared
                if first_page < len(prefix.pages):
                    # copy-on-write: the page that holds ``write_from`` also
                    # holds prefix rows (a partial tail page, or the last
                    # full page when the prompt is the prefix itself), and
                    # the lane will write into it
                    copy_page((self._k_pool, self._v_pool),
                              prefix.pages[first_page], priv[0], BS)
            table[first_page:first_page + npages] = priv
            cap = min((first_page + npages) * BS, M)

            out_buf = np.zeros((M + self.layout.guess_size,), np.int32)
            out_buf[:len(prompt)] = prompt
            self._record(table, lane * BS, out_buf, len(prompt))

            lane_pool = self._lane_pool(lane)
            if prefix is not None and prefix.pool is not None:
                lane_pool.values.copy_(prefix.pool.values)
                lane_pool.age.copy_(prefix.pool.age)
                lane_pool.clock.copy_(prefix.pool.clock)
            else:
                lane_pool.values.zero_()
                lane_pool.age.zero_()
                lane_pool.clock.fill_(1)
            fill = self._host_fill(prompt, prefix)
            if fill is not None:
                apply_host_fill(lane_pool, *upload_fill(*fill, dev),
                                merge=True)
            self._fns.init_lane(st, lane, rec, cap, len(prompt), req.seed)
            self._prefill(len(prompt), plen)
            st.kv_len[lane].copy_(rec.kv_len)
            self._finished[lane] = False
            self._max_new[lane].fill_(min(req.max_new_tokens, _INT32_MAX))
            self._eos[lane] = graphs.upload(eos, dev)
            self._temp[lane].fill_(temp)
            self._topp[lane].fill_(topp)
            self._topp_host[lane] = topp
            self._first_tok.pop(lane, None)
            self._meta[lane] = dict(
                req=req, priv=priv, shared=shared,
                t0=time.perf_counter(), t_submit=t_submit,
                served=len(prompt) if req.on_tokens is not None else None)

    def _record(self, table: np.ndarray, trash: int, out_buf: np.ndarray,
                prompt_len: int) -> None:
        """An admission's host arrays and numbers into the admission record,
        without a wait."""
        rec, dev = self._rec, self.device
        rec.table[0].copy_(graphs.upload(table, dev))
        rec.out_buf.copy_(graphs.upload(out_buf, dev))
        rec.trash.fill_(trash)
        rec.init_len.fill_(prompt_len)

    def _prefill(self, prompt_len: int, start0: int) -> None:
        """prompt[start0:-1] of the admission record's lane into the pool:
        on the card the engine's captured prefill chunk (captured by the
        first chunk that needs it, which is its warm step) replayed once a
        chunk, over the record's ``start0`` and ``chunk`` counters; a
        prompt with no row past ``start0`` has no chunk."""
        fns, params, rec = self._fns, self.params, self._rec
        pools = (self._k_pool, self._v_pool)

        def chunk():
            fns.prefill_chunk(params, pools, rec, rec.start0, rec.chunk)
        steps = self._graph_runner("prefill", chunk, (pools, rec), "prefills")
        fns.prefill_from(params, pools, rec, prompt_len, start0,
                         (rec.start0, rec.chunk), steps.run)

    def _graph_runner(self, key, step, state, counter="replays"):
        if self._graphed and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return graphs.runner(self._graphs, key, step, state, self._graphed,
                             self._graph_pool, counter)

    # ------------------------------------------------------------------
    def _observe(self):
        """finished, n_confirmed, init_len, kv_len and step_idx of every
        lane, in one device-to-host transfer; the host's copy of
        ``finished`` follows it."""
        st = self._states
        host = torch.stack([st.finished.int(), st.n_confirmed, st.init_len,
                            st.kv_len, st.step_idx]).cpu().numpy()
        self._finished[:] = host[0] != 0
        now = time.perf_counter()
        for lane in self._meta:
            if lane not in self._first_tok and host[1, lane] > host[2, lane]:
                self._first_tok[lane] = now
        return host

    def _emit_stream(self, n_confirmed, init_len):
        pending = []
        for lane, meta in self._meta.items():
            if meta["served"] is None:
                continue
            total = min(int(n_confirmed[lane]),
                        int(init_len[lane]) + meta["req"].max_new_tokens)
            if total > meta["served"]:
                pending.append((lane, meta, total))
        if not pending:
            return None
        out_buf = self._states.out_buf.cpu().numpy()
        for lane, meta, total in pending:
            chunk = out_buf[lane, meta["served"]:total].copy()
            meta["req"].on_tokens(chunk)
            meta["served"] = total
        return out_buf

    def _harvest(self, host, out_buf=None) -> None:
        finished, n_confirmed, init_len, kv_len, steps = host
        done = [lane for lane in list(self._meta) if finished[lane]]
        if not done:
            return
        st = self._states
        if out_buf is None:
            out_buf = st.out_buf.cpu().numpy()
        tables = None
        now = time.perf_counter()
        BS = self.page_size
        for lane in done:
            meta = self._meta.pop(lane)
            req = meta["req"]
            total = min(int(n_confirmed[lane]),
                        int(init_len[lane]) + req.max_new_tokens)
            res = GenerationResult(
                tokens=out_buf[lane, :total].copy(),
                prompt_len=int(init_len[lane]),
                steps=int(steps[lane]),
                wall_time_s=now - meta["t0"],
                ttft_s=self._first_tok.pop(lane, now) - meta["t_submit"],
                latency_s=now - meta["t_submit"],
            )
            res.request_id = req.request_id
            if req.return_prefix:
                # conversation carry: the pages that cover the confirmed KV
                # become the prefix (one more reference each, no copy); the
                # rest is freed with the lane
                kv = min(int(kv_len[lane]), total)
                n_px = -(-kv // BS)
                if tables is None:
                    tables = st.table.cpu().numpy()
                px_pages = [int(p) for p in tables[lane, :n_px]]
                self.alloc.share(px_pages)
                warm = self._lane_pool(lane)
                res.prefix = PagedPrefix(
                    tokens=out_buf[lane, :kv].copy(),
                    pages=tuple(px_pages), length=kv,
                    pool=PoolState(warm.values.clone(), warm.age.clone(),
                                   warm.clock.clone()))
            self.alloc.release(meta["shared"] + meta["priv"])
            self._idle(lane)
            self._results.append(res)
            if self.log is not None:
                self.log.append(res)

    def _idle(self, lane: int) -> None:
        """Lane ``lane`` back to idle, in place, before the next step:
        finished, every logical page on its trash page (a finished lane's
        step still writes its composite rows, which must never touch pages
        that are handed out again)."""
        st = self._states
        st.table[lane].fill_(lane)
        st.cap[lane].fill_(self.layout.seq_len + 1)
        st.kv_len[lane].fill_(0)
        st.n_confirmed[lane].fill_(1)
        st.init_len[lane].fill_(1)
        st.step_idx[lane].fill_(0)
        st.finished[lane].fill_(True)
        self._finished[lane] = True

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Admit, ``steps_per_sync`` batched decode steps, one host read,
        stream and harvest. Returns True while anything is active or
        queued."""
        with torch.inference_mode():
            self._admit()
            if not self._meta:
                return bool(self._queue or self._iqueue)
            self._runner().run(self.steps_per_sync)
            self.steps_run += self.steps_per_sync
            host = self._observe()
            out_buf = self._emit_stream(host[1], host[2])
            self._harvest(host, out_buf)
        return bool(self._meta or self._queue or self._iqueue)

    def _runner(self):
        """The batched step's runner: greedy, or sampling with the sort
        when a live request asks for top-p."""
        fns, params = self._fns, self.params
        bufs = (self._k_pool, self._v_pool, self._states, self._max_new,
                self._eos)
        top_p_on, top_k = False, 0
        if self.sampling is None:
            def step():
                fns.decode_batch(params, *bufs)
        else:
            top_p_on = bool(self._topp_host[list(self._meta)].min() < 1.0)
            top_p, top_k = (self._topp if top_p_on else None,
                            self.sampling.top_k)

            def step():
                fns.sample_batch(params, *bufs, self._temp, top_p, top_k)
        return self._graph_runner((top_p_on, top_k), step,
                                  bufs + (self._temp, self._topp))

    def run(self, requests: Sequence[Request]) -> List[GenerationResult]:
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        out, self._results = self._results, []
        return out

    # ------------------------------------------------------------------
    def generate(self, prompt_ids, max_new_tokens, eos_token_id=None,
                 seed: int = 0, prefix: Optional[PagedPrefix] = None,
                 return_prefix: bool = False) -> GenerationResult:
        """One request through the lane scheduler (greedy, or sampling
        when the engine was built with a SamplingConfig)."""
        req = Request(prompt=prompt_ids, max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id, seed=seed, prefix=prefix,
                      return_prefix=return_prefix)
        res = self.run([req])[0]
        if res.error is not None:
            raise ValueError(res.error)
        return res

    # ------------------------------------------------------------------
    def precompute_prefix(self, prefix_ids: Sequence[int]) -> PagedPrefix:
        """Prefill a shared prefix once into freshly allocated pool pages.
        The result holds ``ceil(len / page_size)`` reference-counted pages;
        release it with :meth:`release_prefix` when it is no longer
        needed."""
        prefix = np.asarray(prefix_ids, np.int64).reshape(-1)
        P0 = len(prefix)
        M, BS = self.ecfg.max_seq_len, self.page_size
        if P0 < 1:
            raise ValueError("empty prefix")
        if P0 + 1 + self.layout.seq_len > M:
            raise ValueError(
                f"prefix ({P0}) leaves no room for a suffix + composite "
                f"step within max_seq_len ({M})")
        if prefix.min() < 0 or prefix.max() >= self.mcfg.vocab_size:
            raise ValueError(
                f"prefix token ids must lie in [0, {self.mcfg.vocab_size})")
        n_px = -(-P0 // BS)
        pages = self.alloc.alloc(n_px)
        table = np.zeros((self._NB,), np.int32)
        table[:n_px] = pages
        out_buf = np.zeros((M + self.layout.guess_size,), np.int32)
        out_buf[:P0] = prefix
        # JAX's "precompute" prepare: a prompt length of P0 + 1 makes the
        # prefill cover [0, P0), every prefix row in its page; the padded
        # rows go to lane 0's trash page
        with torch.inference_mode():
            self._record(table, 0, out_buf, P0 + 1)
            self._prefill(P0 + 1, 0)
        return PagedPrefix(tokens=prefix.astype(np.int32),
                           pages=tuple(int(p) for p in pages), length=P0)

    def release_prefix(self, prefix: PagedPrefix) -> None:
        """Return the prefix's page references to the pool."""
        self.alloc.release(list(prefix.pages))
