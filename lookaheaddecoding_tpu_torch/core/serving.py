"""Continuous batching on top of the flat lookahead engine.

    srv = ContinuousBatchingEngine(eng, num_lanes=4, steps_per_sync=4)
    results = srv.run([Request(prompt=ids, max_new_tokens=128), ...])

A slot scheduler keeps a fixed number of decode lanes busy: each lane runs
the whole per-sequence lookahead machinery (window, n-gram pool, KV cache),
all lanes advance together through one batched step, and finished lanes
take queued requests between host reads. The ``Request`` dataclass here is
the one every serving engine of the package takes.

The lanes are laid out as ``LookaheadEngine.generate_batch`` lays them:
their flat caches side by side as one pool ``[L, Hkv, (B+1)*M, D]``, lane b
on page b of M slots and one trash page after them, stepped by the paged
step's ``decode_batch`` / ``sample_batch`` (core/paged_step.py; the paged
attention kernel on the card). A request is admitted by the lone call's
own ``_prepare`` (window seeding, pool fill and prefill), whose cache is
then copied into the lane's page; an idle lane is a finished lane, which
the step leaves unchanged. So every lane gives the tokens of the lone
``generate`` (or ``generate_sample``) with the request's seed. One host
read every ``steps_per_sync`` steps brings back finished, n_confirmed,
init_len and step_idx of every lane; the output buffers are read only when
a lane streams new tokens or finishes, once for both. On the card the
batched step is a replayed CUDA graph over the lanes (``core/graphs.py``),
which never move: admission writes a lane in place, its stream's key and
counter too (``ops/philox.py``).

The engine runs where its ``LookaheadEngine`` runs (the card unless that
engine was built with ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from .engine import (_INT32_MAX, GenerationResult, LookaheadEngine, _eos_vec,
                     lane_slot, write_lane)


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int
    eos_token_id: Optional[object] = None
    seed: int = 0
    request_id: Optional[object] = None
    # per-request sampling knobs (sampling-mode engines only; None = the
    # engine-level SamplingConfig defaults)
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    # shared-prompt KV reuse: a ``precompute_prefix`` result of the engine
    # that serves the request; the prompt must start with its tokens
    prefix: Optional[object] = None
    # per-request streaming: called with each np.ndarray of newly confirmed
    # token ids as the scheduler observes them, once per host read (every
    # ``steps_per_sync`` decode steps); a fused drain (the throughput
    # objective, adaptive's deep backlog) delivers the whole output in one
    # call at completion. Exceptions propagate to ``step()``.
    on_tokens: Optional[object] = None
    # paged serving only: attach ``result.prefix``, a PagedPrefix over this
    # request's confirmed tokens (conversation KV carry at the cost of a
    # few page references, not of a copy of the cache)
    return_prefix: bool = False
    # latency class: an interactive request jumps the admission queue and
    # always takes a lane, even while the adaptive objective drains a deep
    # backlog fused (ignored by the lane-less throughput objective)
    interactive: bool = False


class ContinuousBatchingEngine:
    def __init__(self, engine: LookaheadEngine, num_lanes: int = 4,
                 steps_per_sync: int = 4, sampling=None,
                 objective: str = "fairness", batch_group: int = 1):
        """``steps_per_sync`` batched decode steps run between host reads:
        fewer reads, at the cost of up to that many steps of admission
        delay (finished lanes change nothing).

        ``sampling`` (a SamplingConfig) switches every lane to SpecInfer
        verification with its warpers; a request's ``temperature`` and
        ``top_p`` override them for that request (its ``top_p`` applies
        whatever the engine's is).

        ``objective`` picks the scheduling policy:

        - ``"fairness"``: every active request advances each step (the
          lowest time to first token and tail latency).
        - ``"throughput"``: drain the queue through fused sequential
          ``generate`` / ``generate_sample`` calls, one request (or one
          ``batch_group`` of requests with the same ``max_new_tokens`` and
          EOS, one shared prefix and, on a greedy engine, no sampling
          override, through ``generate_batch``) a scheduling step.
        - ``"adaptive"``: by backlog depth. With the lanes idle and more
          than ``num_lanes`` requests queued, the overflow drains fused;
          once the backlog fits the lanes, requests are laned. Active
          lanes finish on the lane path first, with two exceptions: when
          at most ``max(1, num_lanes // 4)`` lanes remain active the free
          lanes take queued requests (the head-of-line guard), and while
          an interactive request is queued or live the fused drain is
          suspended and only interactive requests are admitted.
        """
        if objective not in ("fairness", "throughput", "adaptive"):
            raise ValueError(f"unknown objective: {objective!r}")
        if batch_group < 1:
            raise ValueError("batch_group must be >= 1")
        if num_lanes < 1 or steps_per_sync < 1:
            raise ValueError("num_lanes and steps_per_sync must be >= 1")
        self.engine = engine
        self.num_lanes = num_lanes
        self.steps_per_sync = steps_per_sync
        self.sampling = sampling
        self.objective = objective
        self.batch_group = batch_group
        self._queue: Deque = deque()           # (Request, t_submit) pairs
        self._iqueue: Deque = deque()          # the interactive class first
        self._results: List[GenerationResult] = []
        self._active: Dict[int, Request] = {}  # lane -> request
        self._lanes = None                     # a LaneSlot, at first use
        self._t0: Dict[int, float] = {}        # lane -> admission time
        self._submit_t: Dict[int, float] = {}  # lane -> submit time
        self._first_tok: Dict[int, float] = {}  # lane -> first-token time
        self._served: Dict[int, int] = {}      # lane -> tokens streamed out
        # batched decode steps taken and device-to-host reads made by the
        # lane path (a fused drain's reads are its engine's own)
        self.steps_run = 0
        self.host_reads = 0

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Enqueue; the submit time anchors the request's ``ttft_s`` and
        ``latency_s``. An interactive request goes to the priority queue
        (except under the lane-less throughput objective)."""
        if request.interactive and self.objective != "throughput":
            self._iqueue.append((request, time.perf_counter()))
        else:
            self._queue.append((request, time.perf_counter()))

    def _ensure_lanes(self) -> None:
        """The lanes (``engine.lane_slot``: the shared pool, bookkeeping,
        streams and the captured steps, at fixed addresses), every lane
        idle: finished, on its own page, with an empty pool."""
        if self._lanes is not None:
            return
        with torch.inference_mode():
            self._lanes = lane_slot(self.engine, self.num_lanes)
            # each lane's top_p on the host too, for the sort's skip
            self._topp_host = np.ones(self.num_lanes, np.float32)

    def _warpers(self, req: Request):
        """(temperature, top_p) of a request on a sampling engine, checked
        by SamplingConfig's own rules; a greedy engine refuses a request
        that sets either."""
        if self.sampling is None:
            if req.temperature is not None or req.top_p is not None:
                raise ValueError(
                    "request sets temperature/top_p but the engine was "
                    "built without a SamplingConfig (greedy mode); pass "
                    "sampling= to ContinuousBatchingEngine")
            return 1.0, 1.0
        temp = (self.sampling.temperature if req.temperature is None
                else req.temperature)
        topp = self.sampling.top_p if req.top_p is None else req.top_p
        dataclasses.replace(self.sampling, temperature=temp, top_p=topp)
        return temp, topp

    def _admit(self, interactive_only: bool = False) -> None:
        def has_work():
            return bool(self._iqueue or
                        (self._queue and not interactive_only))
        eng, slot = self.engine, self._lanes
        for lane in range(self.num_lanes):
            if not has_work():
                break
            if lane in self._active:
                continue
            # interactive requests jump the queue (latency class)
            req, t_submit = (self._iqueue.popleft() if self._iqueue
                             else self._queue.popleft())
            try:
                # every check before the lane is touched, so that a bad
                # request fails alone and the lanes keep running
                eos = _eos_vec(req.eos_token_id, eng.device)
                temp, topp = self._warpers(req)
                out_buf, P, fill = eng._host_args(req.prompt,
                                                  req.max_new_tokens,
                                                  req.prefix)
            except ValueError as e:
                self._fail(req, e)
                continue
            # the lone call's own prepare, copied into the lane in place
            with eng._slot() as flat:
                write_lane(slot, lane, eng._prepare(out_buf, P, req.seed,
                                                    fill, req.prefix,
                                                    slot=flat))
            slot.max_new[lane] = min(req.max_new_tokens, _INT32_MAX)
            slot.eos[lane] = eos
            slot.temperature[lane] = temp
            slot.top_p[lane] = topp
            self._topp_host[lane] = topp
            self._t0[lane] = time.perf_counter()
            self._submit_t[lane] = t_submit
            self._first_tok.pop(lane, None)
            if req.on_tokens is not None:
                self._served[lane] = P
            self._active[lane] = req

    def _observe(self) -> np.ndarray:
        """finished, n_confirmed, init_len and step_idx of every lane, in
        one device-to-host transfer; records each active lane's first-token
        time (to the scheduler's own sync granularity)."""
        st = self._lanes.states
        host = torch.stack([st.finished.int(), st.n_confirmed, st.init_len,
                            st.step_idx]).cpu().numpy()
        self.host_reads += 1
        now = time.perf_counter()
        for lane in self._active:
            if lane not in self._first_tok and host[1, lane] > host[2, lane]:
                self._first_tok[lane] = now
        return host

    def _out_buf(self) -> np.ndarray:
        self.host_reads += 1
        return self._lanes.states.out_buf.cpu().numpy()

    def _emit_stream(self, n_confirmed, init_len):
        """Newly confirmed tokens to the requests that stream, with one
        read of the output buffers (only when some streaming lane has new
        tokens), which is returned so that the same sync's harvest reuses
        it. ``_served`` advances only after the callback returns, so a
        raising callback gets its chunk again (at least once) if the
        caller recovers and keeps stepping."""
        pending = []
        for lane, req in self._active.items():
            if lane not in self._served:
                continue
            total = min(int(n_confirmed[lane]),
                        int(init_len[lane]) + req.max_new_tokens)
            if total > self._served[lane]:
                pending.append((lane, req, total))
        if not pending:
            return None
        out_buf = self._out_buf()
        for lane, req, total in pending:
            req.on_tokens(out_buf[lane, self._served[lane]:total].copy())
            self._served[lane] = total
        return out_buf

    def _harvest(self, host, out_buf=None) -> None:
        finished, n_confirmed, init_len, steps = host
        done = [lane for lane in list(self._active) if finished[lane]]
        if not done:
            return
        if out_buf is None:
            out_buf = self._out_buf()
        now = time.perf_counter()
        for lane in done:
            req = self._active.pop(lane)
            self._served.pop(lane, None)
            total = min(int(n_confirmed[lane]),
                        int(init_len[lane]) + req.max_new_tokens)
            t_submit = self._submit_t.pop(lane)
            res = GenerationResult(
                tokens=out_buf[lane, :total].copy(),
                prompt_len=int(init_len[lane]),
                steps=int(steps[lane]),
                wall_time_s=now - self._t0.pop(lane),
                ttft_s=self._first_tok.pop(lane, now) - t_submit,
                latency_s=now - t_submit,
            )
            res.request_id = req.request_id
            self._results.append(res)
            if self.engine.log is not None:
                self.engine.log.append(res)

    def _fail(self, req: Request, err: Exception) -> None:
        res = GenerationResult(
            tokens=np.asarray(req.prompt, np.int32),
            prompt_len=len(req.prompt), steps=0)
        res.request_id = req.request_id
        res.error = str(err)
        self._results.append(res)

    # ------------------------------------------------------------------
    def _finish_fused(self, req: Request, res: GenerationResult,
                      t_submit: float, now: float) -> None:
        """A fused call's result: the whole output lands at once, so its
        time to first token is its latency (the throughput objective's
        honest cost)."""
        res.request_id = req.request_id
        res.latency_s = res.ttft_s = now - t_submit
        if req.on_tokens is not None:
            req.on_tokens(np.asarray(res.new_tokens))
        self._results.append(res)

    def _step_group(self, group, submits) -> bool:
        """``batch_group`` requests through one ``generate_batch``, when
        they may share it: the same ``max_new_tokens`` and EOS, one shared
        prefix (generate_batch takes one), and on a greedy engine no
        sampling override (generate_batch would run it greedy instead of
        failing it). Returns False when they may not, or when the batch
        refused them (then each runs alone, so that a bad one fails
        alone)."""
        try:
            keys = {(r.max_new_tokens,
                     tuple(np.ravel(_eos_vec(r.eos_token_id, "cpu"))))
                    for r in group}
        except ValueError:
            return False
        no_overrides = (self.sampling is not None
                        or all(r.temperature is None and r.top_p is None
                               for r in group))
        if (len(group) < 2 or len(keys) != 1 or not no_overrides
                or len({id(r.prefix) for r in group}) != 1):
            return False
        skw = {}
        if self.sampling is not None:
            skw = dict(
                sampling=self.sampling,
                temperatures=[self.sampling.temperature if r.temperature
                              is None else r.temperature for r in group],
                top_ps=[self.sampling.top_p if r.top_p is None else r.top_p
                        for r in group])
        try:
            outs = self.engine.generate_batch(
                [r.prompt for r in group], group[0].max_new_tokens,
                eos_token_id=group[0].eos_token_id,
                seeds=[r.seed for r in group], prefix=group[0].prefix, **skw)
        except ValueError:
            return False
        now = time.perf_counter()
        for r, o, t in zip(group, outs, submits):
            self._finish_fused(r, o, t, now)
        return True

    def _step_sequential(self) -> bool:
        """The throughput objective: the next queued request (or
        ``batch_group`` of them) to completion through the engine's fused
        calls. Returns True while requests are queued."""
        if not self._queue:
            return False
        if self.batch_group > 1:
            pairs = [self._queue.popleft()
                     for _ in range(min(self.batch_group, len(self._queue)))]
            group, submits = [r for r, _ in pairs], [t for _, t in pairs]
            if self._step_group(group, submits):
                return bool(self._queue)
            # one by one: back to the queue, the head this step
            self._queue.extendleft(reversed(pairs))
        req, t_submit = self._queue.popleft()
        try:
            temp, topp = self._warpers(req)
            kw = dict(eos_token_id=req.eos_token_id, seed=req.seed,
                      prefix=req.prefix)
            if self.sampling is None:
                res = self.engine.generate(req.prompt, req.max_new_tokens,
                                           **kw)
            else:
                cfg = dataclasses.replace(self.sampling, temperature=temp,
                                          top_p=topp)
                res = self.engine.generate_sample(
                    req.prompt, req.max_new_tokens, cfg, **kw)
        except ValueError as e:
            self._fail(req, e)
            return bool(self._queue)
        self._finish_fused(req, res, t_submit, time.perf_counter())
        return bool(self._queue)

    # ------------------------------------------------------------------
    def _lane_steps(self) -> None:
        """``steps_per_sync`` batched steps of every lane (replays of the
        captured step on the card)."""
        sampled = self.sampling is not None
        # the top-p sort runs when a live request asks for top-p
        top_p_on = sampled and self._topp_host[list(self._active)].min() < 1.0
        self.engine._lane_runner(
            self._lanes, sampled, bool(top_p_on),
            self.sampling.top_k if sampled else 0).run(self.steps_per_sync)
        self.steps_run += self.steps_per_sync

    def step(self) -> bool:
        """Admit, ``steps_per_sync`` lane steps, one host read, stream and
        harvest (fairness; adaptive with the backlog inside the lanes), or
        one fused drain call (throughput; adaptive's deep backlog on idle
        lanes). Returns True while any lane is active or any request is
        queued."""
        if self.objective == "throughput":
            return self._step_sequential()
        with torch.inference_mode():
            self._ensure_lanes()
            deep = len(self._queue) > self.num_lanes
            # While an interactive request is queued or on a lane, adaptive
            # suspends the fused drain (a fused call would stall its stream
            # for a whole generate) and admits only interactive requests:
            # batch requests wait for the drain to resume. An interactive
            # request that arrives during a fused call waits for that call.
            interactive_live = bool(self._iqueue) or any(
                r.interactive for r in self._active.values())
            if self.objective == "adaptive" and deep:
                if interactive_live:
                    self._admit(interactive_only=True)
                elif not self._active:
                    # deep backlog, idle lanes: drain the overflow fused;
                    # the last <= num_lanes requests go to the lanes
                    self._step_sequential()
                    return bool(self._active or self._queue or self._iqueue)
                # active lanes and a deep backlog: the lanes finish first,
                # except that a lone straggler must not idle the rest of
                # the lanes (the head-of-line guard; a looser threshold
                # would keep the scheduler in lane mode for good)
                elif len(self._active) <= max(1, self.num_lanes // 4):
                    self._admit()
            else:
                self._admit()
            if not self._active:
                return bool(self._queue or self._iqueue)
            self._lane_steps()
            host = self._observe()
            out_buf = self._emit_stream(host[1], host[2])
            self._harvest(host, out_buf)
        return bool(self._active or self._queue or self._iqueue)

    def run(self, requests: Sequence[Request]) -> List[GenerationResult]:
        """Offline mode: submit every request and step until all are done.
        Returns the results in completion order (match them by
        ``request_id``)."""
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        out, self._results = self._results, []
        return out
