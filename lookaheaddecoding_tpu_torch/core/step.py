"""The greedy lookahead decode step, prefill and the AR baseline step.

One static-shape step does: guess lookup -> composite assembly -> model
forward -> verification -> KV commit -> window slide -> pool harvest ->
output append. Every tensor it makes has a shape fixed when the engine is
built, and it reads nothing back to the host, so the host can queue many
steps ahead of the device (and a later change can capture the step in a
CUDA graph). The generation loops read ``finished`` from the device once
per batch of steps, never on every step.

A step taken after ``finished`` leaves the state as it was (the JAX
package's ``lax.cond(state.finished, ...)``): scalars and the window are
selected with ``torch.where``, the pool update and the output append are
masked. Only cache slots past the committed ones are rewritten (and, once
the capacity stop has ended a run, the last S slots), which no read sees.

The state is updated in place: the caches, the pool and the output buffer
are written where they lie, so a step allocates no second copy of them.

Exactness: window and pool content only proposes tokens; acceptance needs
agreement with the model's own argmax, so the output equals the AR
baseline's whatever the window seeding.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import EngineConfig, LookaheadConfig
from ..models import llama
from .layout import Layout
from .pool import (PoolState, bigram_key, pool_lookup, pool_table_rows,
                   pool_update)
from .state import DecodeState

def _append(buf: torch.Tensor, start: torch.Tensor, vals: torch.Tensor,
            skip: torch.Tensor) -> torch.Tensor:
    """Write ``vals`` at buf[start:start+len(vals)] in place unless
    ``skip``. The start is clamped as ``lax.dynamic_update_slice`` clamps
    it (an index past the buffer would be a device-side assert)."""
    n = vals.shape[0]
    idx = (start.long().clamp(0, buf.shape[0] - n)
           + torch.arange(n, device=buf.device))
    buf[idx] = torch.where(skip, buf[idx], vals)
    return buf


def make_post_forward(mcfg, lcfg: LookaheadConfig, layout: Layout, device):
    """What a greedy step does after the model forward and before the KV
    commit: longest-prefix verification, EOS truncation, output append,
    pool harvest and window slide. Returns ``post(state, logits, guesses,
    guess_valid, lst, prev, max_new, eos_id, cap) -> (updates, winner,
    max_hit)``; ``updates`` holds the new bookkeeping fields (not yet
    selected against ``finished``), while the output buffer and the pool
    are written in place, masked when the state is finished."""
    W, N = layout.window, layout.level
    G, GS, S = layout.guess_set_size, layout.guess_size, layout.seq_len
    n_window = layout.n_window
    inp_rows = slice(1, 1 + W)
    guess_rows = slice(1 + W, 1 + W + G * GS)
    rows = (pool_table_rows(mcfg.vocab_size, 2, lcfg.pool_hash_size)
            if lcfg.pool_key_len == 2 else 0)
    if not lcfg.always_fwd_one:
        # always_fwd_one=False: level segments of the flat window, the
        # index of each entry within its level, and each level's width
        seg = np.concatenate([np.zeros(W - 1, np.int64)]
                             + [np.full(W, 1 + lv) for lv in range(N - 2)])
        j_in, width, seg_start = (torch.from_numpy(a).to(device) for a in (
            np.concatenate([np.arange(W - 1)] + [np.arange(W)] * (N - 2)),
            np.where(seg == 0, W - 1, W),
            np.concatenate([np.zeros(W - 1, np.int64)]
                           + [np.full(W, (W - 1) + lv * W)
                              for lv in range(N - 2)])))

    def post(state: DecodeState, logits, guesses, guess_valid, lst, prev,
             max_new: int, eos_id, cap: int):
        dev = logits.device
        fin = state.finished
        new_results = logits[inp_rows].argmax(dim=-1).int()       # [W]
        next_token = logits[0].argmax().int().view(1)
        # torch.argmax, like jnp.argmax, returns the first maximum
        if G > 0:
            guess_results = logits[guess_rows].argmax(dim=-1).int().view(G, GS)
            correct = torch.cat(
                [next_token.expand(G, 1), guess_results[:, :GS - 1]], dim=1)
            m0 = (guesses == correct).int().cumprod(dim=1).sum(dim=1)
            # acceptance is capped at GS tokens a step, as the reference's
            # scan index stops at GS-1 even on a full match
            m = torch.where(guess_valid, m0.clamp(max=GS - 1), -1)
            max_hit = m.max().clamp(min=0)
            winner = m.argmax()
            hits = torch.cat([next_token, guess_results.index_select(
                0, winner.view(1))[0, :GS - 1]])
        else:
            max_hit = torch.zeros((), dtype=torch.int32, device=dev)
            winner = torch.zeros((), dtype=torch.long, device=dev)
            hits = next_token.expand(GS)

        # EOS truncation: any listed id (pad slots are -1) ends the output
        hit_pos = torch.arange(GS, device=dev)
        is_eos = ((hits[:, None] == eos_id[None, :]).any(dim=1)
                  & (hit_pos <= max_hit))
        has_eos = is_eos.any()
        max_hit = torch.where(has_eos, is_eos.int().argmax(), max_hit).int()

        # output append (fixed-size write; the tail is overwritten later)
        out_buf = _append(state.out_buf, state.n_confirmed, hits, fin)
        n_confirmed = state.n_confirmed + 1 + max_hit
        new_kv_len = state.kv_len + 1 + max_hit

        # pool harvest: key ``lst`` takes window column 0, key L0[i-1]
        # column i of the trajectory; bigram keys use the preceding pair
        key1 = torch.cat([lst, state.window[:W - 1]])
        traj = state.window[W - 1:].view(N - 2, W)                 # levels 1..
        harvest_tups = torch.cat([traj.T, new_results[:, None]], dim=1)
        harvest_valid = (state.step_idx >= N - 2).expand(W)
        if lcfg.pool_key_len == 2:
            key0 = torch.cat([prev, lst, state.window[:W - 2]])
            harvest_keys = bigram_key(key0, key1, rows)
        else:
            harvest_keys = key1
        if lcfg.pool_from_prompt:
            # n-grams ending at each newly accepted token; lanes whose start
            # is negative are invalid, and their gathers are clamped into
            # the buffer (a JAX gather clamps, a CUDA index would assert)
            starts = (state.n_confirmed.long() - GS
                      + torch.arange(GS, device=dev))
            last = out_buf.shape[0] - 1
            gidx = (starts[:, None] + 1
                    + torch.arange(GS, device=dev)[None, :]).clamp(0, last)
            gen_tups = out_buf[gidx]
            if lcfg.pool_key_len == 2:
                gen_keys = bigram_key(out_buf[(starts - 1).clamp(0, last)],
                                      out_buf[starts.clamp(0, last)], rows)
                gen_valid = (hit_pos <= max_hit) & (starts >= 1)
            else:
                gen_keys = out_buf[starts.clamp(0, last)]
                gen_valid = (hit_pos <= max_hit) & (starts >= 0)
            harvest_keys = torch.cat([harvest_keys, gen_keys])
            harvest_tups = torch.cat([harvest_tups, gen_tups])
            harvest_valid = torch.cat([harvest_valid, gen_valid])
        clock = state.pool.clock
        pool = pool_update(state.pool, harvest_keys, harvest_tups,
                           harvest_valid & ~fin)
        pool.clock = torch.where(fin, clock, pool.clock)

        # window slide (always_fwd_one): L0 <- L1[1:], Lk <- Lk+1, newest
        # level <- this step's argmax at the newest level's rows
        window = torch.cat([state.window[W:], new_results])
        if not lcfg.always_fwd_one:
            # every level also advances by the accepted span; the vacated
            # tail takes random copies of confirmed tokens
            shifted = j_in + max_hit
            idx = seg_start + torch.minimum(shifted, width - 1)
            u = torch.rand(n_window, generator=state.rng, device=dev)
            ridx = torch.minimum((u * n_confirmed).long(),
                                 n_confirmed.long() - 1)
            window = torch.where(shifted < width, window[idx], out_buf[ridx])

        finished = (fin | has_eos
                    | (n_confirmed - state.init_len >= max_new)
                    | (new_kv_len + S > cap))    # cache capacity stop
        updates = dict(kv_len=new_kv_len, window=window,
                       n_confirmed=n_confirmed,
                       step_idx=state.step_idx + 1, finished=finished)
        return updates, winner, max_hit

    return post


def _keep_if_finished(state: DecodeState, updates: dict) -> DecodeState:
    """Apply ``updates`` to the state unless it was already finished."""
    fin = state.finished
    for name, new in updates.items():
        setattr(state, name, torch.where(fin, getattr(state, name), new))
    return state


class StepFns(NamedTuple):
    init_state: Callable
    prefill_chunk: Callable
    prefill_all: Callable     # whole-prompt prefill
    decode_loop: Callable     # greedy lookahead generation to the end
    decode_step: Callable     # one greedy lookahead step
    baseline_loop: Callable   # autoregressive greedy generation
    baseline_step: Callable   # one AR step


def _run_loop(step, state: DecodeState, max_new: int, per_step: int):
    """Steps until ``finished``. Each batch runs as many steps as cannot
    reach ``max_new`` (a step confirms at most ``per_step`` tokens), then
    reads ``finished`` and ``n_confirmed`` in one host transfer, so the
    last batch overshoots only when EOS or the capacity stop ends the run;
    the overshooting steps change nothing."""
    generated = 0
    while True:
        for _ in range(max(1, -(-(max_new - generated) // per_step))):
            state = step(state)
        finished, n_conf, init_len = torch.stack(
            [state.finished.int(), state.n_confirmed, state.init_len]).tolist()
        if finished:
            return state
        generated = n_conf - init_len


def build_step_fns(mcfg: llama.LlamaConfig, lcfg: LookaheadConfig,
                   ecfg: EngineConfig, layout: Layout, device) -> StepFns:
    M = ecfg.max_seq_len
    S, W, N = layout.seq_len, layout.window, layout.level
    G, GS = layout.guess_set_size, layout.guess_size
    n_window = layout.n_window
    C = ecfg.prefill_chunk

    # sliding window: a query at position p sees keys in (p - sw, p]; a
    # window at least the cache capacity never binds
    SW = mcfg.sliding_window or 0
    if SW >= M:
        SW = 0

    rope_cos, rope_sin = llama.rope_tables(mcfg, M, device)
    rel_pos = torch.from_numpy(layout.rel_pos).to(device)
    # composite rows whose logits are read: row 0 (next token), the newest
    # window level and the verification branch
    logits_rows = torch.from_numpy(np.concatenate([
        np.array([0]), np.arange(layout.inp_start, layout.inp_stop),
        np.arange(layout.guess_start, layout.seq_len)])).to(device)
    no_rows = torch.zeros(0, dtype=torch.long, device=device)
    # the attention's visibility (ops/lookahead_attention.py), computed by
    # the kernel or the plain version from kv_len on the device
    meta = dict(level=N, window=W, guess_size=GS, sliding_window=SW)
    impl = "kernel" if lcfg.attention_impl == "kernel" else "dense"
    post = make_post_forward(mcfg, lcfg, layout, device)

    # ------------------------------------------------------------------
    def init_state(k_cache, v_cache, pool: PoolState, out_buf, prompt_len: int,
                   rng: torch.Generator) -> DecodeState:
        """Window seeded at steady-state level sizes by ``window_init``."""
        if lcfg.window_init == "random_set":
            window = torch.randint(0, mcfg.vocab_size, (n_window,),
                                   generator=rng, device=device)
        elif lcfg.window_init == "order_copy_from":
            window = out_buf[torch.arange(n_window, device=device) % prompt_len]
        elif lcfg.window_init == "copy_from_last":
            window = out_buf[prompt_len - 1].expand(n_window)
        else:  # copy_from: random copies of prompt tokens
            window = out_buf[torch.randint(0, prompt_len, (n_window,),
                                           generator=rng, device=device)]

        def scalar(x, dtype=torch.int32):
            return torch.tensor(x, dtype=dtype, device=device)

        return DecodeState(
            k_cache=k_cache, v_cache=v_cache, kv_len=scalar(0),
            window=window.int().contiguous(), pool=pool, out_buf=out_buf,
            n_confirmed=scalar(prompt_len), init_len=scalar(prompt_len),
            step_idx=scalar(0), finished=scalar(False, torch.bool), rng=rng)

    # ------------------------------------------------------------------
    def prefill_chunk(params, state: DecodeState, tokens, start: int,
                      prompt_len: int) -> DecodeState:
        """Prompt tokens [start, start+C) into the KV cache (causal). The
        caller feeds prompt[:-1]; the last prompt token is the first
        step's ``lst``."""
        positions = start + torch.arange(C, device=device)
        kv_len = torch.tensor([start], dtype=torch.int32, device=device)
        llama.forward(params, mcfg, tokens, positions, state.k_cache,
                      state.v_cache, start, rope_cos, rope_sin,
                      dict(meta, causal=True, kv_len=kv_len),
                      logits_rows=no_rows, attn_impl=impl)
        state.kv_len = torch.tensor(min(start + C, prompt_len - 1),
                                    dtype=torch.int32, device=device)
        return state

    def prefill_all(params, state: DecodeState, prompt_len: int) -> DecodeState:
        """prompt[:-1] in C-sized chunks. The prompt length is host data, so
        the chunk starts are host ints; the last chunk is aligned to end at
        the prompt (start = n - C), and a prompt shorter than C pads within
        [0, C), whose tail slots stay masked until overwritten."""
        n = prompt_len - 1
        for c in range(-(-n // C) if n > 0 else 0):
            start = min(c * C, max(n - C, 0))
            state = prefill_chunk(params, state, state.out_buf[start:start + C],
                                  start, prompt_len)
        state.kv_len = torch.tensor(max(n, 0), dtype=torch.int32, device=device)
        return state

    # ------------------------------------------------------------------
    def decode_step(params, state: DecodeState, max_new: int,
                    eos_id) -> DecodeState:
        kv_len = state.kv_len
        lst = state.out_buf.index_select(0, (state.n_confirmed - 1).long().view(1))
        if lcfg.pool_key_len == 2:
            rows = pool_table_rows(mcfg.vocab_size, 2, lcfg.pool_hash_size)
            prev = state.out_buf.index_select(
                0, (state.n_confirmed - 2).clamp(min=0).long().view(1))
            lookup_key = bigram_key(prev, lst, rows)
        else:
            prev = lookup_key = lst
        guesses, guess_valid = pool_lookup(state.pool, lookup_key)  # [G,GS],[G]
        tokens = torch.cat([lst, state.window, guesses.reshape(-1)])
        positions = kv_len + rel_pos
        logits, k_cache, v_cache = llama.forward(
            params, mcfg, tokens, positions, state.k_cache, state.v_cache,
            kv_len, rope_cos, rope_sin, dict(meta, kv_len=kv_len.view(1)),
            logits_rows=logits_rows, attn_impl=impl)

        updates, winner, max_hit = post(state, logits, guesses, guess_valid,
                                        lst, prev, max_new, eos_id, M)

        # KV commit: the winning n-gram's K/V move from the verification
        # region to the slots right after lst's. Fixed-size copy; slots
        # past max_hit are rewritten before they become visible. Both
        # starts are clamped as lax.dynamic_slice clamps them.
        if G > 0:
            ar = torch.arange(GS, device=device)
            src = (kv_len + layout.guess_start + winner * GS).long().clamp(
                0, M - GS) + ar
            dst = (kv_len + 1).long().clamp(0, M - GS) + ar
            for cache in (k_cache, v_cache):   # plain or int8 {"q", "s"}
                for buf in (cache.values() if isinstance(cache, dict)
                            else (cache,)):
                    buf.index_copy_(2, dst, buf.index_select(2, src))
        return _keep_if_finished(state, updates)

    def decode_loop(params, state: DecodeState, max_new: int, eos_id):
        return _run_loop(lambda s: decode_step(params, s, max_new, eos_id),
                         state, max_new, GS)

    # ------------------------------------------------------------------
    # Autoregressive baseline: one token a step. Attention is causal mode
    # with one query row at kv_len: JAX's dense mask col <= kv_len.
    def baseline_step(params, s: DecodeState, max_new: int,
                      eos_id) -> DecodeState:
        kv_len = s.kv_len
        lst = s.out_buf.index_select(0, (s.n_confirmed - 1).long().view(1))
        logits, _, _ = llama.forward(
            params, mcfg, lst, kv_len.view(1), s.k_cache, s.v_cache, kv_len,
            rope_cos, rope_sin, dict(meta, causal=True, kv_len=kv_len.view(1)),
            attn_impl=impl)
        nxt = logits[0].argmax().int().view(1)
        _append(s.out_buf, s.n_confirmed, nxt, s.finished)
        n_confirmed = s.n_confirmed + 1
        finished = (s.finished | (nxt == eos_id).any()
                    | (n_confirmed - s.init_len >= max_new)
                    | (kv_len + 2 > M))
        return _keep_if_finished(s, dict(
            kv_len=kv_len + 1, n_confirmed=n_confirmed,
            step_idx=s.step_idx + 1, finished=finished))

    def baseline_loop(params, state: DecodeState, max_new: int, eos_id):
        return _run_loop(lambda s: baseline_step(params, s, max_new, eos_id),
                         state, max_new, 1)

    return StepFns(
        init_state=init_state,
        prefill_chunk=prefill_chunk,
        prefill_all=prefill_all,
        decode_loop=decode_loop,
        decode_step=decode_step,
        baseline_loop=baseline_loop,
        baseline_step=baseline_step,
    )
