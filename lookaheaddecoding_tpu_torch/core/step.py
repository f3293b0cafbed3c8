"""The lookahead decode step (greedy and sampling), prefill and the AR
baseline step.

One static-shape step does: guess lookup -> composite assembly -> model
forward -> verification -> KV commit -> window slide -> pool harvest ->
output append. Every tensor it makes has a shape fixed when the engine is
built, and it reads nothing back to the host, so the host can queue many
steps ahead of the device, and the engines capture the step in a CUDA
graph. On one card a greedy, sampling or AR generation runs its whole
loop on the device (``graphs.LoopGraph``, or the decode node of a
``graphs.RequestGraph``, which holds the whole request); the other loops
read ``finished`` from the device once per batch of steps
(:func:`run_loop`), never on every step.

A step taken after ``finished`` leaves the state as it was (the JAX
package's ``lax.cond(state.finished, ...)``): scalars and the window are
selected with ``torch.where``, the pool update and the output append are
masked. Only cache slots past the committed ones are rewritten, which no
read sees; once the capacity stop has ended a run, a step would rewrite
the last S slots, committed rows among them, so no loop takes one then
(:func:`host_batch`; the device loop stops at the step that finished).

The state is updated in place: every field, the caches, the pool and the
output buffer are written where they lie, so a step allocates no second
copy of them and its tensors keep their addresses, which a captured step
needs (``core/graphs.py``): on the card the engines replay the step as a
CUDA graph.

Exactness: window and pool content only proposes tokens; acceptance needs
agreement with the model's own argmax (greedy) or passes SpecInfer
rejection sampling (``ops/sampling.py``), so greedy output equals the AR
baseline's whatever the window seeding, and sampled output follows the
model's warped distribution.

Randomness: each lane has its own Philox stream in the state
(``ops/philox.py``: ``key``, its seed, and ``draws``, the draws made), the
counterpart of JAX's ``DecodeState.rng``. A step that draws takes one draw
of a count fixed by the configuration and never by the data, in a fixed
order (the sampling verification, then the ``always_fwd_one=False``
refill, then the sampling mode's EOS filter), and advances ``draws`` by
one, which a finished lane keeps as it was. The kernel reads the counter
on the device, so a captured step draws fresh numbers on every replay and
every iteration of a device loop, and the device loop, which stops at
``finished``, and the host loop, which may overshoot, end in the same
state. A lane draws the same numbers alone as in a batch. The window
seeding draws from the same stream under its own tag.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import EngineConfig, LookaheadConfig
from ..models import llama
from ..ops import philox
from ..ops.sampling import (lane_uniforms, rejection_sample_verify_core,
                            split_verify_noise, verify_noise_size,
                            warp_logits)
from . import graphs
from .layout import Layout
from .pool import (PoolState, bigram_key, pool_lookup, pool_table_rows,
                   pool_update)
from .state import DecodeState

def _append(buf: torch.Tensor, start: torch.Tensor, vals: torch.Tensor,
            skip: torch.Tensor) -> torch.Tensor:
    """Write ``vals`` at buf[..., start:start+n] in place unless ``skip``
    (one start and one skip a row for a [B, len] buffer and [B, n] values).
    The start is clamped as ``lax.dynamic_update_slice`` clamps it (an
    index past the buffer would be a device-side assert)."""
    n = vals.shape[-1]
    idx = (start.long().clamp(0, buf.shape[-1] - n)[..., None]
           + torch.arange(n, device=buf.device))
    buf.scatter_(-1, idx, torch.where(skip[..., None], buf.gather(-1, idx),
                                      vals))
    return buf


def make_post_forward(mcfg, lcfg: LookaheadConfig, layout: Layout, device,
                      mode: str = "greedy"):
    """What a step does after the model forward and before the KV commit:
    verification (greedy longest-prefix, or SpecInfer rejection sampling
    for ``mode="sample"``), EOS truncation, output append, pool harvest and
    window slide, for B lanes at once. Returns ``post(state, logits,
    guesses, guess_valid, lst, prev, max_new, eos_id, cap, temperature=None,
    top_p=None, top_k=0) -> (updates, winner, max_hit)``. Every tensor has
    a leading lane axis: ``state`` holds [B]-shaped scalars, a [B,
    n_window] window, a [B, len] output buffer, a stacked pool and the
    lanes' streams, ``key`` [B, 2] and ``draws`` [B] (``PagedLaneState``,
    or :func:`_as_lanes` of one ``DecodeState``); logits [B, rows, V]; lst,
    prev [B]; eos_id [B, n_eos]; ``max_new`` and ``cap`` ints or [B]
    tensors. The sampling mode takes ``temperature`` [B], ``top_p`` [B] or
    None (no lane asks for top-p: the sort is skipped) and an int ``top_k``
    (0: off). ``updates`` holds the new bookkeeping fields (not yet
    selected against ``finished``), while the output buffer and the pool
    are written in place, masked for finished lanes."""
    assert mode in ("greedy", "sample"), mode
    W, N = layout.window, layout.level
    G, GS, S = layout.guess_set_size, layout.guess_size, layout.seq_len
    n_window = layout.n_window
    inp_rows = slice(1, 1 + W)
    guess_rows = slice(1 + W, 1 + W + G * GS)
    V = mcfg.vocab_size
    rows = (pool_table_rows(V, 2, lcfg.pool_hash_size)
            if lcfg.pool_key_len == 2 else 0)
    # a lane's uniforms a step, in the order they are used
    noise_sizes = [verify_noise_size(G, GS, V) if mode == "sample" else 0,
                   0 if lcfg.always_fwd_one else n_window,
                   W if mode == "sample" else 0]
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

    def post(state, logits, guesses, guess_valid, lst, prev, max_new, eos_id,
             cap, temperature=None, top_p=None, top_k=0):
        dev = logits.device
        b = logits.shape[0]
        fin = state.finished
        new_results = logits[:, inp_rows].argmax(dim=-1).int()    # [B, W]
        u_verify, u_refill, u_filter = (
            lane_uniforms(state.key, state.draws, sum(noise_sizes)).split(
                noise_sizes, dim=1) if sum(noise_sizes) else (None,) * 3)
        if mode == "sample":
            probs_next = torch.softmax(warp_logits(
                logits[:, 0], temperature, top_k, top_p), dim=-1)
            guess_probs = torch.softmax(warp_logits(
                logits[:, guess_rows], temperature, top_k, top_p),
                dim=-1).view(b, G, GS, V)
            hits, max_hit, winner = rejection_sample_verify_core(
                probs_next, guess_probs, guesses, guess_valid,
                *split_verify_noise(u_verify, G, GS, V))
        elif G > 0:
            # torch.argmax, like jnp.argmax, returns the first maximum
            next_token = logits[:, 0].argmax(dim=-1).int()[:, None]  # [B, 1]
            guess_results = logits[:, guess_rows].argmax(dim=-1).int().view(
                b, G, GS)
            correct = torch.cat([next_token[:, None].expand(b, G, 1),
                                 guess_results[..., :GS - 1]], dim=2)
            m0 = (guesses == correct).int().cumprod(dim=2).sum(dim=2)
            # acceptance is capped at GS tokens a step, as the reference's
            # scan index stops at GS-1 even on a full match
            m = torch.where(guess_valid, m0.clamp(max=GS - 1), -1)
            max_hit = m.amax(dim=1).clamp(min=0)
            winner = m.argmax(dim=1)
            won = guess_results.gather(
                1, winner[:, None, None].expand(b, 1, GS))[:, 0]
            hits = torch.cat([next_token, won[:, :GS - 1]], dim=1)
        else:
            next_token = logits[:, 0].argmax(dim=-1).int()[:, None]
            max_hit = torch.zeros(b, dtype=torch.int32, device=dev)
            winner = torch.zeros(b, dtype=torch.long, device=dev)
            hits = next_token.expand(b, GS)

        # EOS truncation: any listed id (pad slots are -1) ends the output
        hit_pos = torch.arange(GS, device=dev)
        is_eos = ((hits[:, :, None] == eos_id[:, None, :]).any(dim=2)
                  & (hit_pos <= max_hit[:, None]))
        has_eos = is_eos.any(dim=1)
        max_hit = torch.where(has_eos, is_eos.int().argmax(dim=1),
                              max_hit).int()

        # output append (fixed-size write; the tail is overwritten later)
        out_buf = _append(state.out_buf, state.n_confirmed, hits, fin)
        n_confirmed = state.n_confirmed + 1 + max_hit
        new_kv_len = state.kv_len + 1 + max_hit

        # pool harvest: key ``lst`` takes window column 0, key L0[i-1]
        # column i of the trajectory; bigram keys use the preceding pair
        key1 = torch.cat([lst[:, None], state.window[:, :W - 1]], dim=1)
        traj = state.window[:, W - 1:].view(b, N - 2, W)           # levels 1..
        harvest_tups = torch.cat([traj.transpose(1, 2),
                                  new_results[:, :, None]], dim=2)
        harvest_valid = (state.step_idx >= N - 2)[:, None].expand(b, W)
        if lcfg.pool_key_len == 2:
            key0 = torch.cat([prev[:, None], lst[:, None],
                              state.window[:, :W - 2]], dim=1)
            harvest_keys = bigram_key(key0, key1, rows)
        else:
            harvest_keys = key1
        if lcfg.pool_from_prompt:
            # n-grams ending at each newly accepted token; lanes whose start
            # is negative are invalid, and their gathers are clamped into
            # the buffer (a JAX gather clamps, a CUDA index would assert)
            starts = (state.n_confirmed.long()[:, None] - GS
                      + torch.arange(GS, device=dev))              # [B, GS]
            last = out_buf.shape[1] - 1
            gidx = (starts[:, :, None] + 1
                    + torch.arange(GS, device=dev)).clamp(0, last)
            gen_tups = out_buf.gather(1, gidx.view(b, GS * GS)).view(
                b, GS, GS)
            live = hit_pos <= max_hit[:, None]
            if lcfg.pool_key_len == 2:
                gen_keys = bigram_key(
                    out_buf.gather(1, (starts - 1).clamp(0, last)),
                    out_buf.gather(1, starts.clamp(0, last)), rows)
                gen_valid = live & (starts >= 1)
            else:
                gen_keys = out_buf.gather(1, starts.clamp(0, last))
                gen_valid = live & (starts >= 0)
            harvest_keys = torch.cat([harvest_keys, gen_keys], dim=1)
            harvest_tups = torch.cat([harvest_tups, gen_tups], dim=1)
            harvest_valid = torch.cat([harvest_valid, gen_valid], dim=1)
        clock = state.pool.clock.clone()
        pool = pool_update(state.pool, harvest_keys, harvest_tups,
                           harvest_valid & ~fin[:, None])
        pool.clock.copy_(torch.where(fin, clock, pool.clock))

        # window slide (always_fwd_one): L0 <- L1[1:], Lk <- Lk+1, newest
        # level <- this step's argmax at the newest level's rows
        window = torch.cat([state.window[:, W:], new_results], dim=1)
        if not lcfg.always_fwd_one:
            # every level also advances by the accepted span; the vacated
            # tail takes random copies of confirmed tokens
            shifted = j_in + max_hit[:, None]
            idx = seg_start + torch.minimum(shifted, width - 1)
            window = torch.where(shifted < width, window.gather(1, idx),
                                 out_buf.gather(1, _copy_idx(u_refill,
                                                             n_confirmed)))
        if mode == "sample":
            # the newest level must not propose EOS (the reference's
            # filter_window, after the slide): such entries take random
            # copies of confirmed tokens
            newest = window[:, -W:]
            hit_eos = (newest[:, :, None] == eos_id[:, None, :]).any(dim=2)
            window = torch.cat([window[:, :-W], torch.where(
                hit_eos, out_buf.gather(1, _copy_idx(u_filter, n_confirmed)),
                newest)], dim=1)

        finished = (fin | has_eos
                    | (n_confirmed - state.init_len >= max_new)
                    | (new_kv_len + S > cap))    # cache capacity stop
        updates = dict(kv_len=new_kv_len, window=window,
                       n_confirmed=n_confirmed,
                       step_idx=state.step_idx + 1, finished=finished)
        if sum(noise_sizes):
            updates["draws"] = state.draws + 1
        return updates, winner, max_hit

    return post


def _copy_idx(u: torch.Tensor, n_confirmed: torch.Tensor) -> torch.Tensor:
    """Uniform random positions in [0, n_confirmed) a lane, from uniforms
    [B, n]: the random copies of confirmed tokens."""
    return torch.minimum((u * n_confirmed[:, None]).long(),
                         n_confirmed.long()[:, None] - 1)


def _as_lanes(state: DecodeState) -> SimpleNamespace:
    """One ``DecodeState`` as the one-lane batch that ``post`` takes: views
    with a leading axis of 1, so the in-place writes land in the state."""
    pool = PoolState(state.pool.values[None], state.pool.age[None],
                     state.pool.clock.view(1))
    return SimpleNamespace(
        pool=pool, key=state.key[None], out_buf=state.out_buf[None],
        window=state.window[None],
        **{name: getattr(state, name).view(1) for name in (
            "kv_len", "n_confirmed", "init_len", "step_idx", "finished",
            "draws")})


def seed_window(lcfg: LookaheadConfig, vocab: int, n_window: int,
                out_buf: torch.Tensor, key: torch.Tensor, draws: torch.Tensor,
                prompt_len) -> torch.Tensor:
    """A request's window [n_window] by ``lcfg.window_init``, from its
    output buffer (the prompt first) and, for ``copy_from`` (random copies
    of prompt tokens) and ``random_set`` (random ids), the lane's stream
    (``key`` [2], ``draws`` 0-d) under the window's own tag. Without a
    host read. ``prompt_len``, the bound of ``copy_from``'s draws as of
    JAX's ``randint`` and of the ``order_copy_from`` and
    ``copy_from_last`` indices, is an integer or a 0-d integer tensor on
    the buffer's device, which a captured seeding reads: the same ops
    either way, so both give the same bits."""
    device = out_buf.device
    if lcfg.window_init in ("order_copy_from", "copy_from_last"):
        idx = torch.arange(n_window, device=device)
        idx = (idx % prompt_len if lcfg.window_init == "order_copy_from"
               else idx * 0 + (prompt_len - 1))
        return out_buf.index_select(0, idx.long())
    u = lane_uniforms(key.view(1, 2), draws.view(1), n_window,
                      philox.WINDOW)[0]
    bound = vocab if lcfg.window_init == "random_set" else prompt_len
    idx = (u * bound).long().clamp(max=bound - 1)
    return idx if lcfg.window_init == "random_set" else out_buf[idx]


def keep_if_finished(state, updates: dict):
    """Write ``updates`` into the state's fields in place, except in lanes
    that were already finished (a flat state is one lane: a 0-d
    ``finished``). Every new value is selected before any is written, so
    ``finished`` itself may be among them."""
    fin = state.finished
    kept = {}
    for name, new in updates.items():
        old = getattr(state, name)
        keep = fin.view(-1, *([1] * (old.dim() - 1))) if fin.dim() else fin
        kept[name] = torch.where(keep, old, new)
    for name, new in kept.items():
        getattr(state, name).copy_(new)
    return state


class StepFns(NamedTuple):
    init_state: Callable      # a request's window and counters, in place
    prefill_chunk: Callable   # one prompt chunk, its start on the device
    prefill_from: Callable    # the prompt's chunks from row start0
    decode_step: Callable     # one greedy lookahead step
    sample_step: Callable     # one sampling lookahead step
    baseline_step: Callable   # one AR step


def host_batch(left: int, per_step: int, kv_len: int, last_start: int) -> int:
    """Steps the host may queue before its next read of the state: as many
    as cannot confirm ``left`` more tokens (a step confirms at most
    ``per_step``) and whose every step but the last starts at a ``kv_len``
    of at most ``last_start`` (``M - S``; the AR step's S is 1), so that
    none follows a capacity stop; at least one. A step after a capacity
    stop would rewrite the cache's last S slots, committed rows among them
    (its start is clamped as ``lax.dynamic_update_slice`` clamps it), which
    a ``return_prefix`` carries."""
    return max(1, min(-(-left // per_step),
                      (last_start - kv_len) // per_step + 1))


def run_loop(run: Callable[[int], None], state: DecodeState, max_new: int,
             kv_len: int, per_step: int, last_start: int) -> DecodeState:
    """The decode loop on the host: steps until ``finished``; ``run(n)``
    takes n steps of ``state`` in place (eagerly, or as replays of a
    captured step). Each batch runs :func:`host_batch` steps (``kv_len``
    the state's at the start), then reads ``finished``, ``n_confirmed``
    and ``kv_len`` in one host transfer, so the last batch overshoots only
    when EOS ends the run; the overshooting steps change nothing that is
    read. Where its step is captured (one card, or a mesh whose groups are
    all NCCL) a greedy, sampling or AR call loops on the device instead
    (``graphs.LoopGraph`` or a request graph's decode node, JAX's
    ``lax.while_loop``), with no overshoot
    and no read until the call's last; this loop serves streams, the paged
    engine and the scheduler's lanes, meshes with a gloo group, the CPU
    and ``graphs.eager()``."""
    generated = 0
    while True:
        run(host_batch(max_new - generated, per_step, kv_len, last_start))
        finished, n_conf, init_len, kv_len = (int(x) for x in graphs.fetch(
            torch.stack([state.finished.int(), state.n_confirmed,
                         state.init_len, state.kv_len])))
        if finished:
            return state
        generated = n_conf - init_len


def build_step_fns(mcfg: llama.LlamaConfig, lcfg: LookaheadConfig,
                   ecfg: EngineConfig, layout: Layout, device,
                   mesh=None) -> StepFns:
    """The step functions. On a ``mesh`` every forward runs on the rank's
    shards (``models/llama.py:forward``), and with ``ecfg.la > 1`` the
    composite decode step splits its rows over the mesh's la axis; the
    prefill chunks and the AR step run whole on every la rank, as in the
    JAX package. Every rank gets the same logits, so the state after each
    step is the same on every rank."""
    M = ecfg.max_seq_len
    split_rows = mesh is not None and ecfg.la > 1
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
    # dynamic-NTK keying (llama.rope_rows_dynamic): the prefill on the full
    # prompt length, as HF prefills in one call; every decode row on its
    # own position + 1, as HF's incremental decode, so that the lookahead
    # step stays token-exact against the AR baseline
    dyn = llama.is_dynamic_rope(mcfg)
    rel_pos = torch.from_numpy(layout.rel_pos).to(device)
    # composite rows whose logits are read: row 0 (next token), the newest
    # window level and the verification branch
    logits_rows = torch.from_numpy(np.concatenate([
        np.array([0]), np.arange(layout.inp_start, layout.inp_stop),
        np.arange(layout.guess_start, layout.seq_len)])).to(device)
    no_rows = torch.zeros(0, dtype=torch.long, device=device)
    chunk_rows = torch.arange(C, device=device)     # a prefill chunk's rows
    # the attention's visibility (ops/lookahead_attention.py), computed by
    # the kernel or the plain version from kv_len on the device
    meta = dict(level=N, window=W, guess_size=GS, sliding_window=SW)
    impl = "kernel" if lcfg.attention_impl == "kernel" else "dense"
    posts = {mode: make_post_forward(mcfg, lcfg, layout, device, mode)
             for mode in ("greedy", "sample")}

    # ------------------------------------------------------------------
    def init_state(state: DecodeState, out_buf, prompt_len) -> DecodeState:
        """A request's output buffer (``out_buf`` [M + GS], the prompt and
        zeros, on the device: a flat slot's uploaded arguments, see
        ``graphs.upload_into``), its window seeded at steady-state level
        sizes by ``window_init`` from the state's stream
        (:func:`seed_window`; the caller has written ``key`` and zeroed
        ``draws``), and its counters, written into ``state`` in place; the
        caches and the pool are the caller's. ``prompt_len`` is a 0-d
        int32 tensor on the device (a flat slot's: so the request graph
        reads each request's own, and nothing of it is host data) or an
        integer."""
        out_buf = state.out_buf.copy_(out_buf)
        state.window.copy_(seed_window(lcfg, mcfg.vocab_size, n_window,
                                       out_buf, state.key, state.draws,
                                       prompt_len))
        state.kv_len.fill_(0)
        for counter in (state.n_confirmed, state.init_len):
            if isinstance(prompt_len, torch.Tensor):
                counter.copy_(prompt_len)
            else:
                counter.fill_(prompt_len)
        state.step_idx.fill_(0)
        state.finished.fill_(False)
        return state

    # ------------------------------------------------------------------
    def prefill_chunk(params, state: DecodeState, start0: torch.Tensor,
                      chunk: torch.Tensor) -> DecodeState:
        """Chunk ``chunk`` of :func:`prefill_from` in place, then
        ``chunk += 1``: the body of JAX's prefill ``fori_loop``. ``start0``
        and ``chunk`` are 0-d int32 tensors on the device and the chunk
        reads its start from them, ``min(start0 + chunk * C, max(n - C,
        0))`` with ``n = init_len - 1``, and its tokens from ``out_buf``
        through a device index: nothing of it is host data, so one
        captured chunk replays every chunk of every prompt. The prompt's
        K/V go into the cache at that start (causal), and ``kv_len`` is
        ``min(start + C, n)``."""
        n = state.init_len - 1
        start = torch.minimum(start0 + chunk * C, (n - C).clamp(min=0))
        positions = start + chunk_rows
        llama.forward(params, mcfg, state.out_buf.index_select(0, positions),
                      positions, state.k_cache, state.v_cache, start,
                      rope_cos, rope_sin,
                      dict(meta, causal=True, kv_len=start.view(1)),
                      logits_rows=no_rows, attn_impl=impl,
                      rope_seq_len=state.init_len, mesh=mesh)
        state.kv_len.copy_(torch.minimum(start + C, n))
        chunk.add_(1)
        return state

    def prefill_from(params, state: DecodeState, counters,
                     run) -> DecodeState:
        """prompt[start0:-1] in C-sized chunks (JAX's ``prefill_from``);
        ``start0 > 0`` is the prefix path, whose rows [0, start0) are
        already in the caches. The last chunk is aligned to end at the
        prompt (start = n - C) and may rewrite a few prefix rows (K/V depend
        on the position alone, so the rewrite changes nothing), and a
        prompt shorter than C pads within [0, C), whose tail slots stay
        masked until overwritten. ``counters`` are the (start0, chunk,
        chunks) int32 tensors on the device: ``start0``, the caller's, and
        ``chunk``, which this call zeroes, are what each chunk reads its
        start from (:func:`prefill_chunk`); ``chunks`` takes the chunk
        count, ``max(ceil((init_len - 1 - start0) / C), 0)``, computed on
        the device from the prompt's length in the state, as JAX's
        ``fori_loop`` computes its trip count from the traced length.
        ``run()`` then runs that many chunks: a WHILE node whose cap is
        ``chunks`` (the engine's request graph), or the host's own count of
        chunks, replays of the captured chunk or eager calls. ``kv_len``
        ends at ``max(n, 0)``."""
        first, chunk, chunks = counters
        chunk.zero_()
        chunks.copy_(((state.init_len - 1 - first).clamp(min=0) + (C - 1))
                     // C)
        run()
        state.kv_len.copy_((state.init_len - 1).clamp(min=0))
        return state

    # ------------------------------------------------------------------
    def step(params, state: DecodeState, max_new, eos_id, mode: str,
             warp: dict) -> DecodeState:
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
            logits_rows=logits_rows, attn_impl=impl,
            rope_seq_len=positions + 1 if dyn else None, mesh=mesh,
            split_rows=split_rows)

        lanes = _as_lanes(state)
        updates, winner, max_hit = posts[mode](
            lanes, logits[None], guesses[None], guess_valid[None], lst, prev,
            max_new, eos_id[None], M, **warp)
        updates = {name: new[0] for name, new in updates.items()}
        winner = winner[0]

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
        return keep_if_finished(state, updates)

    def decode_step(params, state: DecodeState, max_new,
                    eos_id) -> DecodeState:
        """One greedy step of ``state``, in place. ``max_new`` is an int or
        a 0-d int32 tensor (a captured step reads the engine's buffer, so
        each call may set its own); ``eos_id`` [n_eos] int32, pad -1."""
        return step(params, state, max_new, eos_id, "greedy", {})

    def sample_step(params, state: DecodeState, max_new, eos_id,
                    temperature: torch.Tensor, top_p=None,
                    top_k: int = 0) -> DecodeState:
        """One sampling step, as :func:`decode_step`: ``temperature`` a [1]
        tensor, ``top_p`` a [1] tensor or None (off, no sort), ``top_k`` an
        int (0: off)."""
        return step(params, state, max_new, eos_id, "sample",
                    dict(temperature=temperature, top_p=top_p, top_k=top_k))

    # ------------------------------------------------------------------
    # Autoregressive baseline: one token a step. Attention is causal mode
    # with one query row at kv_len: JAX's dense mask col <= kv_len.
    def baseline_step(params, s: DecodeState, max_new,
                      eos_id) -> DecodeState:
        kv_len = s.kv_len
        lst = s.out_buf.index_select(0, (s.n_confirmed - 1).long().view(1))
        logits, _, _ = llama.forward(
            params, mcfg, lst, kv_len.view(1), s.k_cache, s.v_cache, kv_len,
            rope_cos, rope_sin, dict(meta, causal=True, kv_len=kv_len.view(1)),
            attn_impl=impl, rope_seq_len=kv_len.view(1) + 1 if dyn else None,
            mesh=mesh)
        nxt = logits[0].argmax().int().view(1)
        _append(s.out_buf, s.n_confirmed, nxt, s.finished)
        n_confirmed = s.n_confirmed + 1
        finished = (s.finished | (nxt == eos_id).any()
                    | (n_confirmed - s.init_len >= max_new)
                    | (kv_len + 2 > M))
        return keep_if_finished(s, dict(
            kv_len=kv_len + 1, n_confirmed=n_confirmed,
            step_idx=s.step_idx + 1, finished=finished))

    return StepFns(
        init_state=init_state,
        prefill_chunk=prefill_chunk,
        prefill_from=prefill_from,
        decode_step=decode_step,
        sample_step=sample_step,
        baseline_step=baseline_step,
    )
