"""The greedy lookahead step over the paged KV pool (core/paged.py).

The decode semantics (verification, EOS, pool harvest, window slide) are
those of the flat-cache step: both call ``core/step.py:make_post_forward``,
which takes a leading lane axis. This module only changes how KV is
addressed: B lanes write and commit through their page tables into one
shared physical pool, batched in one step
(``models/llama.py:forward_paged``). A finished lane's step changes
nothing: its bookkeeping is selected back, its pool update and output
append are masked, and its accept-commit goes to its own trash page, never
to a page another lane owns.

The state and the pools are updated in place, and a step reads nothing
back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple

import numpy as np
import torch

from ..config import EngineConfig, LookaheadConfig
from ..models import llama
from .layout import Layout
from .paged import paged_commit, phys_slots
from .pool import PoolState, bigram_key, pool_lookup, pool_table_rows
from .step import make_post_forward


@dataclasses.dataclass
class PagedLaneState:
    """Decode bookkeeping of B lanes, every field with a leading lane axis;
    the KV itself lives in the shared pool. The fields of
    ``core/state.py:DecodeState`` without the cache buffers, plus each
    lane's page table, its allocated logical capacity and its trash page."""

    table: torch.Tensor        # [B, NB] int32 logical -> physical page
    cap: torch.Tensor          # [B] int32: allocated logical slot capacity
    trash: torch.Tensor        # [B] int32: base slot of the lane's trash page
    kv_len: torch.Tensor       # [B] int32
    window: torch.Tensor       # [B, n_window] int32
    pool: PoolState            # stacked: [B, R+1, G, GS], [B, R+1, G], [B]
    out_buf: torch.Tensor      # [B, M + GS] int32
    n_confirmed: torch.Tensor  # [B] int32
    init_len: torch.Tensor     # [B] int32
    step_idx: torch.Tensor     # [B] int32
    finished: torch.Tensor     # [B] bool
    rng: List[torch.Generator]  # one a lane


class PagedStepFns(NamedTuple):
    init_lane: Callable
    prefill_from: Callable    # one lane's suffix prefill into the pool
    decode_batch: Callable    # one batched greedy step over all lanes
    sample_batch: Callable    # one batched sampling step (not ported yet)


def build_paged_step_fns(mcfg: llama.LlamaConfig, lcfg: LookaheadConfig,
                         ecfg: EngineConfig, layout: Layout, page_size: int,
                         device) -> PagedStepFns:
    M = ecfg.max_seq_len
    S, W, N = layout.seq_len, layout.window, layout.level
    G, GS = layout.guess_set_size, layout.guess_size
    n_window = layout.n_window
    C = ecfg.prefill_chunk
    NB = -(-M // page_size)
    MLOG = NB * page_size
    if page_size < GS:
        raise ValueError(
            f"page_size ({page_size}) must be >= guess_size ({GS}) so the "
            "accept-commit's trash redirect fits one page")

    SW = mcfg.sliding_window or 0
    if SW >= MLOG:
        SW = 0

    rope_cos, rope_sin = llama.rope_tables(mcfg, MLOG + C, device)
    rel_pos = torch.from_numpy(layout.rel_pos).to(device)
    logits_rows = torch.from_numpy(np.concatenate([
        np.array([0]), np.arange(layout.inp_start, layout.inp_stop),
        np.arange(layout.guess_start, layout.seq_len)])).to(device)
    no_rows = torch.zeros(0, dtype=torch.long, device=device)
    meta = dict(level=N, window=W, guess_size=GS, sliding_window=SW)
    impl = "kernel" if lcfg.attention_impl == "kernel" else "dense"
    post = make_post_forward(mcfg, lcfg, layout, device)
    rows = pool_table_rows(mcfg.vocab_size, lcfg.pool_key_len,
                           lcfg.pool_hash_size)

    # ------------------------------------------------------------------
    def init_lane(states: PagedLaneState, lane: int, table, cap: int,
                  out_buf, prompt_len: int, rng: torch.Generator):
        """Lane ``lane`` of ``states`` set up for a new request, in place:
        the counterpart of ``core/step.py:init_state``. ``table`` [NB] and
        ``out_buf`` [M + GS] are device tensors; the lane's n-gram pool is
        left as the caller prepared it."""
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
        states.table[lane] = table
        states.cap[lane] = cap
        states.kv_len[lane] = 0
        states.window[lane] = window
        states.out_buf[lane] = out_buf
        states.n_confirmed[lane] = prompt_len
        states.init_len[lane] = prompt_len
        states.step_idx[lane] = 0
        states.finished[lane] = False
        states.rng[lane] = rng
        return states

    # ------------------------------------------------------------------
    def prefill_from(params, pools, table, trash: int, out_buf,
                     prompt_len: int, start0: int) -> int:
        """prompt[start0:-1] of one lane into the pool (causal, one-lane
        forwards of C tokens), through ``table`` [NB]. Unlike the flat
        prefill, chunks never start below the suffix start (shared prefix
        pages are read-only) and never write past the prompt: the last
        chunk pads past it, and the padded rows' K/V go to the lane's trash
        page. The prompt length is host data, so the chunk starts are host
        ints. Returns the lane's ``kv_len`` after the prefill."""
        k_pool, v_pool = pools
        n = prompt_len - 1
        tables = table[None]
        limit = torch.tensor([n], dtype=torch.int32, device=device)
        trash_slot = torch.tensor([trash], dtype=torch.int32, device=device)
        for start in range(start0, n, C):
            tokens = out_buf[start:start + C]
            if tokens.shape[0] < C:     # the buffer ends inside the chunk
                tokens = torch.cat([tokens, tokens.new_zeros(
                    C - tokens.shape[0])])
            kv_lens = torch.tensor([start], dtype=torch.int32, device=device)
            positions = start + torch.arange(C, device=device)
            llama.forward_paged(
                params, mcfg, tokens[None], positions[None], k_pool, v_pool,
                tables, kv_lens, page_size, rope_cos, rope_sin,
                dict(meta, causal=True, kv_lens=kv_lens),
                logits_rows=no_rows, attn_impl=impl, write_limit=limit,
                trash_slot=trash_slot)
        return max(n, 0)

    # ------------------------------------------------------------------
    def decode_batch(params, k_pool, v_pool, states: PagedLaneState,
                     max_new, eos_id) -> PagedLaneState:
        """One lookahead step for all lanes against the shared pool.
        ``max_new`` [B] int32; ``eos_id`` [B, n_eos] int32."""
        kv_lens = states.kv_len
        nc = states.n_confirmed.long()
        lst = states.out_buf.gather(1, (nc - 1)[:, None])[:, 0]
        if lcfg.pool_key_len == 2:
            prev = states.out_buf.gather(
                1, (nc - 2).clamp(min=0)[:, None])[:, 0]
            lookup_key = bigram_key(prev, lst, rows)
        else:
            prev = lookup_key = lst
        guesses, guess_valid = pool_lookup(states.pool, lookup_key)
        b = lst.shape[0]
        tokens = torch.cat([lst[:, None], states.window,
                            guesses.reshape(b, -1)], dim=1)
        positions = kv_lens[:, None] + rel_pos

        logits, _, _ = llama.forward_paged(
            params, mcfg, tokens, positions, k_pool, v_pool, states.table,
            kv_lens, page_size, rope_cos, rope_sin,
            dict(meta, kv_lens=kv_lens), logits_rows=logits_rows,
            attn_impl=impl, trash_slot=states.trash)

        fin = states.finished
        updates, winner, _ = post(states, logits, guesses, guess_valid, lst,
                                  prev, max_new, eos_id, states.cap)

        # Accept-commit on the shared pool: the winning n-gram's rows move
        # to the slots right after lst's, through the lane's table (gather,
        # then scatter: the spans may overlap). Lanes that entered the step
        # finished send both ends to their trash page.
        if G > 0:
            src_log = kv_lens + layout.guess_start + winner.int() * GS
            src = phys_slots(states.table, src_log, GS, page_size,
                             trash=states.trash)
            dst = phys_slots(states.table, kv_lens + 1, GS, page_size,
                             trash=states.trash)
            trash = (states.trash.long()[:, None]
                     + torch.arange(GS, device=device))
            src = torch.where(fin[:, None], trash, src).reshape(-1)
            dst = torch.where(fin[:, None], trash, dst).reshape(-1)
            paged_commit(k_pool, src, dst)
            paged_commit(v_pool, src, dst)

        # finished lanes keep their bookkeeping (the flat step's
        # _keep_if_finished, as a select over the lane axis)
        for name, new in updates.items():
            old = getattr(states, name)
            keep = fin.view(-1, *([1] * (old.dim() - 1)))
            setattr(states, name, torch.where(keep, old, new))
        return states

    def sample_batch(*args, **kwargs):
        raise NotImplementedError(
            "the paged engine's sampling step needs ops/sampling.py, which "
            "is not ported yet (ROADMAP.md queue A, item A7)")

    return PagedStepFns(init_lane=init_lane, prefill_from=prefill_from,
                        decode_batch=decode_batch, sample_batch=sample_batch)
