"""The lookahead step (greedy and sampling) over the paged KV pool
(core/paged.py).

The decode semantics (verification, EOS, pool harvest, window slide) are
those of the flat-cache step: both call ``core/step.py:make_post_forward``,
which takes a leading lane axis. This module only changes how KV is
addressed: B lanes write and commit through their page tables into one
shared physical pool, batched in one step
(``models/llama.py:forward_paged``). A finished lane's step changes
nothing: its bookkeeping is selected back, its pool update and output
append are masked, and its accept-commit goes to its own trash page, never
to a page another lane owns.

The state and the pools are updated in place (every field keeps its
address, so the engines can replay the step as a CUDA graph), and a step
reads nothing back to the host.

A lane's prefill (JAX's ``prefill_from``, a ``fori_loop`` of
``prefill_chunk_lane``) is one chunk that reads every input from a
:class:`PagedAdmission` record on the device, its start from the record's
counters, and advances them: the paged engine replays one captured chunk a
chunk, for every prompt and every lane.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import EngineConfig, LookaheadConfig
from ..models import llama
from ..ops import philox
from .layout import Layout
from .paged import paged_commit, phys_slots
from .pool import PoolState, bigram_key, pool_lookup, pool_table_rows
from .step import keep_if_finished, make_post_forward, seed_window


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
    key: torch.Tensor          # [B, 2] int32: each lane's stream's seed
    draws: torch.Tensor        # [B] int64: the draws each lane has made


@dataclasses.dataclass
class PagedAdmission:
    """One admission at fixed addresses: what the prefill chunk reads (the
    lane's page table, its trash slot, its output buffer and the prompt's
    length), what it writes (``kv_len``) and its counters (``start0``, the
    first row, and ``chunk``, the chunk under way). An engine owns one and
    writes each admission into it in place."""

    table: torch.Tensor        # [1, NB] int32
    trash: torch.Tensor        # [1] int32: base slot of a trash page
    out_buf: torch.Tensor      # [M + GS] int32: the prompt, then zeros
    init_len: torch.Tensor     # 0-d int32: the prompt's length
    kv_len: torch.Tensor       # 0-d int32
    start0: torch.Tensor       # 0-d int32
    chunk: torch.Tensor        # 0-d int32


def new_admission(n_pages: int, buf_len: int, device) -> PagedAdmission:
    """An admission record of ``n_pages`` table entries and an output
    buffer of ``buf_len`` tokens, zeros, on ``device``."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return PagedAdmission(table=zeros(1, n_pages), trash=zeros(1),
                          out_buf=zeros(buf_len), init_len=zeros() + 1,
                          kv_len=zeros(), start0=zeros(), chunk=zeros())


class PagedStepFns(NamedTuple):
    init_lane: Callable
    prefill_chunk: Callable   # one chunk of a lane's prefill, in place
    prefill_from: Callable    # one lane's suffix prefill into the pool
    decode_batch: Callable    # one batched greedy step over all lanes
    sample_batch: Callable    # one batched sampling step over all lanes


def build_paged_step_fns(mcfg: llama.LlamaConfig, lcfg: LookaheadConfig,
                         ecfg: EngineConfig, layout: Layout, page_size: int,
                         device, mesh=None) -> PagedStepFns:
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
    # dynamic-NTK keying as in core/step.py: the prefill on the prompt
    # length, each decode row on its own position + 1
    dyn = llama.is_dynamic_rope(mcfg)
    rel_pos = torch.from_numpy(layout.rel_pos).to(device)
    logits_rows = torch.from_numpy(np.concatenate([
        np.array([0]), np.arange(layout.inp_start, layout.inp_stop),
        np.arange(layout.guess_start, layout.seq_len)])).to(device)
    no_rows = torch.zeros(0, dtype=torch.long, device=device)
    chunk_rows = torch.arange(C, device=device)     # a prefill chunk's rows
    meta = dict(level=N, window=W, guess_size=GS, sliding_window=SW)
    impl = "kernel" if lcfg.attention_impl == "kernel" else "dense"
    posts = {mode: make_post_forward(mcfg, lcfg, layout, device, mode)
             for mode in ("greedy", "sample")}
    rows = pool_table_rows(mcfg.vocab_size, lcfg.pool_key_len,
                           lcfg.pool_hash_size)

    # ------------------------------------------------------------------
    def init_lane(states: PagedLaneState, lane: int, rec: PagedAdmission,
                  cap: int, prompt_len: int, seed: int):
        """Lane ``lane`` of ``states`` set up for a new request, in place:
        the counterpart of ``core/step.py:init_state`` and of JAX's
        insertion of the new lane into the batched states
        (``dynamic_update_index_in_dim``). The lane's table and output
        buffer are copied from the admission record ``rec``; its stream's
        key becomes ``seed`` and its counter 0, in place (a captured step
        reads them where they lie), and its window is seeded from them
        (``core/step.py:seed_window``); its n-gram pool is left as the
        caller prepared it."""
        philox.start(states.key[lane], states.draws[lane], seed)
        states.window[lane] = seed_window(
            lcfg, mcfg.vocab_size, n_window, rec.out_buf, states.key[lane],
            states.draws[lane], prompt_len)
        # host numbers go in by fill_ (an item assignment of a Python
        # number copies it to the card from pageable memory: a sync)
        states.table[lane].copy_(rec.table[0])
        states.cap[lane].fill_(cap)
        states.kv_len[lane].fill_(0)
        states.out_buf[lane] = rec.out_buf
        states.n_confirmed[lane].fill_(prompt_len)
        states.init_len[lane].fill_(prompt_len)
        states.step_idx[lane].fill_(0)
        states.finished[lane].fill_(False)
        return states

    # ------------------------------------------------------------------
    def prefill_chunk(params, pools, rec: PagedAdmission,
                      start0: torch.Tensor, chunk: torch.Tensor):
        """Chunk ``chunk`` of :func:`prefill_from` in place, then
        ``chunk += 1``: the body of JAX's prefill ``fori_loop``
        (``prefill_chunk_lane``), a causal one-lane forward of C tokens
        through ``rec.table``. Its start is ``start0 + chunk * C`` (0-d
        int32 tensors on the device). Unlike the flat chunk it is not
        aligned to end at the prompt: shared prefix pages are read-only.
        Its tokens come from ``rec.out_buf`` through a device index
        (clamped to the buffer; those rows are padding), and the rows at or
        past ``n = init_len - 1`` write their K/V to the trash page at
        ``rec.trash``. Nothing of it is host data, so one captured chunk
        serves every chunk of every prompt and every lane. ``rec.kv_len``
        becomes ``min(start + C, n)``. (No dynamic-NTK rows: the paged
        engine refuses that rope.)"""
        k_pool, v_pool = pools
        n = rec.init_len - 1
        start = start0 + chunk * C
        positions = start + chunk_rows
        tokens = rec.out_buf.index_select(
            0, positions.clamp(max=rec.out_buf.shape[0] - 1))
        kv_lens = start.view(1)
        llama.forward_paged(
            params, mcfg, tokens[None], positions[None], k_pool, v_pool,
            rec.table, kv_lens, page_size, rope_cos, rope_sin,
            dict(meta, causal=True, kv_lens=kv_lens), logits_rows=no_rows,
            attn_impl=impl, write_limit=n.view(1), trash_slot=rec.trash,
            mesh=mesh)
        rec.kv_len.copy_(torch.minimum(start + C, n))
        chunk.add_(1)
        return rec

    def prefill_from(params, pools, rec: PagedAdmission, prompt_len: int,
                     start0: int, counters, run) -> PagedAdmission:
        """prompt[start0:-1] of the lane in ``rec`` into the pool, in C-sized
        chunks (JAX's ``prefill_from``); ``start0 > 0`` is the prefix path,
        whose rows [0, start0) are already in the lane's pages. The prompt
        length is host data, as in JAX's caller, so the host knows the
        number of chunks; each chunk finds its start on the device
        (:func:`prefill_chunk`). ``counters`` are the (start0, chunk)
        tensors the chunks read, which this call sets; ``run(k)`` runs k
        chunks over them (the engine's runner: the captured chunk
        replayed, or the chunk called k times). ``rec.kv_len`` ends at
        ``max(n, 0)``."""
        first, chunk = counters
        first.fill_(start0)
        chunk.zero_()
        run(-(-max(prompt_len - 1 - start0, 0) // C))
        rec.kv_len.copy_((rec.init_len - 1).clamp(min=0))
        return rec

    # ------------------------------------------------------------------
    def batch_step(params, k_pool, v_pool, states: PagedLaneState, max_new,
                   eos_id, mode: str, warp: dict) -> PagedLaneState:
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
            attn_impl=impl, trash_slot=states.trash,
            rope_seq_len=positions + 1 if dyn else None, mesh=mesh)

        fin = states.finished
        updates, winner, _ = posts[mode](
            states, logits, guesses, guess_valid, lst, prev, max_new, eos_id,
            states.cap, **warp)

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

        # finished lanes keep their bookkeeping, written in place
        return keep_if_finished(states, updates)

    def decode_batch(params, k_pool, v_pool, states: PagedLaneState,
                     max_new, eos_id) -> PagedLaneState:
        """One greedy lookahead step for all lanes against the shared pool.
        ``max_new`` [B] int32; ``eos_id`` [B, n_eos] int32."""
        return batch_step(params, k_pool, v_pool, states, max_new, eos_id,
                          "greedy", {})

    def sample_batch(params, k_pool, v_pool, states: PagedLaneState,
                     max_new, eos_id, temperature, top_p=None,
                     top_k: int = 0) -> PagedLaneState:
        """One sampling step for all lanes: ``decode_batch`` with SpecInfer
        verification, ``temperature`` [B] float32, ``top_p`` [B] float32 or
        None (no lane asks for top-p) and an int ``top_k`` (0: off)."""
        return batch_step(params, k_pool, v_pool, states, max_new, eos_id,
                          "sample", dict(temperature=temperature, top_p=top_p,
                                         top_k=top_k))

    return PagedStepFns(init_lane=init_lane, prefill_chunk=prefill_chunk,
                        prefill_from=prefill_from, decode_batch=decode_batch,
                        sample_batch=sample_batch)
