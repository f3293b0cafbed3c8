"""Paged (block-table) KV cache: a shared physical page pool and per-lane
logical -> physical page tables.

Instead of every serving lane and every cached prefix pinning a
full-capacity ``[L, Hkv, max_seq, D]`` buffer (2 * L * Hkv * max_seq * D
values: 32 layers x 32 heads x 2048 slots x 128 x 2 bytes x 2 = ~1.07 GB in
bf16 for Llama-2-7B), all sequences share one physical pool of fixed-size
pages:

    pool K/V : [L, Hkv, n_pages * page_size, D]   (q's dtype, or int8 values
               with float32 scales [L, Hkv, n_pages * page_size, 1])
    table    : [NB] int32 per lane: logical page j lives in physical page
               table[j]; NB = ceil(max_seq_len / page_size)

so a lane holds exactly ``ceil((prompt + max_new + S) / page_size)`` pages,
a cached prefix holds its own pages (sharing is a reference count, not a
copy), and admission waits for free pages instead of running out of memory.

Speculative append and rollback are those of the flat cache (core/step.py):
each decode step writes the S composite tokens at logical slots [kv_len,
kv_len + S), whose pages are always allocated (``pages_needed`` counts the
composite overhang); the accept-commit copies the winning n-gram's span to
[kv_len + 1, kv_len + 1 + max_hit] and kv_len moves. Rejected speculation
needs no undo, because slots >= kv_len are scratch by contract.

Page lifecycle (the host-side ``BlockAllocator``): pages [0, num_lanes) are
reserved as per-lane trash pages. An idle or finished lane's table points
every logical page at its own trash page, so the unconditional writes of
the batched step land in garbage that only that lane owns (the paged
counterpart of the n-gram pool's trash row). Allocation is whole-request
and up-front; a shared prefix's pages are reference-counted, and the page
the admitted lane will write into is copied first (copy-on-write).

The pools are written in place.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Physical pool
# ---------------------------------------------------------------------------

def make_paged_pool(cfg, n_pages: int, page_size: int, device="cuda",
                    quant: Optional[str] = None):
    """Shared physical K and V pools [L, Hkv, n_pages*page_size, D], zeroed;
    ``quant="int8"`` gives ``{"q", "s"}`` dicts as
    ``models/llama.py:make_kv_cache`` does (scales filled with 1e-8)."""
    p = n_pages * page_size
    shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, p, cfg.head_dim)
    if quant is None:
        return (torch.zeros(shape, dtype=cfg.dtype, device=device),
                torch.zeros(shape, dtype=cfg.dtype, device=device))
    if quant != "int8":
        raise ValueError(f"unsupported kv quantization: {quant}")

    def make():
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.full(shape[:-1] + (1,), 1e-8, dtype=torch.float32,
                                device=device)}
    return make(), make()


def _leaves(buf):
    """The tensors of a plain buffer or of an int8 ``{"q", "s"}`` dict."""
    return list(buf.values()) if isinstance(buf, dict) else [buf]


# ---------------------------------------------------------------------------
# Device-side address translation
# ---------------------------------------------------------------------------

def phys_slots(tables: torch.Tensor, start, length: int, page_size: int,
               trash: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Physical slot ids of the logical span [start, start+length).

    tables [B, NB] with start [B], or tables [NB] with a scalar start;
    returns [B, length] (or [length]) int64 indices. A logical slot outside
    the table (a step taken by a lane that has stopped at its capacity) has
    no page: with ``trash`` ([B] or scalar, the base slot of the lane's
    trash page) it goes to that page, else its page index is clamped into
    the table. Either way no index leaves the pool, which on a CUDA device
    would be an assert."""
    batched = tables.dim() == 2
    if not batched:
        tables = tables[None]
        start = torch.as_tensor(start, device=tables.device).reshape(1)
        if trash is not None:
            trash = torch.as_tensor(trash, device=tables.device).reshape(1)
    nb = tables.shape[1]
    m = start.long()[:, None] + torch.arange(length, device=tables.device)
    page_idx = torch.div(m, page_size, rounding_mode="floor")
    page = tables.long().gather(1, page_idx.clamp(0, nb - 1))
    out = page * page_size + m % page_size
    if trash is not None:
        outside = (page_idx < 0) | (page_idx >= nb)
        out = torch.where(outside, trash.long()[:, None] + m % page_size, out)
    return out if batched else out[0]


def paged_write(buf, slots_flat: torch.Tensor, new_flat: torch.Tensor):
    """Scatter new K or V rows into one layer's pool slice, in place.

    buf [Hkv, P, D] (or an int8 ``{"q", "s"}`` dict); slots_flat [R]
    physical slots; new_flat [R, Hkv, D]. The int8 branch quantizes as
    ``models/llama.py:kv_cache_write`` does (scale
    ``max(amax * float32(1 / 127), 1e-8)``, what XLA compiles the JAX
    package's ``amax / 127.0`` to inside its jitted step; a true division,
    round half to even, clip to +-127). Duplicate slots occur only inside
    trash pages, where the order of the writes does not matter."""
    if isinstance(buf, dict):
        nf = new_flat.float()
        s = (nf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0)).clamp_min(1e-8)
        qv = torch.round(nf / s).clamp_(-127, 127).to(torch.int8)
        paged_write(buf["q"], slots_flat, qv)
        paged_write(buf["s"], slots_flat, s)
        return buf
    buf.index_copy_(1, slots_flat, new_flat.transpose(0, 1).to(buf.dtype))
    return buf


def paged_gather(buf, tables: torch.Tensor, page_size: int):
    """Contiguous logical view of each lane's cache, for the plain attention
    (and the tests): buf [Hkv, P, D] (or an int8 dict), tables [B, NB];
    returns [B, Hkv, NB*page_size, D] (dict: q and s). A copy; the kernel
    reads the pages where they lie instead."""
    b, nb = tables.shape
    idx = (tables.long()[:, :, None] * page_size
           + torch.arange(page_size, device=tables.device)).reshape(
               b, nb * page_size)

    def one(a):
        return a[:, idx].transpose(0, 1)
    if isinstance(buf, dict):
        return {name: one(a) for name, a in buf.items()}
    return one(buf)


def paged_commit(buf, src_flat: torch.Tensor, dst_flat: torch.Tensor):
    """Accept-commit on the shared pool, in place: copy the rows at physical
    slots ``src_flat`` to ``dst_flat`` in all layers. buf [L, Hkv, P, D] or
    the int8 dict; slots [R], already flattened over the lanes. The source
    rows are gathered before anything is written, since a lane's two spans
    may overlap."""
    for a in _leaves(buf):
        a.index_copy_(2, dst_flat, a.index_select(2, src_flat))
    return buf


def copy_page(pools, src_page: int, dst_page: int, page_size: int):
    """Copy-on-write of one physical page (K and V pools, all layers), in
    place: a lane admitted on a shared prefix copies the page it will write
    into to a page of its own first."""
    src, dst = src_page * page_size, dst_page * page_size
    for pool in pools:
        for a in _leaves(pool):
            a[:, :, dst:dst + page_size] = a[:, :, src:src + page_size]
    return pools


# ---------------------------------------------------------------------------
# Host-side page allocator
# ---------------------------------------------------------------------------

class OutOfPages(Exception):
    """Raised by ``alloc`` when the pool cannot satisfy a request; the
    serving scheduler catches it and keeps the request queued."""


class BlockAllocator:
    """Reference-counted free-list allocator over the physical pages.

    On the host by design: allocation happens at admission, which is a host
    decision already, so the device only ever sees finished tables. Pages
    [0, reserved) are the per-lane trash pages and are never handed out."""

    def __init__(self, n_pages: int, reserved: int = 0):
        if n_pages <= reserved:
            raise ValueError("pool needs more pages than reserved trash")
        self.n_pages = n_pages
        self.reserved = reserved
        self._free: List[int] = list(range(n_pages - 1, reserved - 1, -1))
        self._refs = np.zeros((n_pages,), np.int32)
        self._refs[:reserved] = 1          # trash pages: held for ever

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - self.reserved - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages, {len(self._free)} free "
                f"(pool: {self.n_pages}, reserved: {self.reserved})")
        pages = [self._free.pop() for _ in range(n)]
        self._refs[pages] = 1
        return pages

    def share(self, pages: List[int]) -> None:
        """One more reference to each page: prefix sharing."""
        for p in pages:
            assert self._refs[p] > 0, f"share of unallocated page {p}"
            self._refs[p] += 1

    def release(self, pages: List[int]) -> None:
        for p in pages:
            assert self._refs[p] > 0, f"double free of page {p}"
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)


def pages_needed(prompt_len: int, max_new: int, s_len: int,
                 page_size: int, max_seq_len: int, prefix_len: int = 0):
    """Logical pages a request must own beyond any shared prefix pages.

    The logical extent a lane touches is ``kv_len_final + S``: the composite
    writes and the accept-commit stay inside it, prefill writes stay below
    the prompt (padded tail rows go to the trash page), and ``kv_len_final
    <= prompt - 1 + max_new``. The extent is clamped to ``max_seq_len``, so
    the lane's capacity stop is the flat engine's (``new_kv_len + S > M``)
    when generation runs to the logical bound.

    Returns ``(n_private_pages, first_page)``: the pages the lane owns,
    from logical page ``first_page`` (the page that holds slot
    ``prefix_len``, copied when the prefix ends inside it)."""
    extent = min(prompt_len - 1 + max_new + s_len, max_seq_len)
    first_page = prefix_len // page_size
    return -(-(extent - first_page * page_size) // page_size), first_page
