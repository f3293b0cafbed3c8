"""Device-resident n-gram pool with LRU semantics.

The same tables as ``lookaheaddecoding_tpu.core.pool``:

  values [R+1, G, GS] int32 : candidate n-grams per key row
  age    [R+1, G]     int32 : LRU stamps; 0 = empty slot
  clock  0-d          int32 : logical time

Row R is a write-only trash row: updates of invalid lanes go there, so an
update never branches on the data. Inserting an n-gram refreshes the age
of the slot that holds it, else fills the empty or least-recently-used
slot (the first such slot on ties).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PoolState:
    values: torch.Tensor   # [R+1, G, GS] int32
    age: torch.Tensor      # [R+1, G] int32
    clock: torch.Tensor    # 0-d int32


def pool_init(table_rows: int, guess_set_size: int, guess_size: int,
              device="cuda") -> PoolState:
    return PoolState(
        values=torch.zeros((table_rows + 1, guess_set_size, guess_size),
                           dtype=torch.int32, device=device),
        age=torch.zeros((table_rows + 1, guess_set_size), dtype=torch.int32,
                        device=device),
        clock=torch.ones((), dtype=torch.int32, device=device),
    )


_BIGRAM_PRIME = 1000003


def pool_table_rows(vocab_size: int, key_len: int, hash_size: int = 0) -> int:
    """Key rows (trash row excluded): one per token for key_len=1, a hashed
    bigram space for key_len=2."""
    if key_len == 1:
        return vocab_size
    return hash_size or min(4 * vocab_size, 262144)


def bigram_key(a: torch.Tensor, b: torch.Tensor, table_rows: int) -> torch.Tensor:
    """Hash of the (second-to-last, last) token pair into the key table, in
    uint32 arithmetic as the JAX package does it: int64 with the product
    and the sum wrapped to 32 bits."""
    mask = 0xFFFFFFFF
    h = ((a.long() & mask) * _BIGRAM_PRIME + (b.long() & mask)) & mask
    return (h % table_rows).int()


def pool_update(pool: PoolState, keys: torch.Tensor, tups: torch.Tensor,
                valid: torch.Tensor) -> PoolState:
    """Insert K (key, n-gram) lanes in lane order, in place; invalid lanes
    are no-ops. Returns ``pool`` with the clock advanced by K.

    Lanes that share a key must see the edits of the earlier ones. JAX
    chooses a sequential chain or a parallel insert with ``lax.cond``; in
    eager PyTorch that choice would read the device from the host. Here
    every lane gets its rank among the earlier lanes of its key, and K
    rounds each insert the lanes of one rank, each into the working row of
    the previous lane of its key (its ``prev_same``). The last lane of each
    key writes back, all keys in one ``index_put_``; the others write to
    the trash row. Only the trash row can receive duplicate indices, whose
    order ``index_put_`` does not fix on CUDA, so rows [0, R) are exact."""
    k_lanes = keys.shape[0]
    g, gs = pool.age.shape[1], pool.values.shape[2]
    if g == 0 or k_lanes == 0:
        return pool
    dev = keys.device
    trash = pool.values.shape[0] - 1
    keys = torch.where(valid, keys.long(), trash)
    lane = torch.arange(k_lanes, device=dev)
    same = keys[None, :] == keys[:, None]                    # [K, K]
    earlier = same & (lane[None, :] < lane[:, None])         # j < i, same key
    prev_same = torch.where(earlier, lane[None, :], -1).amax(dim=1)
    rank = earlier.sum(dim=1)
    is_last = ~(same & (lane[None, :] > lane[:, None])).any(dim=1)
    src = torch.where(prev_same >= 0, prev_same, lane)

    # working rows: n-gram tokens with the age as one more column
    work = torch.cat([pool.values[keys], pool.age[keys][..., None]], dim=-1)
    entry = torch.cat([tups.int(), (pool.clock + lane.int())[:, None]],
                      dim=-1)                                # [K, GS+1]
    slot_id = torch.arange(g, device=dev)
    in_round = rank[None, :] == torch.arange(k_lanes, device=dev)[:, None]
    big = torch.iinfo(torch.int32).max
    for r in range(k_lanes):
        row = work[src]                                      # [K, G, GS+1]
        match = ((row[..., :gs] == entry[:, None, :gs]).all(dim=-1)
                 & (row[..., gs] > 0))
        # the matching slot, else the first empty or oldest one
        slot = torch.where(match, big, -row[..., gs]).argmax(dim=-1)
        sel = in_round[r]
        put = (slot_id[None, :] == slot[:, None]) & sel[:, None]
        work = torch.where(put[..., None], entry[:, None, :],
                           torch.where(sel[:, None, None], row, work))

    dest = torch.where(is_last, keys, trash)
    pool.values.index_put_((dest,), work[..., :gs])
    pool.age.index_put_((dest,), work[..., gs])
    pool.clock = pool.clock + k_lanes
    return pool


def pool_lookup(pool: PoolState, key: torch.Tensor):
    """Candidate n-grams for a one-element ``key`` tensor: ([G, GS] tokens,
    [G] validity). Indexes with a 1-d tensor, which needs no host read."""
    idx = key.reshape(1).long()
    return pool.values[idx][0], pool.age[idx][0] > 0


def host_prompt_fill(prompt_tokens, level: int, guess_set_size: int,
                     pad_to: int, key_len: int = 1, table_rows: int = 0):
    """Prompt-seeded pool rows computed on the host: every n-gram of the
    prompt in order, with dedupe-refresh and a G cap per key. Returns
    (keys [pad_to], rows [pad_to, G, GS], ages [pad_to, G], clock) as numpy;
    unused lanes carry key -1."""
    gs = level - 1
    g = guess_set_size
    toks = [int(t) for t in prompt_tokens]
    table = {}
    clock = 1
    start = 0 if key_len == 1 else 1
    for i in range(start, len(toks) - gs):
        if key_len == 2:
            key = int(((toks[i - 1] * _BIGRAM_PRIME + toks[i]) % (1 << 32))
                      % table_rows)
        else:
            key = toks[i]
        tup = tuple(toks[i + 1:i + 1 + gs])
        ent = table.setdefault(key, [])
        for j, (t2, _) in enumerate(ent):
            if t2 == tup:
                del ent[j]
                break
        else:
            if len(ent) == g:
                ent.pop(0)
        ent.append((tup, clock))
        clock += 1

    keys = np.full((pad_to,), -1, np.int32)
    rows = np.zeros((pad_to, g, gs), np.int32)
    ages = np.zeros((pad_to, g), np.int32)
    for u, (key, ent) in enumerate(table.items()):
        if u >= pad_to:
            break
        keys[u] = key
        for slot, (tup, age) in enumerate(ent):
            rows[u, slot] = tup
            ages[u, slot] = age
    return keys, rows, ages, clock


def apply_host_fill(pool: PoolState, keys, rows, ages, clock) -> PoolState:
    """Write host-computed fill rows in one scatter, in place (lanes with
    key -1 go to the trash row). Ages and the clock are offset by the
    pool's clock, so logical time never runs backwards; empty slots stay 0.
    Each fill row replaces its key's row; the merging form belongs to the
    prefix path, which is not ported yet."""
    dev = pool.values.device
    trash = pool.values.shape[0] - 1
    keys = torch.as_tensor(np.where(np.asarray(keys) < 0, trash, keys),
                           dtype=torch.long).to(dev)
    ages = torch.as_tensor(np.asarray(ages), dtype=torch.int32).to(dev)
    pool.values.index_put_((keys,), torch.as_tensor(
        np.asarray(rows), dtype=torch.int32).to(dev))
    pool.age.index_put_((keys,), torch.where(ages > 0, ages + pool.clock, 0))
    pool.clock = pool.clock + int(clock)
    return pool
