"""Device-resident n-gram pool with LRU semantics.

The same tables as ``lookaheaddecoding_tpu.core.pool``:

  values [R+1, G, GS] int32 : candidate n-grams per key row
  age    [R+1, G]     int32 : LRU stamps; 0 = empty slot
  clock  0-d          int32 : logical time

The lanes of the paged serving engine keep their pools stacked on a leading
axis ([B, R+1, G, GS], [B, R+1, G], [B]); ``pool_update`` and
``pool_lookup`` take either form.

Row R is a write-only trash row: updates of invalid lanes go there, so
they need no branch of their own. Inserting an n-gram refreshes the age
of the slot that holds it, else fills the empty or least-recently-used
slot (the first such slot on ties).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import graphs


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


def _update_lanes(values, age, clock, keys, tups, valid):
    """The insert of :func:`pool_update` for B pools at once: values
    [B, R+1, G, GS], age [B, R+1, G] (both contiguous, written in place),
    clock [B]; keys [B, K], tups [B, K, GS], valid [B, K]. The B tables are
    addressed as one table of B*(R+1) rows, a pool's keys offset by its
    index, so the rounds are shared by all pools. Returns the clocks
    advanced by K."""
    b, k_lanes = keys.shape
    n_rows, g, gs = values.shape[1:]
    dev = keys.device
    trash = n_rows - 1
    keys = torch.where(valid, keys.long(), trash)
    lane = torch.arange(k_lanes, device=dev)
    same = keys[:, None, :] == keys[:, :, None]              # [B, K, K]
    earlier = same & (lane[None, :] < lane[:, None])         # j < i, same key
    prev_same = torch.where(earlier, lane[None, :], -1).amax(dim=2)
    rank = earlier.sum(dim=2)
    is_last = ~(same & (lane[None, :] > lane[:, None])).any(dim=2)
    # JAX's branch predicate: two lanes, both valid, share a key (in any
    # of the B pools); lanes redirected to the trash row never chain
    chained = (earlier & valid[:, :, None] & valid[:, None, :]).any()
    src = torch.where(prev_same >= 0, prev_same, lane)
    pool_of = torch.arange(b, device=dev)[:, None]
    src = (src + pool_of * k_lanes).reshape(-1)
    vflat = values.view(b * n_rows, g, gs)
    aflat = age.view(b * n_rows, g)
    fkeys = keys + pool_of * n_rows

    # working rows: n-gram tokens with the age as one more column, written
    # in place by every round, and each round's scratch, all made here: an
    # IF node's body can neither rebind a tensor nor allocate one
    work = torch.cat([vflat[fkeys], aflat[fkeys][..., None]], dim=-1)
    entry = torch.cat([tups.int(), (clock[:, None] + lane.int())[..., None]],
                      dim=-1)                                # [B, K, GS+1]
    slot_id = torch.arange(g, device=dev)
    in_round = rank[None] == torch.arange(k_lanes, device=dev)[:, None, None]
    big = torch.full((), torch.iinfo(torch.int32).max, dtype=torch.int32,
                     device=dev)
    row, keep = torch.empty_like(work), torch.empty_like(work)
    same_tok = torch.empty(b, k_lanes, g, gs, dtype=torch.bool, device=dev)
    match, live, put = (torch.empty(b, k_lanes, g, dtype=torch.bool,
                                    device=dev) for _ in range(3))
    neg_age, score = (torch.empty(b, k_lanes, g, dtype=torch.int32,
                                  device=dev) for _ in range(2))
    slot = torch.empty(b, k_lanes, dtype=torch.long, device=dev)

    def insert(r):
        """The lanes of rank r, each into the working row of the previous
        lane of its key."""
        torch.index_select(work.view(b * k_lanes, g, gs + 1), 0, src,
                           out=row.view(b * k_lanes, g, gs + 1))
        torch.eq(row[..., :gs], entry[..., None, :gs], out=same_tok)
        torch.all(same_tok, dim=-1, out=match)
        torch.gt(row[..., gs], 0, out=live)
        torch.logical_and(match, live, out=match)
        # the matching slot, else the first empty or oldest one
        torch.neg(row[..., gs], out=neg_age)
        torch.where(match, big, neg_age, out=score)
        torch.argmax(score, dim=-1, out=slot)
        sel = in_round[r]
        torch.eq(slot_id, slot[..., None], out=put)
        torch.logical_and(put, sel[..., None], out=put)
        torch.where(sel[..., None, None], row, work, out=keep)
        torch.where(put[..., None], entry[..., None, :], keep, out=work)

    def chain():
        for r in range(1, k_lanes):
            insert(r)

    insert(0)
    graphs.cond(chained, chain)

    dest = (torch.where(is_last, keys, trash) + pool_of * n_rows).reshape(-1)
    work = work.reshape(b * k_lanes, g, gs + 1)
    vflat.index_put_((dest,), work[..., :gs])
    aflat.index_put_((dest,), work[..., gs])
    return clock + k_lanes


def pool_update(pool: PoolState, keys: torch.Tensor, tups: torch.Tensor,
                valid: torch.Tensor) -> PoolState:
    """Insert K (key, n-gram) lanes in lane order, in place, the clock
    too; invalid lanes are no-ops. Returns ``pool`` with the clock advanced
    by K. A stacked pool (values [B, R+1, G, GS], age [B, R+1, G], clock
    [B]) takes keys [B, K], tups [B, K, GS] and valid [B, K], one batch a
    pool.

    Lanes that share a key must see the edits of the earlier ones. Each
    lane gets its rank among the earlier lanes of its key; round r inserts
    the lanes of rank r, each into the working row of the previous lane of
    its key (its ``prev_same``). The last lane of each key writes back, all
    keys in one ``index_put_``; the others write to the trash row. As in
    JAX's ``lax.cond`` there are two branches:

    - the parallel insert (JAX's ``_parallel``): round 0 alone, every lane
      into its own row. It is right when no two valid lanes share a key,
      the common case of single-stream decoding; duplicates among invalid
      lanes all go to the trash row and need no chain;
    - the chain (JAX's ``_chain``): rounds 1..K-1 as well, run through
      :func:`graphs.cond` when two valid lanes share a key in any of the B
      pools. In a captured step that is an IF node the device takes or
      skips; eagerly (the CPU, a mesh, :func:`fill_pool_with_prompt`)
      it costs one host read of the predicate a call.

    Only the trash row can receive duplicate indices, whose order
    ``index_put_`` does not fix on CUDA, and a chain round changes only it
    when no valid lanes share a key (the warm step before a capture runs
    the chain whatever the predicate says); so rows [0, R) are exact and
    the trash row, which nothing looks up, is unspecified."""
    if pool.age.shape[-1] == 0 or keys.shape[-1] == 0:
        return pool
    if pool.values.dim() == 4:
        pool.clock.copy_(_update_lanes(pool.values, pool.age, pool.clock,
                                       keys, tups, valid))
    else:
        pool.clock.copy_(_update_lanes(
            pool.values[None], pool.age[None], pool.clock.view(1),
            keys[None], tups[None], valid[None])[0])
    return pool


def pool_lookup(pool: PoolState, key: torch.Tensor):
    """Candidate n-grams for a one-element ``key`` tensor: ([G, GS] tokens,
    [G] validity); for a stacked pool and keys [B]: ([B, G, GS], [B, G]).
    Indexes with a 1-d tensor, which needs no host read."""
    if pool.values.dim() == 4:
        b, n_rows = pool.values.shape[:2]
        idx = key.long() + torch.arange(b, device=key.device) * n_rows
        return (pool.values.view(b * n_rows, *pool.values.shape[2:])[idx],
                pool.age.view(b * n_rows, -1)[idx] > 0)
    idx = key.reshape(1).long()
    return pool.values[idx][0], pool.age[idx][0] > 0


def fill_pool_with_prompt(pool: PoolState, prompt: torch.Tensor,
                          prompt_len, level: int) -> PoolState:
    """Every n-gram of the prompt into the pool on the device, in place:
    key prompt[i], n-gram prompt[i+1 : i+level] for each start i. ``prompt``
    is a padded [P] int buffer whose first ``prompt_len`` entries (an int or
    a 0-d tensor) are real tokens; the starts whose n-gram runs past them
    are invalid lanes. The engines fill from the host
    (:func:`host_prompt_fill`), which gives the same content. Eagerly the
    choice of chain reads one predicate on the host (:func:`pool_update`):
    one sync a fill."""
    gs = level - 1
    k = prompt.shape[0] - gs       # upper bound on (key, n-gram) pairs
    if k <= 0:
        return pool
    idx = torch.arange(k, device=prompt.device)
    tups = prompt[idx[:, None] + 1 + torch.arange(gs, device=prompt.device)]
    return pool_update(pool, prompt[:k], tups, idx + gs < prompt_len)


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


def upload_fill(keys, rows, ages, clock, device):
    """A host fill (:func:`host_prompt_fill`) with its arrays on ``device``
    as :func:`apply_host_fill` takes them: int64 keys, int32 rows and ages,
    from pinned memory without a wait (``graphs.upload``)."""
    return (graphs.upload(np.asarray(keys, np.int64), device),
            graphs.upload(np.asarray(rows), device, torch.int32),
            graphs.upload(np.asarray(ages), device, torch.int32), clock)


def apply_host_fill(pool: PoolState, keys, rows, ages, clock,
                    merge: bool = False) -> PoolState:
    """Write host-computed fill rows in one scatter, in place, the clock
    too (lanes with key -1 go to the trash row). Ages and the clock are
    offset by the pool's clock, so logical time never runs backwards;
    empty slots stay 0. Each fill row replaces its key's row, or with ``merge=True`` its
    entries are inserted into the key's existing row in fill order (a match
    refreshes its slot, else the first empty or oldest slot is taken), so a
    carried warm pool keeps every entry the fill does not displace. On
    empty rows both forms give the same content; paged admission always
    merges. ``keys`` (any integer dtype), ``rows`` and ``ages`` are on the
    pool's device: :func:`upload_fill` puts a host fill there, or a flat
    slot holds them among a request's arguments. ``clock`` is an integer
    or a 0-d int32 tensor on that device, which a captured fill reads."""
    dev = pool.values.device
    trash = pool.values.shape[0] - 1
    keys = torch.where(keys < 0, trash, keys.long())
    if merge:
        new_rows, new_ages = pool.values[keys], pool.age[keys]
        slot_id = torch.arange(new_ages.shape[1], device=dev)
        for j in range(new_ages.shape[1]):
            tup, age = rows[:, j], ages[:, j]
            match = (new_rows == tup[:, None, :]).all(dim=-1) & (new_ages > 0)
            slot = torch.where(match.any(dim=1), match.int().argmax(dim=1),
                               new_ages.argmin(dim=1))
            # age 0 marks an unused fill slot: nothing is inserted
            put = (slot_id == slot[:, None]) & (age > 0)[:, None]
            new_rows = torch.where(put[..., None], tup[:, None, :], new_rows)
            new_ages = torch.where(put, (pool.clock + age)[:, None], new_ages)
    else:
        new_rows, new_ages = rows, torch.where(ages > 0, ages + pool.clock, 0)
    pool.values.index_put_((keys,), new_rows)
    pool.age.index_put_((keys,), new_ages)
    pool.clock.add_(clock if isinstance(clock, torch.Tensor) else int(clock))
    return pool
