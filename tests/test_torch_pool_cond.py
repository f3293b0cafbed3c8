"""The pool update's two branches against JAX's ``lax.cond``
(``lookaheaddecoding_tpu/core/pool.py``: ``_chain`` when two valid lanes
share a key, else ``_parallel``): the same numpy-seeded batches through
JAX's ``pool_update`` and the port's, rows [0, R) and the clock equal after
every batch (row R, the trash row, is unspecified), and the port takes the
chain (``graphs.stats["taken"]``) exactly when JAX's predicate holds in
one of its pools."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookaheaddecoding_tpu.core import pool as jpool
from lookaheaddecoding_tpu_torch.core import graphs
from lookaheaddecoding_tpu_torch.core import pool as tpool

G, GS, K, STEPS = 3, 2, 8, 10


def jax_chains(keys, valid):
    """JAX's ``jnp.any(valid_dup)``: two different lanes, both valid, share
    a key."""
    same = keys[:, None] == keys[None, :]
    off = ~np.eye(len(keys), dtype=bool)
    return bool((same & off & valid[:, None] & valid[None, :]).any())


def distinct(rng, rows, valid):
    """Keys with no two valid lanes alike."""
    return rng.permutation(rows)[:len(valid)].astype(np.int32)


def batch(case, rng, rows, step):
    """(keys [B, K], tups [B, K, GS], valid [B, K]) of one update."""
    tups = rng.randint(0, 3, size=(1, K, GS)).astype(np.int32)
    valid = rng.rand(1, K) < 0.75
    valid[0, 0] = True
    if case == "parallel":
        keys = distinct(rng, rows, valid[0])[None]
    elif case == "chain":
        valid[0, :2] = True
        keys = rng.randint(0, 3, size=(1, K)).astype(np.int32)
        keys[0, 1] = keys[0, 0]
    elif case == "invalid_duplicates":
        # the invalid lanes share one key, that of valid lane 0: all of
        # them go to the trash row, and JAX takes the parallel insert
        keys = distinct(rng, rows, valid[0])[None]
        valid[0, 1:3] = False
        keys[0, ~valid[0]] = keys[0, 0]
    elif case == "stacked":
        # three pools, the middle one with two valid lanes of one key
        tups = rng.randint(0, 3, size=(3, K, GS)).astype(np.int32)
        valid = rng.rand(3, K) < 0.75
        valid[:, :2] = True
        keys = np.stack([distinct(rng, rows, valid[b]) for b in range(3)])
        keys[1, 1] = keys[1, 0]
    else:                                   # bigram keys, every other step
        toks = rng.randint(0, 5, size=(K + 1,)).astype(np.int32)
        if step % 2:
            toks = rng.permutation(40)[:K + 1].astype(np.int32)
        a, b = toks[:-1], toks[1:]
        keys = np.array(jpool.bigram_key(jnp.asarray(a), jnp.asarray(b),
                                         rows))[None]
        got = tpool.bigram_key(torch.from_numpy(a), torch.from_numpy(b), rows)
        np.testing.assert_array_equal(got.numpy(), keys[0])
    return keys, tups, valid


@pytest.mark.parametrize("case", ["parallel", "chain", "invalid_duplicates",
                                  "stacked", "bigram"])
def test_branches_bit_equal_to_jax(case):
    rng = np.random.RandomState(["parallel", "chain", "invalid_duplicates",
                                 "stacked", "bigram"].index(case))
    key_len = 2 if case == "bigram" else 1
    rows = tpool.pool_table_rows(20, key_len, 64)
    assert rows == jpool.pool_table_rows(20, key_len, 64)
    n_pools = 3 if case == "stacked" else 1
    jps = [jpool.pool_init(rows, G, GS) for _ in range(n_pools)]
    tp = tpool.pool_init(rows, G, GS, device="cpu")
    if case == "stacked":
        tp = tpool.PoolState(tp.values[None].repeat(3, 1, 1, 1),
                             tp.age[None].repeat(3, 1, 1),
                             tp.clock[None].repeat(3))
    taken = []
    for step in range(STEPS):
        keys, tups, valid = batch(case, rng, rows, step)
        want = any(jax_chains(k, v) for k, v in zip(keys, valid))
        jps = [jpool.pool_update(jp, jnp.asarray(k), jnp.asarray(t),
                                 jnp.asarray(v))
               for jp, k, t, v in zip(jps, keys, tups, valid)]
        graphs.reset_stats()
        args = [torch.from_numpy(x) for x in (keys, tups, valid)]
        if case != "stacked":
            args = [x[0] for x in args]
        tpool.pool_update(tp, *args)
        assert graphs.stats["branches"] == 1
        taken.append(graphs.stats["taken"])
        assert taken[-1] == int(want), (step, keys, valid)
        for b, jp in enumerate(jps):
            pick = (lambda x: x[b]) if case == "stacked" else (lambda x: x)
            np.testing.assert_array_equal(pick(tp.values).numpy()[:rows],
                                          np.asarray(jp.values)[:rows])
            np.testing.assert_array_equal(pick(tp.age).numpy()[:rows],
                                          np.asarray(jp.age)[:rows])
            assert int(pick(tp.clock)) == int(jp.clock)
    expect = {"parallel": {0}, "chain": {1}, "invalid_duplicates": {0},
              "stacked": {1}, "bigram": {0, 1}}[case]
    assert set(taken) == expect, taken
