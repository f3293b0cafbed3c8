"""The port's n-gram pool against the JAX package's: tables and ages must be
bit-equal on rows [0, V) after the same update sequences (duplicate-key
batches included) and after the host prompt fill. Row V, the trash row, is
left out: only it can take duplicate scatter indices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookaheaddecoding_tpu.core import pool as jpool
from lookaheaddecoding_tpu_torch.core import pool as tpool


def assert_same(jp, tp, rows):
    np.testing.assert_array_equal(np.asarray(jp.values)[:rows],
                                  tp.values.numpy()[:rows])
    np.testing.assert_array_equal(np.asarray(jp.age)[:rows],
                                  tp.age.numpy()[:rows])
    assert int(jp.clock) == int(tp.clock)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("vocab,g,gs", [(10, 3, 2), (6, 2, 4), (40, 5, 3)])
def test_update_sequences_bit_equal(seed, vocab, g, gs):
    """Random batches over a small key space, so most batches hold several
    lanes of one key (the chained case) and some rows overflow the LRU."""
    rng = np.random.RandomState(seed)
    jp = jpool.pool_init(vocab, g, gs)
    tp = tpool.pool_init(vocab, g, gs, device="cpu")
    for _ in range(12):
        k = rng.randint(1, 16)
        keys = rng.randint(0, vocab, size=k).astype(np.int32)
        tups = rng.randint(0, 4, size=(k, gs)).astype(np.int32)
        valid = rng.rand(k) < 0.8
        jp = jpool.pool_update(jp, jnp.asarray(keys), jnp.asarray(tups),
                               jnp.asarray(valid))
        tpool.pool_update(tp, torch.from_numpy(keys), torch.from_numpy(tups),
                          torch.from_numpy(valid))
        assert_same(jp, tp, vocab)


def test_duplicate_key_batch_chains_in_lane_order():
    """One batch: refresh, insert and evict on one key, in lane order."""
    jp = jpool.pool_init(8, 2, 2)
    tp = tpool.pool_init(8, 2, 2, device="cpu")
    keys = np.array([5, 5, 5, 3, 5, 5], np.int32)
    tups = np.array([[1, 1], [2, 2], [1, 1], [9, 9], [3, 3], [2, 2]], np.int32)
    valid = np.ones(6, bool)
    jp = jpool.pool_update(jp, jnp.asarray(keys), jnp.asarray(tups),
                           jnp.asarray(valid))
    tpool.pool_update(tp, torch.from_numpy(keys), torch.from_numpy(tups),
                      torch.from_numpy(valid))
    assert_same(jp, tp, 8)
    vals, ok = tpool.pool_lookup(tp, torch.tensor(5))
    assert {tuple(v) for v, o in zip(vals.tolist(), ok.tolist()) if o} == {
        (3, 3), (2, 2)}


@pytest.mark.parametrize("key_len", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_prompt_fill_bit_equal(key_len, seed):
    rng = np.random.RandomState(seed)
    vocab, level, g = 12, 4, 3
    rows = jpool.pool_table_rows(vocab, key_len, 64)
    assert tpool.pool_table_rows(vocab, key_len, 64) == rows
    prompt = rng.randint(0, vocab, size=50)
    jfill = jpool.host_prompt_fill(prompt, level, g, pad_to=64,
                                   key_len=key_len, table_rows=rows)
    tfill = tpool.host_prompt_fill(prompt, level, g, pad_to=64,
                                   key_len=key_len, table_rows=rows)
    for a, b in zip(jfill, tfill):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # onto a warm pool: ages and clock are offset by the pool's clock
    warm_keys = np.array([1, 2, 1], np.int32)
    warm_tups = np.array([[4, 4, 4], [5, 5, 5], [6, 6, 6]], np.int32)
    jp = jpool.pool_update(jpool.pool_init(rows, g, level - 1),
                           jnp.asarray(warm_keys), jnp.asarray(warm_tups),
                           jnp.ones(3, bool))
    tp = tpool.pool_update(tpool.pool_init(rows, g, level - 1, device="cpu"),
                           torch.from_numpy(warm_keys),
                           torch.from_numpy(warm_tups),
                           torch.ones(3, dtype=torch.bool))
    jp = jpool.apply_host_fill(jp, *jfill)
    tpool.apply_host_fill(tp, *tfill)
    assert_same(jp, tp, rows)


def test_bigram_key_wraps_like_uint32():
    a = np.array([0, 1, 31999, 2**31 - 1, 123456], np.int32)
    b = np.array([0, 7, 31999, 2**31 - 1, 654321], np.int32)
    for rows in (128000, 262144, 1000):
        want = np.asarray(jpool.bigram_key(jnp.asarray(a), jnp.asarray(b), rows))
        got = tpool.bigram_key(torch.from_numpy(a), torch.from_numpy(b), rows)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32


def test_invalid_lanes_and_empty_pool_are_noops():
    tp = tpool.pool_init(8, 2, 2, device="cpu")
    tpool.pool_update(tp, torch.tensor([5, 5]), torch.tensor([[1, 1], [2, 2]]),
                      torch.tensor([True, False]))
    vals, ok = tpool.pool_lookup(tp, torch.tensor([5]))
    assert [tuple(v) for v, o in zip(vals.tolist(), ok.tolist()) if o] == [(1, 1)]
    empty = tpool.pool_init(8, 0, 2, device="cpu")
    assert tpool.pool_update(empty, torch.tensor([1]), torch.zeros(1, 2),
                             torch.ones(1, dtype=torch.bool)) is empty
