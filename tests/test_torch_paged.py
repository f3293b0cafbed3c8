"""The port's paged KV cache, paged attention, paged forward and batched
decode step on the CPU, in float32, against the JAX package on the same
numpy inputs. Integers and quantized bytes must be equal; floats are held
to the tolerance each test states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu_torch as tlt
from lookaheaddecoding_tpu.core import paged as jpaged
from lookaheaddecoding_tpu.core import pool as jpool
from lookaheaddecoding_tpu.models import llama as jllama
from lookaheaddecoding_tpu.ops.lookahead_attention import (
    paged_lookahead_attention as jax_paged_attention)
from lookaheaddecoding_tpu_torch.core import paged as tpaged
from lookaheaddecoding_tpu_torch.core import pool as tpool
from lookaheaddecoding_tpu_torch.models import llama as tllama
from lookaheaddecoding_tpu_torch.ops import lookahead_attention as tla

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)


def t32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


# --------------------------------------------------------------------------
# core/paged.py
# --------------------------------------------------------------------------

def test_phys_slots_matches_jax_batched_and_single():
    rng = np.random.RandomState(0)
    tables = rng.permutation(24).reshape(3, 8).astype(np.int32)
    start = np.array([0, 37, 100], np.int32)
    for page in (16, 32):
        want = np.asarray(jpaged.phys_slots(jnp.asarray(tables),
                                            jnp.asarray(start), 27, page))
        got = tpaged.phys_slots(t32(tables), t32(start), 27, page)
        np.testing.assert_array_equal(got.numpy(), want)
        one = tpaged.phys_slots(t32(tables[1]), 37, 27, page)
        np.testing.assert_array_equal(one.numpy(), want[1])


def test_phys_slots_outside_the_table_go_to_the_trash_page():
    """Port only: the JAX function indexes the table past its end for a
    lane stepped after its capacity stop and leans on XLA's clamped gather;
    a CUDA index would assert. The port sends such slots to the lane's
    trash page, or without one clamps the page index."""
    tables = t32([[5, 6], [7, 8]])
    start = t32([30, 2])                    # lane 0 runs past 2 pages of 16
    trash = t32([0, 16])
    got = tpaged.phys_slots(tables, start, 6, 16, trash=trash)
    np.testing.assert_array_equal(
        got.numpy(), [[6 * 16 + 14, 6 * 16 + 15, 0, 1, 2, 3],
                      [7 * 16 + 2 + i for i in range(6)]])
    clamped = tpaged.phys_slots(tables, start, 6, 16)
    assert int(clamped.max()) < 9 * 16 and int(clamped.min()) >= 0
    np.testing.assert_array_equal(clamped[1].numpy(), got[1].numpy())


@pytest.mark.parametrize("quant", [False, True])
def test_paged_write_gather_commit_copy_match_jax(quant):
    """Bytes and scales of the int8 pool equal the jitted JAX function's
    (XLA compiles ``amax / 127.0`` to a multiplication by float32(1/127));
    the float32 pool is equal bit for bit."""
    rng = np.random.RandomState(1)
    hkv, d, page, n_pages, layers = 2, 16, 8, 6, 2
    p = page * n_pages
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    tcfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    jk, _ = jpaged.make_paged_pool(jcfg, n_pages, page,
                                   quant="int8" if quant else None)
    tk, _ = tpaged.make_paged_pool(tcfg, n_pages, page, "cpu",
                                   quant="int8" if quant else None)

    def same(jbuf, tbuf):
        if quant:
            for name in ("q", "s"):
                np.testing.assert_array_equal(np.asarray(jbuf[name]),
                                              tbuf[name].numpy())
        else:
            np.testing.assert_array_equal(np.asarray(jbuf), tbuf.numpy())

    def layer(buf, li):
        return ({n: a[li] for n, a in buf.items()} if quant else buf[li])

    same(jk, tk)
    slots = rng.permutation(p)[:20].astype(np.int32)
    new = rng.randn(20, hkv, d).astype(np.float32) * 3
    write = jax.jit(jpaged.paged_write)
    for li in range(layers):
        jl = write(layer(jk, li), jnp.asarray(slots), jnp.asarray(new))
        jk = ({n: jk[n].at[li].set(jl[n]) for n in jk} if quant
              else jk.at[li].set(jl))
        tpaged.paged_write(layer(tk, li), torch.from_numpy(slots).long(),
                           torch.from_numpy(new))
    same(jk, tk)

    tables = rng.permutation(n_pages).reshape(2, 3).astype(np.int32)
    jg = jpaged.paged_gather(layer(jk, 0), jnp.asarray(tables), page)
    tg = tpaged.paged_gather(layer(tk, 0), t32(tables), page)
    same(jg, tg)

    src = slots[:5]
    dst = np.array([1, 9, 17, 25, 33], np.int32)
    jk = jpaged.paged_commit(jk, jnp.asarray(src), jnp.asarray(dst))
    tpaged.paged_commit(tk, torch.from_numpy(src).long(),
                        torch.from_numpy(dst).long())
    same(jk, tk)

    jk, _ = jpaged.copy_page((jk, jk), 2, 4, page)
    tpaged.copy_page((tk,), 2, 4, page)
    same(jk, tk)


def test_block_allocator_lifecycle():
    a = tpaged.BlockAllocator(10, reserved=2)
    assert a.free_pages == 8
    p1, p2 = a.alloc(3), a.alloc(4)
    assert a.free_pages == 1 and a.used_pages == 7
    assert not (set(p1) & set(p2)) and min(p1 + p2) >= 2
    with pytest.raises(tpaged.OutOfPages):
        a.alloc(2)
    a.share(p1)
    a.release(p1)
    assert a.free_pages == 1       # still held by the share
    a.release(p1)
    assert a.free_pages == 4
    a.release(p2)
    assert a.free_pages == 8
    with pytest.raises(ValueError):
        tpaged.BlockAllocator(2, reserved=2)
    # the same requests give the same pages as the JAX allocator
    ja, ta = jpaged.BlockAllocator(9, 2), tpaged.BlockAllocator(9, 2)
    assert ja.alloc(3) == ta.alloc(3) and ja.alloc(2) == ta.alloc(2)


def test_pages_needed_equals_jax_over_a_grid():
    n = 0
    for prompt in (1, 10, 63, 64, 65, 200):
        for max_new in (1, 8, 100, 10_000):
            for s_len in (14, 27):
                for page in (16, 32, 64):
                    for m in (128, 256):
                        for prefix in (0, 7, 64, min(prompt, 70)):
                            args = (prompt, max_new, s_len, page, m, prefix)
                            assert (tpaged.pages_needed(*args)
                                    == jpaged.pages_needed(*args)), args
                            n += 1
    assert n > 500


# --------------------------------------------------------------------------
# ops/lookahead_attention.py: the paged call's plain version
# --------------------------------------------------------------------------

GEO = dict(level=4, window=5, guess_size=3)
S = 3 * 5 + 4 * 3         # 27 composite rows


def paged_case(seed, page, nb, quant, b=2, hkv=2, rep=2, d=64, s=S):
    """Random q, a logical cache for each lane, and the same cache laid
    out in a pool through shuffled tables (one spare page of garbage)."""
    rng = np.random.RandomState(seed)
    m = page * nb
    q = rng.randn(b, s, hkv * rep, d).astype(np.float32)
    k_log = rng.randn(b, hkv, m, d).astype(np.float32)
    v_log = rng.randn(b, hkv, m, d).astype(np.float32)
    n_pages = b * nb + 1
    tables = rng.permutation(n_pages)[:b * nb].reshape(b, nb).astype(np.int32)
    k_pool = rng.randn(hkv, n_pages * page, d).astype(np.float32)
    v_pool = rng.randn(hkv, n_pages * page, d).astype(np.float32)
    for lane in range(b):
        for j in range(nb):
            pg = tables[lane, j]
            k_pool[:, pg * page:(pg + 1) * page] = \
                k_log[lane, :, j * page:(j + 1) * page]
            v_pool[:, pg * page:(pg + 1) * page] = \
                v_log[lane, :, j * page:(j + 1) * page]

    def q8(x):
        s_ = np.maximum(np.abs(x).max(axis=-1, keepdims=True) / 127.0,
                        1e-8).astype(np.float32)
        return {"q": np.clip(np.round(x / s_), -127, 127).astype(np.int8),
                "s": s_}
    if quant:
        k_pool, v_pool = q8(k_pool), q8(v_pool)
        k_log = [q8(k_log[lane]) for lane in range(b)]
        v_log = [q8(v_log[lane]) for lane in range(b)]
    return q, k_pool, v_pool, k_log, v_log, tables


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {n: torch.from_numpy(a) for n, a in tree.items()}
    return torch.from_numpy(tree)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sw", [0, 40])
def test_paged_ref_matches_jax_pallas_kernel_interpreted(quant, causal, sw):
    """Against the JAX paged Pallas kernel in interpret mode (page 128, its
    tiling rule). rtol/atol 2e-5: float32 sums in another order, an online
    against a direct softmax."""
    q, kp, vp, _, _, tables = paged_case(0, 128, 2, quant)
    kv_lens = np.array([37, 101], np.int32)
    kw = dict(GEO, page_size=128, causal=causal, sliding_window=sw)
    want = jax_paged_attention(
        jnp.asarray(q), to_jax(kp), to_jax(vp), jnp.asarray(kv_lens),
        jnp.asarray(tables), interpret=True, **kw)
    before = dict(tla.paged_counts)
    got = tla.paged_lookahead_attention(
        torch.from_numpy(q), to_torch(kp), to_torch(vp), t32(kv_lens),
        t32(tables), **kw)
    assert tla.paged_counts["plain"] == before["plain"] + 1
    assert tla.paged_counts["kernel"] == before["kernel"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("page,nb", [(16, 8), (32, 4)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("causal,sw", [(False, 0), (True, 0), (False, 40)])
def test_paged_ref_matches_jax_dense_path_and_flat_ref(page, nb, quant,
                                                       causal, sw):
    """Small pages: against JAX's dense paged path (``paged_gather`` +
    ``attention_xla`` under the lane's mask, as ``forward_paged`` runs it),
    rtol/atol 2e-5, and bit for bit against the port's flat plain version
    on each lane's contiguous cache."""
    q, kp, vp, k_log, v_log, tables = paged_case(1, page, nb, quant, d=16)
    m = page * nb
    kv_lens = np.array([0, m - S - 5], np.int32)
    kw = dict(GEO, causal=causal, sliding_window=sw)
    got = tla.paged_lookahead_attention_ref(
        torch.from_numpy(q), to_torch(kp), to_torch(vp), t32(kv_lens),
        t32(tables), page_size=page, **kw)
    kg = jpaged.paged_gather(to_jax(kp), jnp.asarray(tables), page)
    vg = jpaged.paged_gather(to_jax(vp), jnp.asarray(tables), page)
    for lane in range(2):
        kv = t32(kv_lens[lane:lane + 1])
        flat = tla.lookahead_attention_ref(
            torch.from_numpy(q[lane]), to_torch(k_log[lane]),
            to_torch(v_log[lane]), kv, **kw)
        assert torch.equal(got[lane], flat)
        vis = tla._block_mask(kv, m, s_len=S, device="cpu", **kw)
        mask = jnp.where(jnp.asarray(vis.numpy()), 0.0, -1e30)
        want = jllama.attention_xla(
            jnp.asarray(q[lane]), jax.tree.map(lambda a: a[lane], kg),
            jax.tree.map(lambda a: a[lane], vg), mask)
        np.testing.assert_allclose(got[lane].numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# models/llama.py: forward_paged
# --------------------------------------------------------------------------

def weights(seed=0):
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    params = jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(seed),
                                            scale=0.5))
    tcfg = tlt.LlamaConfig(**ARCH, dtype=torch.float32)
    return jcfg, params, tcfg, tlt.params_from_numpy(params, tcfg, "cpu")


def pools_equal(jpool_, tpool_, quant, atol):
    if quant:
        # a float difference in the last bit may move a value across a
        # rounding edge: bytes within 1, scales within the tolerance
        dq = np.abs(np.asarray(jpool_["q"]).astype(np.int32)
                    - tpool_["q"].numpy().astype(np.int32))
        assert dq.max() <= 1 and (dq > 0).mean() < 1e-3
        np.testing.assert_allclose(tpool_["s"].numpy(),
                                   np.asarray(jpool_["s"]), rtol=1e-5,
                                   atol=1e-8)
    else:
        np.testing.assert_allclose(tpool_.numpy(), np.asarray(jpool_),
                                   rtol=1e-4, atol=atol)


@pytest.mark.parametrize("case", ["composite", "padded_prefill",
                                  "composite_int8_pool"])
def test_forward_paged_matches_jax(case):
    """Logits and both pools after one call on the same inputs. Logits and
    the float32 pools within rtol 1e-4 / atol 2e-4 (two float32 layer
    stacks with other summation orders); the int8 pool's bytes within one
    step and its scales within rtol 1e-5."""
    quant = case.endswith("int8_pool")
    jcfg, jparams, tcfg, tparams = weights()
    page, nb, b = 16, 8, 2
    n_pages = b * nb + b
    layout = jlt.build_layout(jlt.LookaheadConfig(
        level=4, window_size=5, guess_set_size=4))
    rng = np.random.RandomState(5)
    tables = (b + rng.permutation(b * nb)).reshape(b, nb).astype(np.int32)
    jk, jv = jpaged.make_paged_pool(jcfg, n_pages, page,
                                    quant="int8" if quant else None)
    tk, tv = tpaged.make_paged_pool(tcfg, n_pages, page, "cpu",
                                    quant="int8" if quant else None)
    cos, sin = jllama.rope_tables(jcfg, page * nb + 32)
    tcos, tsin = tllama.rope_tables(tcfg, page * nb + 32, "cpu")
    meta = dict(level=4, window=5, guess_size=3, sliding_window=0)

    def call(tokens, positions, kv_lens, rows, causal, limit=None,
             trash=None):
        nonlocal jk, jv
        m = page * nb
        col = np.arange(m)[None, None, :]
        if causal:
            vis = col <= positions[:, :, None]
        else:
            vis = np.stack([tla._block_mask(
                t32(kv_lens[i:i + 1]), m, s_len=tokens.shape[1],
                causal=False, device="cpu", **meta).numpy()
                for i in range(b)])
        mask = jnp.where(jnp.asarray(vis), 0.0, -1e30)
        jl, jk, jv = jllama.forward_paged(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jk,
            jv, jnp.asarray(tables), jnp.asarray(kv_lens), page, mask, cos,
            sin, logits_rows=jnp.asarray(rows), attn_impl="xla",
            write_limit=None if limit is None else jnp.asarray(limit),
            trash_slot=None if trash is None else jnp.asarray(trash))
        tl, _, _ = tllama.forward_paged(
            tparams, tcfg, t32(tokens).long(), t32(positions).long(), tk, tv,
            t32(tables), t32(kv_lens), page, tcos, tsin,
            dict(meta, causal=causal, kv_lens=t32(kv_lens)),
            logits_rows=torch.from_numpy(np.asarray(rows, np.int64)),
            attn_impl="dense",
            write_limit=None if limit is None else t32(limit),
            trash_slot=None if trash is None else t32(trash))
        assert tuple(tl.shape) == tuple(jl.shape)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=2e-4)

    # a prefill chunk first, so the composite call reads a filled cache
    c = 32
    kv0 = np.array([0, 0], np.int32)
    pos = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    toks = rng.randint(0, 128, size=(b, c)).astype(np.int32)
    if case == "padded_prefill":
        # rows at logical slots >= the limit go to the lanes' trash pages,
        # and a call that reads no logits row returns [B, 0, V]
        call(toks, pos, kv0, [], True, limit=np.array([20, 32], np.int32),
             trash=np.array([0, page], np.int32))
    else:
        call(toks, pos, kv0, [], True)
        kv = np.array([32, 17], np.int32)
        comp = rng.randint(0, 128, size=(b, layout.seq_len)).astype(np.int32)
        cpos = kv[:, None] + layout.rel_pos[None, :].astype(np.int32)
        call(comp, cpos, kv, [0, 1, 2, 20, 26], False)
    # data pages only: the trash pages took duplicate writes
    data = slice(b * page, None)
    for jp_, tp_ in ((jk, tk), (jv, tv)):
        if quant:
            pools_equal({n: a[:, :, data] for n, a in jp_.items()},
                        {n: a[:, :, data] for n, a in tp_.items()}, True, 0)
        else:
            pools_equal(jp_[:, :, data], tp_[:, :, data], False, 2e-4)


# --------------------------------------------------------------------------
# core/pool.py: the merging fill and the stacked pool
# --------------------------------------------------------------------------

@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("key_len", [1, 2])
def test_apply_host_fill_merge_bit_equal(warm, key_len):
    rng = np.random.RandomState(key_len)
    vocab, level, g = 12, 4, 3
    rows = jpool.pool_table_rows(vocab, key_len, 64)
    prompt = rng.randint(0, vocab, size=60)
    fill = jpool.host_prompt_fill(prompt, level, g, pad_to=64,
                                  key_len=key_len, table_rows=rows)
    jp = jpool.pool_init(rows, g, level - 1)
    tp = tpool.pool_init(rows, g, level - 1, device="cpu")
    if warm:
        for _ in range(3):
            keys = rng.randint(0, rows, size=9).astype(np.int32)
            tups = rng.randint(0, vocab, size=(9, level - 1)).astype(np.int32)
            jp = jpool.pool_update(jp, jnp.asarray(keys), jnp.asarray(tups),
                                   jnp.ones(9, bool))
            tpool.pool_update(tp, torch.from_numpy(keys),
                              torch.from_numpy(tups),
                              torch.ones(9, dtype=torch.bool))
    jp = jpool.apply_host_fill(jp, *fill, merge=True)
    tpool.apply_host_fill(tp, *fill, merge=True)
    np.testing.assert_array_equal(np.asarray(jp.values)[:rows],
                                  tp.values.numpy()[:rows])
    np.testing.assert_array_equal(np.asarray(jp.age)[:rows],
                                  tp.age.numpy()[:rows])
    assert int(jp.clock) == int(tp.clock)
    if not warm:
        # on an empty pool the merging and the replacing fill agree
        rp = tpool.apply_host_fill(
            tpool.pool_init(rows, g, level - 1, device="cpu"), *fill)
        assert torch.equal(rp.values[:rows], tp.values[:rows])
        assert torch.equal(rp.age[:rows], tp.age[:rows])


def test_stacked_pool_update_equals_one_pool_at_a_time():
    """``pool_update`` and ``pool_lookup`` on B stacked pools give what B
    separate pools give, duplicate keys and invalid lanes included."""
    rng = np.random.RandomState(3)
    b, vocab, g, gs, k = 3, 10, 3, 2, 11
    singles = [tpool.pool_init(vocab, g, gs, device="cpu") for _ in range(b)]
    one = tpool.pool_init(vocab, g, gs, device="cpu")
    stacked = tpool.PoolState(one.values[None].repeat(b, 1, 1, 1),
                              one.age[None].repeat(b, 1, 1),
                              one.clock[None].repeat(b))
    for _ in range(6):
        keys = torch.from_numpy(rng.randint(0, vocab, size=(b, k)))
        tups = torch.from_numpy(rng.randint(0, 4, size=(b, k, gs)))
        valid = torch.from_numpy(rng.rand(b, k) < 0.8)
        tpool.pool_update(stacked, keys, tups, valid)
        for i, p in enumerate(singles):
            tpool.pool_update(p, keys[i], tups[i], valid[i])
            assert torch.equal(stacked.values[i, :vocab], p.values[:vocab])
            assert torch.equal(stacked.age[i, :vocab], p.age[:vocab])
            assert int(stacked.clock[i]) == int(p.clock)
    look = torch.tensor([4, 0, 9])
    vals, ok = tpool.pool_lookup(stacked, look)
    for i, p in enumerate(singles):
        v1, ok1 = tpool.pool_lookup(p, look[i])
        assert torch.equal(vals[i], v1) and torch.equal(ok[i], ok1)
