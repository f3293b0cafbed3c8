"""Card-only tests of the port's CUDA kernels (the composite attention on
a plain and on an int8 KV cache, flat and paged, in bfloat16 on the tensor
cores and in float32 on FMAs; the int8, int4 and pipelined int4 matrix
products, in bfloat16 on the tensor cores; the int4 product's two
micro-benchmark variants), each against its plain PyTorch version; the
attention also at head_dim 256 with Gemma-2B's heads and at head_dim 32,
48, 80, 96 and 112; continuous batching against the flat engine; the training
step on the card against the CPU, ``load_params`` onto the card,
``utils.profiling.trace`` around a card ``generate``, the attention at a
first composite row (``row0``) and two ranks decoding at tp=2 on one card
over gloo, and a one-rank NCCL mesh engine (chip_smoke's phase 14: the
decode loop on the device, and a WHILE node over NCCL collectives) and
train step captured; the CUDA-graph IF node (``ops/graph_cond.py``)
against its plain version, the pool's chain as an IF node of captured
steps (taken and skipped, tables and branch counts equal to eager), a
capture whose IF node fails raising, the captured train step
bit-equal to the eager one, and the captured prefill (the slot after a
request's preparation bit-equal to eager, a replay a chunk, no host sync
up to the first decode replay); the CUDA-graph WHILE node (n, 0 and 1
iterations, flags set by the body, a forbidden body node refused) and the
decode loop on the device (greedy, AR, prefix and batch calls bit-equal
to eager, one loop launch and one read a call, no sync before it); the
Philox kernel of the decode state's random stream bit-equal to its plain
version, a captured launch reading the current draw counter on each
replay, and the sampling loop on the device (sampled calls, a sampled
batch and an ``always_fwd_one=False`` call bit-equal to the host loop and
eager, draw counters included, one read and no sync before it).
They skip without a CUDA device. This file imports no
JAX, so on a machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from lookaheaddecoding_tpu_torch.ops import lookahead_attention as la


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [
    # fp32 sums in another order and an online softmax
    (torch.float32, dict(atol=1e-4, rtol=1e-4)),
    # bf16 output; p rounded to bf16 against a running vs a row maximum
    (torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
])
def test_attention_kernel_matches_plain_version(dtype, tol):
    """The composite-attention kernel: composite and causal, one and many
    KV tiles, with and without a sliding window, GQA rep 8 and 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    big = dict(level=7, window=20, guess_size=6)       # S = 240
    small = dict(level=4, window=5, guess_size=3)      # S = 27
    cases = [(240, 32, 1024, 512, False, 0, big),
             (240, 32, 2048, 1808, False, 0, big),
             (128, 32, 1024, 640, True, 0, big),
             (240, 32, 1024, 600, False, 300, big),
             (1, 32, 1024, 700, True, 0, big),
             (27, 16, 256, 37, False, 16, small),
             (27, 16, 256, 0, False, 0, small)]
    for s, hq, m, kv, causal, sw, geo in cases:
        def mk(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
                dev, dtype)
        q, k, v = mk(s, hq, 64), mk(4, m, 64), mk(4, m, 64)
        kv_len = torch.tensor([kv], dtype=torch.int32, device=dev)
        kw = dict(geo, causal=causal, sliding_window=sw)
        before = la.counts["kernel"]
        got = la.lookahead_attention(q, k, v, kv_len, **kw)
        assert la.counts["kernel"] == before + 1
        want = la.lookahead_attention_ref(q, k, v, kv_len, **kw)
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("int8_kv", [False, True], ids=["plain", "int8_kv"])
def test_bf16_attention_within_rounding_limit_of_float32_kernel(int8_kv):
    """The bfloat16 design (tensor cores) against the float32 design (FMAs)
    on the same inputs: |bf16 - bf16(f32)| <= 2**-8 sum_j p_j |v_j| (p
    rounded to bf16: half an ulp of each term, computed by the float32
    kernel from |v|) + 2**-7 |out| (the two outputs may land one bf16 ulp
    apart) + 1e-4 (the float32 tolerance), chip_smoke's limit. Each call
    counts as its own design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from lookaheaddecoding_tpu_torch.models.llama import kv_cache_write
    dev = torch.device("cuda")
    rng = np.random.RandomState(7)
    big = dict(level=7, window=20, guess_size=6)
    small = dict(level=4, window=5, guess_size=3)
    cases = [(240, 32, 1024, 512, False, 0, big, 64),
             (240, 32, 2048, 1808, False, 0, big, 64),
             (128, 32, 1024, 640, True, 0, big, 64),
             (240, 32, 1024, 600, False, 300, big, 64),
             (128, 32, 1024, 600, True, 300, big, 64),
             (1, 32, 1024, 700, True, 0, big, 64),
             (27, 16, 256, 37, False, 16, small, 64),
             (27, 16, 256, 100, False, 0, small, 128),
             (128, 8, 512, 200, True, 0, big, 128)]
    for s, hq, m, kv, causal, sw, geo, d in cases:
        def mk(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
                dev, torch.bfloat16)
        if int8_kv:
            def cache():
                c = {"q": torch.zeros(4, m, d, dtype=torch.int8, device=dev),
                     "s": torch.full((4, m, 1), 1e-8, device=dev)}
                return kv_cache_write(c, mk(m, 4, d), 0)
            k, v = cache(), cache()
            kf, vf, v_abs = k, v, {"q": v["q"].abs(), "s": v["s"]}
        else:
            k, v = mk(4, m, d), mk(4, m, d)
            kf, vf = k.float(), v.float()
            v_abs = vf.abs()
        q = mk(s, hq, d)
        kv_len = torch.tensor([kv], dtype=torch.int32, device=dev)
        kw = dict(geo, causal=causal, sliding_window=sw)
        before = dict(la.counts)
        got = la.lookahead_attention(q, k, v, kv_len, **kw)
        assert la.counts == dict(before, kernel=before["kernel"] + 1,
                                 mma=before["mma"] + 1)
        exact = la.lookahead_attention(q.float(), kf, vf, kv_len, **kw)
        weight = la.lookahead_attention(q.float(), kf, v_abs, kv_len, **kw)
        assert la.counts["fma"] == before["fma"] + 2
        limit = 2.0 ** -8 * weight + 2.0 ** -7 * exact.abs() + 1e-4
        err = (got.float() - exact.bfloat16().float()).abs()
        assert bool((err <= limit).all()), (s, m, kv, causal, sw, d,
                                            (err / limit).max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(atol=1e-4, rtol=1e-4)),
    (torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
])
def test_attention_kernel_int8_kv_matches_plain_version(dtype, tol):
    """The int8-KV mode: the cache is written by ``kv_cache_write``; the
    scales multiply the scores and the probabilities inside the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from lookaheaddecoding_tpu_torch.models.llama import kv_cache_write
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    big = dict(level=7, window=20, guess_size=6)
    small = dict(level=4, window=5, guess_size=3)
    cases = [(240, 32, 1024, 512, False, 0, big),
             (240, 32, 2048, 1808, False, 0, big),
             (128, 32, 1024, 640, True, 0, big),
             (1, 32, 1024, 700, True, 0, big),
             (27, 16, 256, 37, False, 16, small)]
    for s, hq, m, kv, causal, sw, geo in cases:
        def mk(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
                dev, dtype)

        def cache():
            c = {"q": torch.zeros(4, m, 64, dtype=torch.int8, device=dev),
                 "s": torch.full((4, m, 1), 1e-8, device=dev)}
            return kv_cache_write(c, mk(m, 4, 64), 0)
        q, k, v = mk(s, hq, 64), cache(), cache()
        kv_len = torch.tensor([kv], dtype=torch.int32, device=dev)
        kw = dict(geo, causal=causal, sliding_window=sw)
        before = la.counts["kernel"]
        got = la.lookahead_attention(q, k, v, kv_len, **kw)
        assert la.counts["kernel"] == before + 1
        want = la.lookahead_attention_ref(q, k, v, kv_len, **kw)
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [
    # the same float32 sum in another order
    (torch.float32, dict(atol=2e-4, rtol=2e-4)),
    # both round one float32 value to bf16: at most one ulp (2**-7 of |y|)
    # apart, and the float32 difference near zero
    (torch.bfloat16, dict(atol=1e-3, rtol=2.0 ** -7)),
])
@pytest.mark.parametrize("mode", ["int8", "int4", "int4_pipe"])
def test_quant_matmul_kernel_matches_plain_version(mode, dtype, tol):
    """Each quantized product against its plain version: one row, a ragged
    row count, every tile shape, ragged N (not a multiple of 64), a K whose
    packed rows are zero-padded, and one layer of a stacked weight. A row's
    result does not depend on the rows beside it, and the pipelined int4
    kernel gives the int4 kernel's bits. In bfloat16 every product runs on
    the tensor cores, never on the FMA kernels: int4 also at T in (1, 16,
    17, 64, 128, 240) on the fused gate/up and the down projection, and at
    an odd K/2 (x's second half not 16-byte aligned); int8 also at T in (1,
    16, 17, 64, 128, 141, 240, 960) on the gate/up, down and wk shapes, and
    at an odd K (x's rows not 16-byte aligned)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from lookaheaddecoding_tpu_torch.ops import quant
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(2)
    bits = 8 if mode == "int8" else 4

    def run(x, wq, m=mode):
        if m == "int8":
            return qm.int8_matmul(x, wq["q"], wq["scale"])
        return qm.int4_matmul(x, wq["q4"], wq["scale"],
                              pipeline=m == "int4_pipe",
                              logical_k2=quant.logical_packed_rows(wq))

    cases = [(1, 2048, 256), (8, 512, 80), (17, 2048, 2048),
             (240, 5632, 2048), (128, 2048, 5632), (9, 5888, 48),
             (141, 2048, 32000), (3, 11008, 4096)]
    if bits == 4 and dtype == torch.bfloat16:
        cases += [(t, k, n) for k, n in ((2048, 11264), (5632, 2048))
                  for t in (1, 16, 17, 64, 128, 240)]
        cases += [(5, 2002, 96), (40, 2002, 4224)]      # K/2 = 1001
    if bits == 8 and dtype == torch.bfloat16:
        cases += [(t, k, n) for k, n in ((2048, 5632), (5632, 2048),
                                         (2048, 256))
                  for t in (1, 16, 17, 64, 128, 141, 240, 960)]
        cases += [(5, 1001, 96), (40, 1001, 4224)]      # K not a multiple of 8
    key = qm.count_key(mode, dtype)
    other = {"int4_mma": "int4_fma", "int4_pipe_mma": "int4_pipe_fma",
             "int4_fma": "int4_mma", "int4_pipe_fma": "int4_pipe_mma",
             "int8_mma": "int8_fma", "int8_fma": "int8_mma"}
    for t, k, n in cases:
        w = torch.from_numpy(rng.randn(2, k, n).astype(np.float32) * 0.02)
        stack = quant.quantize_weight(w.to(dev), bits)
        wq = {name: leaf[1] for name, leaf in stack.items()}
        x = torch.from_numpy(rng.randn(t, k).astype(np.float32)).to(dev, dtype)
        before = dict(qm.counts)
        got = run(x, wq)
        assert qm.counts[key] == before[key] + 1
        if key in other:        # the other design of the same mode: none
            assert qm.counts[other[key]] == before[other[key]]
        want = (qm.int8_matmul_ref(x, wq["q"], wq["scale"]) if bits == 8
                else qm.int4_matmul_ref(x, wq["q4"], wq["scale"]))
        torch.testing.assert_close(got.float(), want.float(), **tol)
        for r in sorted({0, t // 2, t - 1}):
            assert torch.equal(run(x[r:r + 1].contiguous(), wq)[0], got[r])
        if mode == "int4_pipe":
            assert torch.equal(got, run(x, wq, "int4"))


@pytest.mark.gpu
@pytest.mark.parametrize("pipeline", [False, True], ids=["int4", "int4_pipe"])
def test_int4_mma_fragment_maps(pipeline):
    """The tensor-core int4 kernels element by element: x is one-hot, so
    y[t, n] is one weight nibble (of packed row r_t, low or high) times its
    scale, exact, and every (row, column) must land where the plain version
    puts it: on the 16 x 16, 16 x 32, 64 x 64 and 64 x 128 tiles with K
    in one block (K/2 < 2048), and with K split over the 4 blocks of a
    cluster (K/2 of 2048 and 2816, on the 16 x 16 and 48 x 128 tiles),
    where the rows r_t are spread over K so that each block's partial sums
    reach the output through the cluster's reduction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from lookaheaddecoding_tpu_torch.ops import quant
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm
    dev = torch.device("cuda")
    rng = np.random.RandomState(5)
    for t, k2, n in ((16, 16, 16), (16, 16, 4224), (64, 64, 64),
                     (128, 128, 16896), (16, 2048, 256), (64, 2816, 2048)):
        w = torch.from_numpy(rng.randn(2 * k2, n).astype(np.float32))
        wq = quant.quantize_weight(w.to(dev), 4)
        rows = torch.from_numpy(rng.permutation(k2)[:t]).to(dev)
        for half in (0, 1):
            x = torch.zeros(t, 2 * k2, device=dev, dtype=torch.bfloat16)
            x[torch.arange(t), half * k2 + rows] = 1
            got = qm.int4_matmul(x, wq["q4"], wq["scale"], pipeline=pipeline)
            want = qm.int4_matmul_ref(x, wq["q4"], wq["scale"])
            assert torch.equal(got, want), (t, k2, n, half)


@pytest.mark.gpu
def test_int8_mma_fragment_maps():
    """The tensor-core int8 kernel element by element: x is one-hot, so
    y[t, n] is one weight byte (of row r_t) times its scale, exact, and
    every (row, column) must land where the plain version puts it: on the
    16-row tiles (T <= 16, and T = 240 on N = 256, where even [64, 64]
    tiles leave most SMs idle), the 64 x 64 and 64 x 128 tiles with K in one
    block (K < 4096), and with K split over the 4 blocks of a cluster (K of
    4096 and 5632, on the 16 x 16 and 48 x 128 tiles, and the 256-wide
    weight, split for its width, at K = 2048), where the rows r_t
    are spread over K so that each block's partial sums reach the output
    through the cluster's reduction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from lookaheaddecoding_tpu_torch.ops import quant
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm
    dev = torch.device("cuda")
    rng = np.random.RandomState(6)
    for t, k, n in ((16, 32, 16), (16, 32, 4224), (240, 2048, 256),
                    (64, 128, 64), (128, 256, 16896), (16, 4096, 256),
                    (64, 5632, 2048)):
        w = torch.from_numpy(rng.randn(k, n).astype(np.float32))
        wq = quant.quantize_weight(w.to(dev), 8)
        rows = torch.from_numpy(rng.choice(k, t, replace=t > k)).to(dev)
        x = torch.zeros(t, k, device=dev, dtype=torch.bfloat16)
        x[torch.arange(t), rows] = 1
        before = qm.counts["int8_mma"]
        got = qm.int8_matmul(x, wq["q"], wq["scale"])
        assert qm.counts["int8_mma"] == before + 1
        want = qm.int8_matmul_ref(x, wq["q"], wq["scale"])
        assert torch.equal(got, want), (t, k, n)


@pytest.mark.gpu
def test_quant_matmul_kernel_refusals_on_the_card():
    """On a CUDA tensor the wrapper raises on what the kernel does not
    take; it never runs the plain version there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm
    dev = torch.device("cuda")
    x = torch.zeros(4, 64, device=dev)
    plain = qm.counts["plain"]
    with pytest.raises(ValueError, match="multiple of 16"):
        qm.int8_matmul(x, torch.zeros(64, 24, dtype=torch.int8, device=dev),
                       torch.ones(1, 24, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        qm.int8_matmul(x, torch.zeros(32, 64, dtype=torch.int8, device=dev).T,
                       torch.ones(1, 32, device=dev))
    assert qm.int8_matmul(x[:0], torch.zeros(64, 32, dtype=torch.int8,
                                             device=dev),
                          torch.ones(1, 32, device=dev)).shape == (0, 32)
    assert qm.counts["plain"] == plain


@pytest.mark.gpu
@pytest.mark.parametrize("int8_kv", [False, True], ids=["plain", "int8_kv"])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(atol=1e-4, rtol=1e-4)),
    (torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
])
def test_paged_attention_kernel_matches_plain_and_flat(dtype, tol, int8_kv):
    """The paged call on a shared pool with shuffled tables, four lanes of
    different ``kv_len`` (0, one past a page boundary, 512, the capacity
    less S), pages of 128 and 48 slots, composite and causal, with and
    without a sliding window: within ``tol`` of its plain version, and each
    lane bit-equal to the flat kernel on that lane's contiguous cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from lookaheaddecoding_tpu_torch.core.paged import (paged_gather,
                                                        paged_write)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(3)
    geo = dict(level=7, window=20, guess_size=6)
    lanes, hq, hkv, d = 4, 32, 4, 64
    for page, nb in ((128, 8), (48, 22)):
        for causal, sw, s in ((False, 0, 240), (True, 0, 128),
                              (False, 300, 240), (True, 300, 128)):
            def mk(*shape):
                return torch.from_numpy(
                    rng.randn(*shape).astype(np.float32)).to(dev, dtype)
            slots_total = (lanes * nb + lanes) * page
            tables = torch.from_numpy(
                lanes + rng.permutation(lanes * nb)).to(dev).int().view(
                    lanes, nb).contiguous()
            slots = (tables.long()[:, :, None] * page
                     + torch.arange(page, device=dev)).reshape(-1)

            def pool():
                if int8_kv:
                    buf = {"q": torch.zeros(hkv, slots_total, d,
                                            dtype=torch.int8, device=dev),
                           "s": torch.full((hkv, slots_total, 1), 1e-8,
                                           device=dev)}
                else:
                    buf = torch.zeros(hkv, slots_total, d, dtype=dtype,
                                      device=dev)
                return paged_write(buf, slots, mk(lanes * nb * page, hkv, d))
            q, k, v = mk(lanes, s, hq, d), pool(), pool()
            kv_lens = torch.tensor([0, page + 1, 512, page * nb - s],
                                   dtype=torch.int32, device=dev)
            kw = dict(geo, causal=causal, sliding_window=sw)
            before = dict(la.paged_counts)
            got = la.paged_lookahead_attention(q, k, v, kv_lens, tables,
                                               page_size=page, **kw)
            assert la.paged_counts == dict(
                before, kernel=before["kernel"] + 1,
                **{la.design(dtype): before[la.design(dtype)] + 1})
            want = la.paged_lookahead_attention_ref(q, k, v, kv_lens, tables,
                                                    page_size=page, **kw)
            torch.testing.assert_close(got.float(), want.float(), **tol)
            kg, vg = (paged_gather(c, tables, page) for c in (k, v))
            for b in range(lanes):
                def lane(tree):
                    if isinstance(tree, dict):
                        return {n: a[b].contiguous() for n, a in tree.items()}
                    return tree[b].contiguous()
                flat = la.lookahead_attention(q[b], lane(kg), lane(vg),
                                              kv_lens[b:b + 1], **kw)
                assert torch.equal(flat, got[b])


@pytest.mark.gpu
def test_paged_attention_refusals_on_the_card():
    """On CUDA tensors the paged wrapper raises on what the kernel does not
    take; it never runs the plain version there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    q = torch.zeros(2, 27, 8, 64, device=dev)
    k = torch.zeros(2, 256, 64, device=dev)
    lens = torch.zeros(2, dtype=torch.int32, device=dev)
    tables = torch.zeros(2, 4, dtype=torch.int32, device=dev)
    geo = dict(level=4, window=5, guess_size=3)
    plain = la.paged_counts["plain"]
    with pytest.raises(ValueError, match="head_dim"):
        la.paged_lookahead_attention(q[..., :40].contiguous(),
                                     k[..., :40].contiguous(),
                                     k[..., :40].contiguous(), lens, tables,
                                     page_size=64, **geo)
    with pytest.raises(ValueError, match="whole pages"):
        la.paged_lookahead_attention(q, k, k, lens, tables, page_size=48,
                                     **geo)
    with pytest.raises(ValueError, match="one device"):
        la.paged_lookahead_attention(q, k, k, lens.cpu(), tables,
                                     page_size=64, **geo)
    assert la.paged_counts["plain"] == plain


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [
    # the same float32 sum in another order
    (torch.float32, dict(atol=2e-4, rtol=2e-4)),
    # both round one float32 value to bf16: at most one ulp apart
    (torch.bfloat16, dict(atol=1e-3, rtol=2.0 ** -7)),
])
def test_int4_micro_variants_match_plain_versions_and_int4_kernel(dtype, tol):
    """The shift variant equals the int4 kernel bit for bit; the K-outer
    variant is within ``tol`` of its plain version and of the int4 kernel,
    and a row alone gives the bits of the same row among T. Every tile
    shape, ragged N, a K whose packed rows are zero-padded; K-outer in
    bfloat16 at 1, 4, 11 and 22 slabs (1, 4 and 8 ranks a cluster)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from lookaheaddecoding_tpu_torch.ops import int4_micro as im
    from lookaheaddecoding_tpu_torch.ops import quant
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(4)
    for t, k, n in [(1, 2048, 5632), (8, 512, 80), (8, 5632, 2048),
                    (17, 2048, 2048), (240, 2048, 5632), (3, 11008, 4096),
                    (8, 2048, 32000), (8, 11008, 4096), (16, 5632, 16)]:
        w = torch.from_numpy(rng.randn(k, n).astype(np.float32) * 0.02)
        wq = quant.quantize_weight(w.to(dev), 4)
        k2 = quant.logical_packed_rows(wq)
        x = torch.from_numpy(rng.randn(t, k).astype(np.float32)).to(dev, dtype)
        before = dict(im.counts)
        b4 = qm.int4_matmul(x, wq["q4"], wq["scale"], logical_k2=k2)
        shift = im.int4_matmul_shift(x, wq["q4"], wq["scale"], logical_k2=k2)
        kouter = im.int4_matmul_kouter(x, wq["q4"], wq["scale"],
                                       logical_k2=k2)
        # bfloat16 runs the tensor-core K-outer design, float32 the FMA one
        design = "kouter_mma" if dtype == torch.bfloat16 else "kouter_fma"
        assert im.counts == dict(before, shift=before["shift"] + 1,
                                 **{design: before[design] + 1})
        assert torch.equal(shift, b4)
        torch.testing.assert_close(
            shift.float(),
            im.int4_matmul_shift_ref(x, wq["q4"], wq["scale"]).float(), **tol)
        torch.testing.assert_close(
            kouter.float(),
            im.int4_matmul_kouter_ref(x, wq["q4"], wq["scale"]).float(),
            **tol)
        torch.testing.assert_close(kouter.float(), b4.float(), **tol)
        r = t // 2
        one = im.int4_matmul_kouter(x[r:r + 1].contiguous(), wq["q4"],
                                    wq["scale"], logical_k2=k2)
        assert torch.equal(one[0], kouter[r])


@pytest.mark.gpu
def test_int4_kouter_mma_fragment_maps():
    """The tensor-core K-outer kernel element by element: x is one-hot, so
    y[t, n] is one weight nibble of packed row r_t times its scale, exact
    in any order of the sum, and every (row, column) must land where the
    plain version puts it: at 1, 2, 4, 11 and 22 slabs of 256 packed rows
    (clusters of 1, 2, 4 and 8 ranks; 11 and 22 slabs leave some ranks two
    or three), the rows r_t spread over K so that every rank's sum reaches
    the output, on 16-row tiles of 16 to 128 columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from lookaheaddecoding_tpu_torch.ops import int4_micro as im
    from lookaheaddecoding_tpu_torch.ops import quant
    dev = torch.device("cuda")
    rng = np.random.RandomState(8)
    for t, k2, n in ((16, 128, 16), (16, 512, 4224), (16, 1024, 5632),
                     (8, 2816, 2048), (16, 5504, 4096), (32, 5504, 256)):
        w = torch.from_numpy(rng.randn(2 * k2, n).astype(np.float32))
        wq = quant.quantize_weight(w.to(dev), 4)
        k2p = quant.logical_packed_rows(wq)
        rows = torch.from_numpy(rng.choice(k2, t, replace=False)).to(dev)
        for half in (0, 1):
            x = torch.zeros(t, 2 * k2, device=dev, dtype=torch.bfloat16)
            x[torch.arange(t), half * k2 + rows] = 1
            before = im.counts["kouter_mma"]
            got = im.int4_matmul_kouter(x, wq["q4"], wq["scale"],
                                        logical_k2=k2p)
            assert im.counts["kouter_mma"] == before + 1
            want = im.int4_matmul_kouter_ref(x, wq["q4"], wq["scale"])
            assert torch.equal(got, want), (t, k2, n, half)


# Gemma-2B's attention heads: 8 query heads on one KV head of 256
GEMMA_HEADS = dict(hq=8, hkv=1, d=256)
GEMMA_CASES = [  # s, m, kv_len, causal, sliding window, geometry
    (240, 1024, 512, False, 0, "big"), (240, 2048, 1808, False, 0, "big"),
    (128, 1024, 640, True, 0, "big"), (240, 1024, 600, False, 300, "big"),
    (128, 1024, 600, True, 300, "big"), (1, 1024, 700, True, 0, "big"),
    (27, 256, 37, False, 16, "small"), (27, 256, 0, False, 0, "small")]
GEOMETRIES = {"big": dict(level=7, window=20, guess_size=6),
              "small": dict(level=4, window=5, guess_size=3)}


def check_flat_head_dim(dtype, tol, int8_kv, hq, hkv, d, seed):
    """GEMMA_CASES at heads (hq, hkv, d) on a plain or an int8 cache: each
    call within ``tol`` of its plain version (the tolerances of the D=64
    tests), and in bfloat16 within the rounding limit of the float32
    kernel (chip_smoke's limit, as in
    test_bf16_attention_within_rounding_limit_of_float32_kernel)."""
    from lookaheaddecoding_tpu_torch.models.llama import kv_cache_write
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    for s, m, kv, causal, sw, geo in GEMMA_CASES:
        def mk(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
                dev, dtype)
        if int8_kv:
            def cache():
                c = {"q": torch.zeros(hkv, m, d, dtype=torch.int8, device=dev),
                     "s": torch.full((hkv, m, 1), 1e-8, device=dev)}
                return kv_cache_write(c, mk(m, hkv, d), 0)
            k, v = cache(), cache()
            kf, vf, v_abs = k, v, {"q": v["q"].abs(), "s": v["s"]}
        else:
            k, v = mk(hkv, m, d), mk(hkv, m, d)
            kf, vf = k.float(), v.float()
            v_abs = vf.abs()
        q = mk(s, hq, d)
        kv_len = torch.tensor([kv], dtype=torch.int32, device=dev)
        kw = dict(GEOMETRIES[geo], causal=causal, sliding_window=sw)
        before = dict(la.counts)
        got = la.lookahead_attention(q, k, v, kv_len, **kw)
        assert la.counts == dict(
            before, kernel=before["kernel"] + 1,
            **{la.design(dtype): before[la.design(dtype)] + 1})
        want = la.lookahead_attention_ref(q, k, v, kv_len, **kw)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        if dtype == torch.bfloat16:
            exact = la.lookahead_attention(q.float(), kf, vf, kv_len, **kw)
            weight = la.lookahead_attention(q.float(), kf, v_abs, kv_len,
                                            **kw)
            limit = 2.0 ** -8 * weight + 2.0 ** -7 * exact.abs() + 1e-4
            err = (got.float() - exact.bfloat16().float()).abs()
            assert bool((err <= limit).all()), (d, s, m, kv, causal, sw,
                                                (err / limit).max().item())


def check_paged_head_dim(dtype, tol, int8_kv, hq, hkv, d, seed):
    """The paged call at heads (hq, hkv, d): four lanes of different
    ``kv_len`` on shuffled pages of 128, composite and causal, with and
    without a sliding window; within ``tol`` of its plain version and each
    lane bit-equal to the flat kernel on its contiguous cache."""
    from lookaheaddecoding_tpu_torch.core.paged import (paged_gather,
                                                        paged_write)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    lanes, page, nb = 4, 128, 8
    for causal, sw, s in ((False, 0, 240), (True, 0, 128), (False, 300, 240),
                          (True, 300, 128)):
        def mk(*shape):
            return torch.from_numpy(
                rng.randn(*shape).astype(np.float32)).to(dev, dtype)
        slots_total = (lanes * nb + lanes) * page
        tables = torch.from_numpy(
            lanes + rng.permutation(lanes * nb)).to(dev).int().view(
                lanes, nb).contiguous()
        slots = (tables.long()[:, :, None] * page
                 + torch.arange(page, device=dev)).reshape(-1)

        def pool():
            if int8_kv:
                buf = {"q": torch.zeros(hkv, slots_total, d, dtype=torch.int8,
                                        device=dev),
                       "s": torch.full((hkv, slots_total, 1), 1e-8,
                                       device=dev)}
            else:
                buf = torch.zeros(hkv, slots_total, d, dtype=dtype,
                                  device=dev)
            return paged_write(buf, slots, mk(lanes * nb * page, hkv, d))
        q, k, v = mk(lanes, s, hq, d), pool(), pool()
        kv_lens = torch.tensor([0, page + 1, 512, page * nb - s],
                               dtype=torch.int32, device=dev)
        kw = dict(GEOMETRIES["big"], causal=causal, sliding_window=sw)
        got = la.paged_lookahead_attention(q, k, v, kv_lens, tables,
                                           page_size=page, **kw)
        want = la.paged_lookahead_attention_ref(q, k, v, kv_lens, tables,
                                                page_size=page, **kw)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        kg, vg = (paged_gather(c, tables, page) for c in (k, v))
        for b in range(lanes):
            def lane(tree):
                if isinstance(tree, dict):
                    return {n: a[b].contiguous() for n, a in tree.items()}
                return tree[b].contiguous()
            flat = la.lookahead_attention(q[b], lane(kg), lane(vg),
                                          kv_lens[b:b + 1], **kw)
            assert torch.equal(flat, got[b]), (d, causal, sw, b)


TOLS = [(torch.float32, dict(atol=1e-4, rtol=1e-4)),
        (torch.bfloat16, dict(atol=2e-2, rtol=2e-2))]


@pytest.mark.gpu
@pytest.mark.parametrize("int8_kv", [False, True], ids=["plain", "int8_kv"])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_attention_kernel_head_dim_256(dtype, tol, int8_kv):
    """head_dim 256 at Gemma-2B's heads (rep 8): composite at M=1024 and
    M=2048, causal prefill, a sliding window both ways, the one-row AR
    call, a small composite; a plain and an int8 cache (check_flat_head_dim)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    check_flat_head_dim(dtype, tol, int8_kv, seed=9, **GEMMA_HEADS)


@pytest.mark.gpu
@pytest.mark.parametrize("int8_kv", [False, True], ids=["plain", "int8_kv"])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_paged_attention_kernel_head_dim_256(dtype, tol, int8_kv):
    """The paged call at head_dim 256 and Gemma-2B's heads
    (check_paged_head_dim)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    check_paged_head_dim(dtype, tol, int8_kv, seed=10, **GEMMA_HEADS)


# head_dim 32, 80 and 96, each at Hq * D near 2048: (Hq, Hkv, D); 48 and
# 112 with GQA factors 5 and 3
SMALL_HEADS = {32: (64, 8, 32), 80: (32, 8, 80), 96: (32, 8, 96)}
MORE_HEADS = {48: (40, 8, 48), 112: (24, 8, 112)}


@pytest.mark.gpu
@pytest.mark.parametrize("d", sorted(SMALL_HEADS))
@pytest.mark.parametrize("int8_kv", [False, True], ids=["plain", "int8_kv"])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_attention_kernel_head_dims_32_80_96(dtype, tol, int8_kv, d):
    """head_dim 32, 80 and 96 (not powers of two but multiples of 16) on
    GEMMA_CASES: the flat call against its plain version and, in bfloat16,
    within the float32 kernel's rounding limit (check_flat_head_dim)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    hq, hkv, _ = SMALL_HEADS[d]
    check_flat_head_dim(dtype, tol, int8_kv, hq, hkv, d, seed=d)


@pytest.mark.gpu
@pytest.mark.parametrize("d", sorted(SMALL_HEADS))
@pytest.mark.parametrize("int8_kv", [False, True], ids=["plain", "int8_kv"])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_paged_attention_kernel_head_dims_32_80_96(dtype, tol, int8_kv, d):
    """The paged call at head_dim 32, 80 and 96: against its plain version
    and each lane bit-equal to the flat kernel (check_paged_head_dim)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    hq, hkv, _ = SMALL_HEADS[d]
    check_paged_head_dim(dtype, tol, int8_kv, hq, hkv, d, seed=d + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("d", sorted(MORE_HEADS))
@pytest.mark.parametrize("int8_kv", [False, True], ids=["plain", "int8_kv"])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_attention_kernel_head_dims_48_112(dtype, tol, int8_kv, d):
    """head_dim 48 and 112 on GEMMA_CASES, as 32, 80 and 96: the flat call
    against its plain version and, in bfloat16, within the float32
    kernel's rounding limit (check_flat_head_dim)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    hq, hkv, _ = MORE_HEADS[d]
    check_flat_head_dim(dtype, tol, int8_kv, hq, hkv, d, seed=d)


@pytest.mark.gpu
@pytest.mark.parametrize("d", sorted(MORE_HEADS))
@pytest.mark.parametrize("int8_kv", [False, True], ids=["plain", "int8_kv"])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_paged_attention_kernel_head_dims_48_112(dtype, tol, int8_kv, d):
    """The paged call at head_dim 48 and 112: against its plain version and
    each lane bit-equal to the flat kernel (check_paged_head_dim)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    hq, hkv, _ = MORE_HEADS[d]
    check_paged_head_dim(dtype, tol, int8_kv, hq, hkv, d, seed=d + 1)


@pytest.mark.gpu
def test_batched_verification_matches_its_cpu_result():
    """The SpecInfer verification (plain PyTorch) on the card, 512 lanes in
    one call, against the same call on the CPU with the same noise: equal
    hits, max_hit and winner (float32; a uniform within rounding of its
    threshold could flip a decision, which at 512 lanes of these
    distributions has not been seen)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.ops import sampling as ts
    rng = np.random.RandomState(3)
    B, G, GS, V = 512, 20, 6, 300

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    probs_next = softmax(rng.randn(B, V) * 3)
    guess_probs = softmax(rng.randn(B, G, GS, V) * 3)
    top = np.argsort(-probs_next, axis=1)[:, :3]
    tokens = np.take_along_axis(
        top[:, None, :], rng.randint(0, 3, size=(B, G * GS))[:, None, :],
        2).reshape(B, G, GS).astype(np.int32)
    valid = rng.rand(B, G) < 0.8
    u = rng.rand(B, ts.verify_noise_size(G, GS, V)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (probs_next, guess_probs, tokens,
                                          valid)]
    cpu = ts.rejection_sample_verify_core(
        *args, *ts.split_verify_noise(torch.from_numpy(u), G, GS, V))
    card = ts.rejection_sample_verify_core(
        *(a.cuda() for a in args),
        *ts.split_verify_noise(torch.from_numpy(u).cuda(), G, GS, V))
    for name in ("hits", "max_hit", "winner"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
    assert (cpu.max_hit > 0).any()


@pytest.mark.gpu
def test_sampling_paths_run_the_attention_kernels():
    """generate_sample, a sampling generate_stream and a sampling
    generate_batch on the card in bfloat16: the flat attention kernel (and
    the paged one for the batch) launch and no plain version runs. (A
    batch lane's tokens are held to its lone call in chip_smoke.py, on a
    model whose margins a bf16 product of other row counts cannot flip.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import lookaheaddecoding_tpu_torch as lt
    cfg = lt.LlamaConfig(vocab_size=256, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         dtype=torch.bfloat16)
    eng = lt.LookaheadEngine(
        cfg, lt.init_params(cfg, seed=0, scale=0.5, device="cuda"),
        lt.LookaheadConfig(level=4, window_size=5, guess_set_size=4,
                           pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=256, prefill_chunk=16))
    prompt = list(np.random.RandomState(0).randint(0, 256, size=20))
    scfg = lt.SamplingConfig(temperature=0.8, top_p=0.9)
    for tally in (la.counts, la.paged_counts):
        tally.update(dict.fromkeys(tally, 0))
    one = eng.generate_sample(prompt, 32, scfg, seed=1)
    stream = list(eng.generate_stream(prompt, 32, seed=1, sampling=scfg))
    assert la.counts["mma"] > 0 and la.counts["plain"] == 0
    np.testing.assert_array_equal(np.concatenate(stream), one.new_tokens)
    batch = eng.generate_batch([prompt, prompt[:9]], 32, sampling=scfg,
                               seeds=[1, 2])
    assert la.paged_counts["mma"] > 0 and la.paged_counts["plain"] == 0
    assert la.counts["fma"] == la.paged_counts["fma"] == 0
    assert all(r.num_generated == 32 for r in batch)


@pytest.mark.gpu
def test_continuous_batching_lanes_equal_flat_generate():
    """ContinuousBatchingEngine on the card in bfloat16 (fairness, two
    lanes, five requests of staggered budgets): every result equals the
    flat generate on its prompt, through the paged attention kernel for
    the lanes and the flat one for the prefills, with no plain version.
    The model follows a token cycle (unit embeddings scaled by sqrt(H), a
    head whose columns map each token to the next), whose top-2 margins
    no bf16 product of another row count can flip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import lookaheaddecoding_tpu_torch as lt
    cfg = lt.LlamaConfig(vocab_size=512, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         dtype=torch.bfloat16)
    params = lt.init_params(cfg, seed=0, scale=0.002, device="cuda")
    rng = np.random.RandomState(0)
    embed = rng.randn(512, 256).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    cycle = rng.choice(512, size=64, replace=False)
    nxt = np.full(512, cycle[0])
    nxt[cycle] = np.roll(cycle, -1)
    head = np.zeros((256, 512), np.float32)
    head[:, nxt[cycle]] = embed[cycle].T
    params["embed"] = torch.from_numpy(embed * 16.0).to("cuda", cfg.dtype)
    params["lm_head"] = torch.from_numpy(head).to("cuda", cfg.dtype)
    eng = lt.LookaheadEngine(
        cfg, params, lt.LookaheadConfig(level=4, window_size=5,
                                        guess_set_size=4,
                                        pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=256, prefill_chunk=16))

    def prompt(start, n):
        out = [int(nxt[start])]
        while len(out) < n:
            out.append(int(nxt[out[-1]]))
        return out
    reqs = [dict(prompt=prompt(3 * i, 10 + 7 * i), max_new_tokens=m,
                 request_id=i) for i, m in enumerate((24, 40, 16, 48, 32))]
    for tally in (la.counts, la.paged_counts):
        tally.update(dict.fromkeys(tally, 0))
    res = lt.ContinuousBatchingEngine(eng, num_lanes=2).run(
        [lt.Request(**r) for r in reqs])
    assert la.paged_counts["mma"] > 0 and la.counts["mma"] > 0
    assert la.counts["plain"] == la.paged_counts["plain"] == 0
    assert la.counts["fma"] == la.paged_counts["fma"] == 0
    for r in res:
        one = eng.generate(reqs[r.request_id]["prompt"],
                           reqs[r.request_id]["max_new_tokens"])
        np.testing.assert_array_equal(r.tokens, one.tokens)


def _tiny_train_model(device):
    import lookaheaddecoding_tpu_torch as lt
    cfg = lt.LlamaConfig(vocab_size=256, hidden_size=128,
                         intermediate_size=256, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         dtype=torch.float32)
    return cfg, lt.init_params(cfg, seed=0, scale=0.02, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_train_step_on_the_card_matches_the_cpu(optimizer):
    """Three steps of make_train_step on the card and on the CPU from the
    same float32 parameters (TF32 off): losses within rtol 1e-4 (another
    summation order); SGD's parameters within 1e-6. Adam divides each
    element by its own gradient's size, so an element whose gradient is at
    the noise of the two orders can move anywhere within lr a step: every
    element within 2 lr a step, and 99.9% within lr * 1e-3 a step
    (chip_smoke's phase-11 limits). The step runs where the parameters
    live."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.training import (init_opt_state,
                                                      make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    lr = 2e-3
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, 256, size=(4, 33)) for _ in range(3)]
    out = []
    for dev in ("cuda", "cpu"):
        cfg, params = _tiny_train_model("cpu")
        params = {k: ({n: t.to(dev) for n, t in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in params.items()}
        step = make_train_step(cfg, seq_len=64, learning_rate=lr,
                               optimizer=optimizer)
        opt = init_opt_state(params, optimizer)
        losses = []
        for b in batches:
            params, opt, loss = step(params, opt, b)
            losses.append(float(loss))
        assert params["layers"]["wq"].device.type == dev
        out.append((np.array(losses), params))
    (lc, pc), (lh, ph) = out
    np.testing.assert_allclose(lc, lh, rtol=1e-4)

    def flat(tree):
        return np.concatenate([
            x.cpu().numpy().ravel() for k in sorted(tree)
            for x in ([tree[k]] if not isinstance(tree[k], dict)
                      else [tree[k][n] for n in sorted(tree[k])])])
    diff = np.abs(flat(pc) - flat(ph))
    if optimizer == "adam":
        assert diff.max() <= 2 * lr * 3
        assert np.quantile(diff, 0.999) <= lr * 1e-3 * 3
    else:
        assert diff.max() <= 1e-6


@pytest.mark.gpu
def test_load_params_onto_the_card_round_trips(tmp_path):
    """A bf16 and an int4 tree saved and loaded with device='cuda': every
    leaf on the card, with its dtype and its bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    import lookaheaddecoding_tpu_torch as lt
    cfg, params = _tiny_train_model("cuda")
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    bf16 = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()}
                if isinstance(v, dict) else v.to(torch.bfloat16))
            for k, v in params.items()}
    for name, tree in (("bf16", bf16),
                       ("int4", lt.quantize_params(bf16, bits=4))):
        lt.save_params(str(tmp_path / name), cfg, tree)
        cfg2, tree2 = lt.load_params(str(tmp_path / name), device="cuda")
        assert cfg2 == cfg

        def check(a, b):
            if isinstance(a, dict):
                assert set(a) == set(b)
                for k in a:
                    check(a[k], b[k])
                return
            assert b.device.type == "cuda" and b.dtype == a.dtype
            assert torch.equal(a, b)
        check(tree, tree2)


@pytest.mark.gpu
def test_profiling_trace_records_the_attention_kernel(tmp_path):
    """utils.profiling.trace around a generate on the card writes one
    Chrome trace that names the bf16 attention kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.utils import profiling
    cfg = lt.LlamaConfig(vocab_size=256, hidden_size=128,
                         intermediate_size=256, num_hidden_layers=2,
                         num_attention_heads=2, num_key_value_heads=1,
                         dtype=torch.bfloat16)
    eng = lt.LookaheadEngine(
        cfg, lt.init_params(cfg, seed=0, scale=0.5, device="cuda"),
        lt.LookaheadConfig(level=4, window_size=5, guess_set_size=4),
        lt.EngineConfig(max_seq_len=256, prefill_chunk=16))
    prompt = list(np.random.RandomState(0).randint(0, 256, size=20))
    eng.generate(prompt, 8)
    timer = profiling.StepTimer()
    with profiling.trace(str(tmp_path)), timer:
        eng.generate(prompt, 16)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name", "") for e in json.loads(files[0].read_text())[
        "traceEvents"] if e.get("cat") == "kernel"}
    assert any("attention_mma_kernel" in n for n in names), sorted(names)
    assert timer.mean_ms > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8_kv", [False, True], ids=["plain", "int8_kv"])
def test_attention_kernel_row0_equals_rows_of_the_whole_call(dtype, int8_kv):
    """A lookahead-parallel rank's call: the kernel on composite rows
    [r0, r0 + n) with ``row0`` = r0 equals those rows of the whole call,
    bit for bit, for B1 (M = 1024) and B2 (M = 2048) at S = 240 split in
    two (D = 64, the headline's heads), and at an uneven split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from lookaheaddecoding_tpu_torch.models.llama import kv_cache_write
    dev = torch.device("cuda")
    rng = np.random.RandomState(5)
    geo = dict(level=7, window=20, guess_size=6)       # S = 240
    for m, kv in ((1024, 512), (2048, 1808)):
        def mk(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
                dev, dtype)
        q = mk(240, 32, 64)
        if int8_kv:
            k, v = ({"q": torch.zeros(4, m, 64, dtype=torch.int8, device=dev),
                     "s": torch.ones(4, m, 1, device=dev)} for _ in range(2))
            kv_cache_write(k, mk(m, 4, 64), 0)
            kv_cache_write(v, mk(m, 4, 64), 0)
        else:
            k, v = mk(4, m, 64), mk(4, m, 64)
        kv_len = torch.tensor([kv], dtype=torch.int32, device=dev)
        whole = la.lookahead_attention(q, k, v, kv_len, **geo)
        for r0, n in ((0, 120), (120, 120), (97, 143)):
            before = la.counts["kernel"]
            part = la.lookahead_attention(q[r0:r0 + n].contiguous(), k, v,
                                          kv_len, row0=r0, **geo)
            assert la.counts["kernel"] == before + 1
            assert torch.equal(part, whole[r0:r0 + n]), (m, r0, n)


@pytest.mark.gpu
def test_two_ranks_tp2_decode_on_one_card():
    """Two ranks on the one card over gloo (parallel/launch.py), tp=2 on a
    transition-cycle model in bfloat16: both ranks give the same tokens,
    those of the unsharded engine on the card, following the cycle, through
    the attention kernel's tensor-core design and no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.parallel.launch import launch
    worker = Path(__file__).with_name("torch_parallel_worker.py")
    ranks = launch(f"{worker}:card_tp2", 2, "gloo", "cuda", timeout=300)
    assert ranks[0]["tokens"] == ranks[1]["tokens"]
    for r in ranks:
        assert r["device"] == "cuda:0"
        assert r["tokens"] == r["one"] and r["cycle"]
        assert r["launches"]["mma"] > 0
        assert r["launches"]["plain"] == r["launches"]["fma"] == 0


@pytest.mark.gpu
def test_one_rank_nccl_mesh_engine_is_captured():
    """A one-rank NCCL world (the card takes one NCCL rank): chip_smoke's
    phase 14, whose engine on ``make_mesh(tp=1)`` runs ``generate``,
    ``generate_baseline``, ``generate_sample`` and a two-lane
    ``generate_batch`` on the device loop (one launch, an iteration a
    step, one read and no host sync before it) with the tokens, steps,
    pool rows and branches of its eager run and of the engine without a
    mesh, and whose WHILE node over the world group's NCCL collectives
    runs with the plain version's result; and the train step on that mesh,
    captured and bit-equal to its eager steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from lookaheaddecoding_tpu_torch.parallel.launch import launch
    chip_smoke.nccl_phase(chip_smoke.nvidia_smi())
    worker = Path(__file__).with_name("torch_parallel_worker.py")
    r, = launch(f"{worker}:card_nccl_train_one_rank", 1, "nccl", "cuda",
                timeout=300)
    assert r["backend"] == "nccl"
    assert r["train_bit_equal"] and r["train_graphs"] == 1


def _graph_engine(dtype=torch.bfloat16, kv_quant=None, bits=None):
    """A small random engine on the card (the attention kernel, and the
    quantized products with ``bits``)."""
    import lookaheaddecoding_tpu_torch as lt
    cfg = lt.LlamaConfig(vocab_size=256, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         dtype=dtype)
    params = lt.init_params(cfg, seed=0, scale=0.5, device="cuda")
    if bits:
        params = lt.quantize_params(params, bits=bits)
    return lt.LookaheadEngine(
        cfg, params, lt.LookaheadConfig(level=4, window_size=5,
                                        guess_set_size=4,
                                        pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=256, prefill_chunk=16,
                        kv_quant=kv_quant))


def _tallies():
    from lookaheaddecoding_tpu_torch.ops import quant_matmul as qm
    return (la.counts, la.paged_counts, qm.counts)


def _counted(call):
    """call()'s result and the kernels' launches it made."""
    for t in _tallies():
        t.update(dict.fromkeys(t, 0))
    out = call()
    torch.cuda.synchronize()
    return out, [dict(t) for t in _tallies()]


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["bf16", "f32", "int8_kv", "int8_weights",
                                    "int4_weights"])
def test_graphed_entry_points_equal_eager(config):
    """Every flat entry point on the card replays captured steps, and gives
    the tokens and steps of the same call run eagerly (``graphs.eager()``)
    on the same engine: generate, generate_baseline, generate_sample at a
    seed (top-p on and off), generate_stream, generate_batch greedy and
    sampling, a prefix call. Captures happen once a key, later calls only
    replay, and the kernels' launch counts of a graphed call equal the
    eager call's (capture counts a launch once a replay)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.core import graphs
    eng = _graph_engine(
        dtype=torch.float32 if config == "f32" else torch.bfloat16,
        kv_quant="int8" if config == "int8_kv" else None,
        bits={"int8_weights": 8, "int4_weights": 4}.get(config))
    rng = np.random.RandomState(0)
    p = list(rng.randint(0, 256, size=20))
    q = list(rng.randint(0, 256, size=33))
    top_p = lt.SamplingConfig(temperature=0.8, top_k=30, top_p=0.9)
    no_top_p = lt.SamplingConfig(temperature=1.1)
    pc = eng.precompute_prefix(q[:12])
    calls = {
        "generate": lambda: [eng.generate(p, 40)],
        "generate_baseline": lambda: [eng.generate_baseline(p, 24)],
        "sample_top_p": lambda: [eng.generate_sample(q, 40, top_p, seed=3)],
        "sample": lambda: [eng.generate_sample(p, 40, no_top_p, seed=4)],
        "stream": lambda: [np.concatenate(list(eng.generate_stream(
            q, 40, sampling=top_p, seed=5, steps_per_yield=3)))],
        "stream_ar": lambda: [np.concatenate(list(eng.generate_stream(
            p, 16, lookahead=False)))],
        "prefix": lambda: [eng.generate(q, 32, prefix=pc)],
        "batch": lambda: eng.generate_batch([p, q, p[:9]], 32),
        "batch_sample": lambda: eng.generate_batch(
            [q, p], 32, sampling=top_p, seeds=[6, 7],
            temperatures=[0.7, 1.2]),
    }

    def tokens(res):
        return [getattr(r, "tokens", r) for r in res]
    for name, call in calls.items():
        with graphs.eager():
            want, eager_counts = _counted(call)
        call()          # the first graphed call captures
        captured = graphs.stats["captured"]
        got, graphed_counts = _counted(call)
        assert graphs.stats["captured"] == captured, name   # replays only
        for g, w in zip(tokens(got), tokens(want)):
            np.testing.assert_array_equal(g, w, name)
        assert [getattr(r, "steps", 0) for r in got] == \
            [getattr(r, "steps", 0) for r in want], name
        assert graphed_counts == eager_counts, (name, graphed_counts,
                                                eager_counts)
    assert graphs.stats["replays"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["bf16", "int8_kv", "int8_weights"])
def test_captured_prefill_equals_eager_without_a_sync(config):
    """The request's preparation on the card, JAX's fused prepare call: at
    prompt lengths 1 (no chunk), 9, 17, 100 and 230 (15 chunks of 16,
    within a slot of the capacity), and past a 40-token prefix, the slot
    after ``_prepare`` is bit-equal to the eager one (caches, ``kv_len``,
    pool, window, output buffer); a warm engine's graphed preparation
    replays the slot's captured chunk once a chunk and captures nothing;
    and from its start to the first decode replay nothing waits for the
    card (``torch.cuda.set_sync_debug_mode("error")`` raises on a sync)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.core import graphs
    eng = _graph_engine(kv_quant="int8" if config == "int8_kv" else None,
                        bits=8 if config == "int8_weights" else None)
    base = list(np.random.RandomState(2).randint(0, 256, size=230))
    pc = eng.precompute_prefix(base[:40])

    def prepare(p, prefix, checked=False):
        """The slot's tensors after ``_prepare``; then one decode step."""
        out_buf, n, fill = eng._host_args(p, 16, prefix)
        if checked:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.inference_mode():
                slot = eng._free_slot()
                eng._prepare(out_buf, n, 0, fill, prefix, slot=slot)
                kept = [t.clone() for t in graphs.state_tensors(slot.state)]
                eng._flat_runner(slot, "greedy", 16, None).run(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return kept

    for n in (1, 9, 17, 100, 230):
        for prefix in (None, pc) if n > 41 else (None,):
            p = base[:n]
            with graphs.eager():
                want = prepare(p, prefix)
            prepare(p, prefix)             # the first graphed call captures
            before = dict(graphs.stats)
            got = prepare(p, prefix, checked=True)
            torch.cuda.synchronize()
            start0 = 0 if prefix is None else prefix.length
            chunks = -(-max(n - 1 - start0, 0) // 16)
            assert graphs.stats["captured"] == before["captured"], n
            assert graphs.stats["prefills"] - before["prefills"] == chunks
            assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                (config, n, start0)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["bf16", "int8_kv_int8_weights"])
def test_captured_paged_admission_equals_eager_without_a_sync(config):
    """Paged admission on the card (JAX's ``_get_prepare``) at the
    headline's widths (TinyLlama-1.1B: hidden 2048, intermediate 5632, 32
    query and 4 KV heads of 64, vocab 32000; 2 layers), L7/W20/G20, M=1024,
    chunks and pages of 128, four lanes: a 64-token and a 700-token prompt
    (6 chunks across 6 pages) with another lane live, and a request on a
    200-token prefix (its tail page copied on write). The lane's row and
    its data pages after ``_admit`` are bit-equal to the eager admission's;
    a warm engine's graphed admission replays the captured chunk once a
    chunk and captures nothing; and from the lane's choice to the first
    batched replay nothing waits for the card
    (``torch.cuda.set_sync_debug_mode("error")`` raises on a sync)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.core import graphs
    cfg = lt.LlamaConfig(vocab_size=32000, hidden_size=2048,
                         intermediate_size=5632, num_hidden_layers=2,
                         num_attention_heads=32, num_key_value_heads=4,
                         max_position_embeddings=2048, dtype=torch.bfloat16)
    params = lt.init_params(cfg, seed=0, scale=0.02, device="cuda")
    int8 = config != "bf16"
    if int8:
        params = lt.quantize_params(params, bits=8)
    srv = lt.PagedServingEngine(
        cfg, params, lt.LookaheadConfig(level=7, window_size=20,
                                        guess_set_size=20,
                                        pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=1024, prefill_chunk=128,
                        kv_quant="int8" if int8 else None),
        num_lanes=4, page_size=128, n_pages=24)
    rng = np.random.RandomState(3)
    base = list(rng.randint(0, 32000, size=700))
    srv.generate(base[:300], 8)                 # captures chunk and step
    px = srv.precompute_prefix(base[:200])
    srv.submit(lt.Request(prompt=base[:64], max_new_tokens=64))
    srv.step()                                  # lane 0 live
    st = srv._states

    def admit(p, prefix, checked=False):
        """Lane 1's row and data pages after ``_admit`` (then, checked,
        one batched step), and graphs.stats of the call; then lane 1 is
        undone: its pages back in reverse order, the lane idle."""
        srv.submit(lt.Request(prompt=p, max_new_tokens=32, prefix=prefix))
        graphs.reset_stats()
        torch.cuda.synchronize()
        if checked:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.inference_mode():
                srv._admit()
                row = [t[1].clone() for t in (
                    st.table, st.kv_len, st.window, st.out_buf,
                    st.n_confirmed, st.init_len, st.pool.values, st.pool.age,
                    st.pool.clock, srv._eos)]
                if checked:
                    srv._runner().run(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        stats = graphs.read_stats()
        pages = sorted(set(st.table[1].tolist()) - {1})
        idx = (torch.tensor(pages)[:, None] * 128
               + torch.arange(128)).reshape(-1).cuda()
        kv = [t.index_select(2, idx).clone()
              for t in graphs.state_tensors((srv._k_pool, srv._v_pool))]
        meta = srv._meta.pop(1)
        srv.alloc.release(list(reversed(meta["shared"] + meta["priv"])))
        srv._idle(1)
        return row + kv, stats

    for p, prefix in ((base[:64], None), (base, None),
                      (base[:240], px)):
        with graphs.eager():
            want, _ = admit(p, prefix)
        got, stats = admit(p, prefix)
        start0 = 0 if prefix is None else prefix.length
        chunks = -(-(len(p) - 1 - start0) // 128)
        assert stats["captured"] == 0 and stats["prefills"] == chunks
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            (config, len(p))
        admit(p, prefix, checked=True)
    while srv.step():
        pass
    srv.release_prefix(px)
    assert srv.pages_free == 24


@pytest.mark.gpu
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sample"])
def test_graphed_serving_engines_equal_eager(sampled):
    """PagedServingEngine and ContinuousBatchingEngine on the card replay
    their batched step; every result equals the same run made eagerly on
    the same engine."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.core import graphs
    eng = _graph_engine()
    sc = lt.SamplingConfig(temperature=0.9, top_p=0.9) if sampled else None
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(0, 256, size=n)) for n in (9, 30, 17, 22)]

    def reqs():
        return [lt.Request(prompt=pr, max_new_tokens=24 + 4 * i, seed=i,
                           request_id=i,
                           top_p=0.8 if sampled and i == 2 else None)
                for i, pr in enumerate(prompts)]
    paged = lt.PagedServingEngine(eng.mcfg, eng.params, eng.lcfg, eng.ecfg,
                                  num_lanes=2, page_size=64, sampling=sc)
    cb = lt.ContinuousBatchingEngine(eng, num_lanes=2, steps_per_sync=2,
                                     sampling=sc)
    for srv in (paged, cb):
        with graphs.eager():
            want = {r.request_id: r.tokens for r in srv.run(reqs())}
        before = graphs.stats["replays"]
        got = {r.request_id: r.tokens for r in srv.run(reqs())}
        assert graphs.stats["replays"] > before
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.gpu
def test_graphed_pool_update_takes_and_skips_its_if_node():
    """The pool update captured with its chain as an IF node, replayed over
    batches with and without two valid lanes of one key (stacked pools of
    two, as the lanes keep them): after each replay rows [0, R) and the
    clocks equal the eager update's bit for bit, and the graph's device
    counter counts exactly the batches that chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.core import graphs
    from lookaheaddecoding_tpu_torch.core import pool as tpool
    rows, g, gs, k = 40, 3, 2, 8
    rng = np.random.RandomState(0)

    def stacked():
        p = tpool.pool_init(rows, g, gs, device="cuda")
        return tpool.PoolState(p.values[None].repeat(2, 1, 1, 1).contiguous(),
                               p.age[None].repeat(2, 1, 1).contiguous(),
                               p.clock[None].repeat(2).contiguous())
    graphed, eager = stacked(), stacked()
    keys = torch.zeros(2, k, dtype=torch.int32, device="cuda")
    tups = torch.zeros(2, k, gs, dtype=torch.int32, device="cuda")
    valid = torch.zeros(2, k, dtype=torch.bool, device="cuda")
    runner = graphs.StepGraph(
        lambda: tpool.pool_update(graphed, keys, tups, valid),
        (graphed, keys, tups, valid))
    chains = []
    for i in range(12):
        kb = np.stack([rng.permutation(rows)[:k] for _ in range(2)])
        if i % 3 == 1:
            kb[1, 3] = kb[1, 0]             # lane 3 chains onto lane 0
        vb = rng.rand(2, k) < 0.8
        vb[1, [0, 3]] = True
        kb[0, ~vb[0]] = kb[0, 0]            # invalid duplicates never chain
        keys.copy_(torch.from_numpy(kb))
        tups.copy_(torch.from_numpy(rng.randint(0, 3, size=(2, k, gs))))
        valid.copy_(torch.from_numpy(vb))
        with graphs.eager():
            tpool.pool_update(eager, keys, tups, valid)
        runner.run(1)                        # the warm step, then replays
        if i:
            chains.append(i % 3 == 1)
        assert torch.equal(graphed.values[:, :rows], eager.values[:, :rows])
        assert torch.equal(graphed.age[:, :rows], eager.age[:, :rows])
        assert torch.equal(graphed.clock, eager.clock)
    assert runner.conds == 1
    assert runner.branches() == (sum(chains), len(chains))


@pytest.mark.gpu
def test_graphed_steps_keep_the_pool_and_branch_counts_of_eager():
    """generate and generate_batch on the card, graphed and eagerly on one
    engine: tokens, steps, the pool tables' rows [0, R) and the clock
    (from return_prefix), and the branches evaluated and chains taken
    (``graphs.read_stats``) equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.core import graphs
    eng = _graph_engine()
    rng = np.random.RandomState(3)
    p = list(rng.randint(0, 8, size=24))
    q = list(rng.randint(0, 256, size=30))
    runs = {}
    for which in ("eager", "graphed"):
        ctx = graphs.eager() if which == "eager" else torch.no_grad()
        with ctx:
            if which == "graphed":
                eng.generate(p, 40)              # captures
                eng.generate_batch([p, q], 24)
            graphs.reset_stats()
            r = eng.generate(p, 40, return_prefix=True)
            b = eng.generate_batch([p, q], 24)
            runs[which] = (r, b, graphs.read_stats())
    (r1, b1, s1), (r2, b2, s2) = runs["eager"], runs["graphed"]
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    assert r1.steps == r2.steps
    for x, y in zip(b1, b2):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    for name in ("values", "age"):
        a, c = getattr(r1.prefix.pool, name), getattr(r2.prefix.pool, name)
        assert torch.equal(a[:-1], c[:-1]), name
    assert torch.equal(r1.prefix.pool.clock, r2.prefix.pool.clock)
    assert (s1["branches"], s1["taken"]) == (s2["branches"], s2["taken"])
    assert s2["replays"] > 0 and s2["branches"] > 0


@pytest.mark.gpu
def test_capture_raises_when_the_if_node_fails_on_the_card(monkeypatch):
    """The IF node's host function failing as a CUDA runtime without
    conditional nodes does (cudaErrorNotSupported): the first graphed
    generate raises, naming the PyTorch version, instead of capturing the
    chain rounds unconditionally or stepping eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import re
    from lookaheaddecoding_tpu_torch.ops import graph_cond
    launch = graph_cond._launch
    monkeypatch.setattr(graph_cond, "_launch", lambda op, *args: (
        801 if op == 0 else launch(op, *args)))
    eng = _graph_engine()
    with pytest.raises(RuntimeError, match=re.escape(torch.__version__)):
        eng.generate(list(range(20)), 24)


@pytest.mark.gpu
def test_if_node_kernel_matches_its_plain_version():
    """The IF node (csrc/graph_cond.cu) in a captured graph of three nodes
    on three predicates, replayed over every pattern of them: each body
    (an add to its own counter) runs exactly when the plain version runs
    it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.ops import graph_cond
    preds = torch.zeros(3, dtype=torch.bool, device="cuda")
    got = torch.zeros(3, dtype=torch.int64, device="cuda")
    body_stream = graph_cond.body_stream("cuda")
    graph = torch.cuda.CUDAGraph()
    before = graph_cond.counts["set_if"]
    with torch.cuda.graph(graph):
        for i in range(3):
            graph_cond.if_node(preds[i], lambda i=i: got[i].add_(1),
                               body_stream)
    assert graph_cond.counts["set_if"] == before + 3
    want = torch.zeros(3, dtype=torch.int64)
    for pattern in range(8):
        flags = [bool(pattern >> i & 1) for i in range(3)]
        preds.copy_(torch.tensor(flags))
        graph.replay()
        for i, f in enumerate(flags):
            graph_cond.if_node_ref(torch.tensor(f),
                                   lambda i=i: want[i].add_(1))
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_captured_train_step_equals_eager_on_the_card(optimizer):
    """Three steps of make_train_step on the card replayed from its CUDA
    graph and three run eagerly (``graphs.eager()``) from the same float32
    parameters and batches: losses and every parameter bit-equal (the same
    kernels in the same order), the arguments unchanged, one graph key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.core import graphs
    from lookaheaddecoding_tpu_torch.training import (init_opt_state,
                                                      make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _tiny_train_model("cuda")
    rng = np.random.RandomState(2)
    batches = [torch.from_numpy(rng.randint(0, 256, size=(4, 33))).cuda()
               for _ in range(3)]
    step = make_train_step(cfg, seq_len=64, learning_rate=2e-3,
                           optimizer=optimizer)
    out = {}
    for which in ("eager", "graphed"):
        ctx = graphs.eager() if which == "eager" else torch.enable_grad()
        p, o, losses = params, init_opt_state(params, optimizer), []
        with ctx:
            for b in batches:
                kept = [t.clone() for t in graphs.state_tensors((p, o))]
                p2, o2, loss = step(p, o, b)
                assert all(torch.equal(x, y) for x, y in zip(
                    graphs.state_tensors((p, o)), kept))
                p, o = p2, o2
                losses.append(loss)
        torch.cuda.synchronize()
        out[which] = (graphs.state_tensors((p, o)), torch.stack(losses))
    assert len(step.graphs) == 1
    assert torch.equal(out["eager"][1], out["graphed"][1])
    assert all(torch.equal(x, y) for x, y in zip(out["eager"][0],
                                                  out["graphed"][0]))


def _while_graph(body, finished, cap, iters, pool=None):
    """A captured graph of one WHILE node (``ops/graph_cond.py``) over
    ``body``."""
    from lookaheaddecoding_tpu_torch.ops import graph_cond
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graph_cond.while_node(finished, cap, iters, body,
                              graph_cond.body_stream("cuda"), pool)
    return graph


@pytest.mark.gpu
def test_while_node_runs_its_body_n_times():
    """The WHILE node (csrc/graph_cond.cu) over a one-add body: a replay
    runs it exactly ``cap`` times while the flag stays clear, 0 times when
    the flag starts set (the condition kernel upstream of the node reads
    it), and 1 at a cap of 1; three flags that the body sets after 2, 5 and
    3 iterations stop it after 5, the body's allocations in a MemPool; each
    as its plain version counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.ops import graph_cond
    x = torch.zeros((), dtype=torch.int64, device="cuda")
    finished = torch.zeros(1, dtype=torch.bool, device="cuda")
    cap = torch.tensor([7], dtype=torch.int32, device="cuda")
    iters = torch.zeros(1, dtype=torch.int32, device="cuda")
    graph = _while_graph(lambda: x.add_(1), finished, cap, iters)
    for flag, n in ((False, 7), (True, 0), (False, 1)):
        if n == 1:
            cap.fill_(1)
        finished.fill_(flag)
        before = int(x)
        graph.replay()
        runs = []
        plain = torch.tensor([flag])
        graph_cond.while_node(plain, cap.cpu(), torch.zeros(1,
                              dtype=torch.int32), lambda: runs.append(1),
                              None)
        assert (int(x) - before, int(iters)) == (n, n) == (len(runs), n)
    counter = torch.zeros(3, dtype=torch.int32, device="cuda")
    lanes = torch.zeros(3, dtype=torch.bool, device="cuda")
    limit = torch.tensor([2, 5, 3], dtype=torch.int32, device="cuda")
    cap.fill_(100)

    def body():
        counter.add_((~lanes).int())
        lanes.copy_(counter >= limit)        # allocates: the pool holds it
    pool = torch.cuda.MemPool()
    graph = _while_graph(body, lanes, cap, iters, pool)
    graph.replay()
    assert counter.tolist() == [2, 5, 3] and int(iters) == 5


@pytest.mark.gpu
def test_while_body_holding_a_host_copy_raises():
    """A WHILE body that copies to pinned host memory (a node a
    conditional body cannot hold) fails its capture, naming the node."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros(4, device="cuda")
    host = torch.zeros(4).pin_memory()
    finished = torch.zeros(1, dtype=torch.bool, device="cuda")
    cap = torch.tensor([2], dtype=torch.int32, device="cuda")
    iters = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="memcpy node"):
        _while_graph(lambda: host.copy_(x, non_blocking=True), finished,
                     cap, iters)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["bf16", "f32", "int8_kv",
                                    "int8_weights"])
def test_device_loop_equals_eager_without_a_sync(config, monkeypatch):
    """Greedy ``generate`` (from a prefix too, and with ``return_prefix``),
    ``generate_baseline`` and a three-lane greedy ``generate_batch`` on the
    card launch their decode loop once (``graphs.LoopGraph``: a WHILE node
    around the captured step, the pool's chain an IF node in its body) and
    equal the same call run eagerly on the same engine bit for bit:
    tokens, steps, pool tables (rows [0, R), clock), branches taken and
    the kernels' launches; a step is an iteration; and from the request's
    start to its final transfer (``graphs.fetch``, one a call) nothing
    waits for the card (``torch.cuda.set_sync_debug_mode("error")``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.core import graphs
    eng = _graph_engine(
        dtype=torch.float32 if config == "f32" else torch.bfloat16,
        kv_quant="int8" if config == "int8_kv" else None,
        bits=8 if config == "int8_weights" else None)
    rng = np.random.RandomState(1)
    p = list(rng.randint(0, 256, size=20))
    q = list(rng.randint(0, 256, size=37))
    pc = eng.precompute_prefix(q[:14])
    calls = {
        "generate": lambda: [eng.generate(p, 48, return_prefix=True)],
        "prefix": lambda: [eng.generate(q, 40, prefix=pc,
                                        return_prefix=True)],
        "generate_baseline": lambda: [eng.generate_baseline(p, 32)],
        "baseline_prefix": lambda: [eng.generate_baseline(q, 24,
                                                          prefix=pc)],
        "batch": lambda: eng.generate_batch([p, q, p[:9]], 32),
    }

    def pools(name, res):
        if name == "batch":
            pool = eng._lane_slots[3].states.pool
            return [pool.values[:, :-1].clone(), pool.age[:, :-1].clone(),
                    pool.clock.clone()]
        return [t for r in res if r.prefix is not None for t in (
            r.prefix.pool.values[:-1], r.prefix.pool.age[:-1],
            r.prefix.pool.clock)]

    fetches, fetch = [], graphs.fetch

    def first_read(tensor):
        fetches.append(1)
        torch.cuda.set_sync_debug_mode("default")   # the call's one read
        return fetch(tensor)
    monkeypatch.setattr(graphs, "fetch", first_read)
    for name, call in calls.items():
        with graphs.eager():
            graphs.reset_stats()
            want, eager_counts = _counted(call)
            eager_st, eager_pools = graphs.read_stats(), pools(name, want)
        call()                   # the first graphed call captures
        torch.cuda.synchronize()
        graphs.reset_stats()
        for t in _tallies():
            t.update(dict.fromkeys(t, 0))
        fetches.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        graphed_counts = [dict(t) for t in _tallies()]
        assert fetches == [1], name
        st = graphs.read_stats()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.tokens, w.tokens, name)
            assert g.steps == w.steps, name
        assert all(torch.equal(a, b) for a, b in zip(pools(name, got),
                                                     eager_pools)), name
        assert st["loops"] == 1 and st["captured"] == 0, (name, st)
        assert st["replays"] == max(r.steps for r in got), (name, st)
        assert (st["branches"], st["taken"]) == (eager_st["branches"],
                                                 eager_st["taken"]), name
        assert graphed_counts == eager_counts, (name, graphed_counts,
                                                eager_counts)


@pytest.mark.gpu
def test_loop_graph_refuses_a_random_step_and_a_mesh_on_the_card(
        monkeypatch):
    """A step that draws from a CUDA generator of its state (a replay
    advances philox offsets on the host, so a device loop would repeat
    the noise) fails the loop's capture before anything is recorded; a
    mesh that does not capture (a gloo group) is refused when the loop is
    made; neither steps from the host instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from types import SimpleNamespace
    from lookaheaddecoding_tpu_torch.core import graphs
    x = torch.zeros(4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    finished = torch.zeros(1, dtype=torch.bool, device="cuda")
    cap = torch.tensor([8], dtype=torch.int32, device="cuda")
    loop = graphs.LoopGraph(
        lambda: x.add_(torch.rand(4, generator=gen, device="cuda")),
        {"x": x, "rng": gen}, finished, cap, body_pool=torch.cuda.MemPool())
    before = dict(graphs.stats)
    with pytest.raises(RuntimeError, match="drew random numbers"):
        loop.run()
    assert loop.graph is None
    assert graphs.stats["loops"] == before["loops"]
    monkeypatch.setattr(graphs.dist, "get_backend", lambda group: "gloo")
    with pytest.raises(ValueError, match="mesh only when the mesh captures"):
        graphs.LoopGraph(lambda: None, {"x": x}, finished, cap,
                         mesh=SimpleNamespace(groups={"tp": object()}))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,n", [(1, 192_140), (4, 192_140), (3, 13),
                                     (2, 1)])
def test_philox_kernel_matches_plain_version(lanes, n):
    """The Philox kernel (``ops/csrc/philox.cu``) gives the plain version's
    words bit for bit, and its uniforms, for both tags and counters past
    2**32; 192,140 uniforms a lane is the headline's draw (a verification
    at G = 20, GS = 6, V = 32000, and the EOS filter's W = 20)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from lookaheaddecoding_tpu_torch.ops import philox
    rng = np.random.RandomState(lanes + n)
    key = torch.from_numpy(rng.randint(-2**31, 2**31, size=(lanes, 2))
                           .astype(np.int32))
    draws = torch.from_numpy(np.array([0, 1, 2**32 + 5, 77][:lanes]
                                      + [3] * max(0, lanes - 4), np.int64))
    for tag in (philox.STEP, philox.WINDOW):
        want_bits = philox.bits(key, draws, n, tag)
        want_u = philox.uniforms(key, draws, n, tag)
        before = philox.counts["kernel"]
        got_bits = philox.bits(key.cuda(), draws.cuda(), n, tag)
        got_u = philox.uniforms(key.cuda(), draws.cuda(), n, tag)
        torch.cuda.synchronize()
        assert philox.counts["kernel"] == before + 2
        assert torch.equal(got_bits.cpu(), want_bits), tag
        assert torch.equal(got_u.cpu(), want_u), tag


@pytest.mark.gpu
def test_captured_philox_launch_reads_the_current_counter():
    """A launch captured in a CUDA graph reads ``draws`` from device memory:
    each replay, after the graph's own ``draws += 1``, draws the next
    counter's numbers, which equal the plain version's at that counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lookaheaddecoding_tpu_torch.ops import philox
    key = torch.tensor([[11, -3], [5, 0]], dtype=torch.int32, device="cuda")
    draws = torch.zeros(2, dtype=torch.int64, device="cuda")
    out = torch.zeros(2, 1000, device="cuda")
    philox.uniforms(key, draws, 1000)              # build and load first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(philox.uniforms(key, draws, 1000))
        draws.add_(1)
    draws.zero_()
    for i in range(4):
        graph.replay()
        torch.cuda.synchronize()
        want = philox.uniforms(key.cpu(), torch.full((2,), i), 1000)
        assert torch.equal(out.cpu(), want), i
    assert draws.tolist() == [4, 4]


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["bf16", "int8_weights"])
def test_sampling_device_loop_equals_eager_without_a_sync(config,
                                                          monkeypatch):
    """``generate_sample`` (top-k, top-p, EOS-ended, on a prefix with
    ``return_prefix``), a three-lane sampled ``generate_batch`` with
    per-lane temperatures and a greedy ``always_fwd_one=False`` call on the
    card launch their decode loop once, draw from the Philox kernel inside
    it, and equal the host loop and the same call run eagerly, bit for
    bit: tokens, steps, pool rows [0, R) and clock, and the final draw
    counters; a step is an iteration; the EOS-ended call runs the steps it
    needs; and nothing waits for the card before the call's one read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import lookaheaddecoding_tpu_torch as lt
    from lookaheaddecoding_tpu_torch.core import graphs
    from lookaheaddecoding_tpu_torch.ops import philox
    bits = 8 if config == "int8_weights" else None
    eng = _graph_engine(bits=bits)
    refill = lt.LookaheadEngine(
        eng.mcfg, eng.params, dataclasses.replace(eng.lcfg,
                                                  always_fwd_one=False),
        eng.ecfg)
    rng = np.random.RandomState(2)
    p = list(rng.randint(0, 256, size=20))
    q = list(rng.randint(0, 256, size=37))
    pc = eng.precompute_prefix(q[:14])
    top_k = lt.SamplingConfig(temperature=0.9, top_k=30)
    top_p = lt.SamplingConfig(temperature=0.8, top_p=0.9)
    with graphs.eager():
        eos = int(eng.generate_sample(p, 48, top_k, seed=3).tokens[len(p) + 6])
    calls = {
        "top_k": (eng, lambda h: [eng._run("sample", p, 48, None, 3,
                                           sampling=top_k, host_loop=h,
                                           return_prefix=True)]),
        "top_p": (eng, lambda h: [eng._run("sample", q, 40, None, 4,
                                           sampling=top_p, host_loop=h,
                                           return_prefix=True)]),
        "eos": (eng, lambda h: [eng._run("sample", p, 48, eos, 3,
                                         sampling=top_k, host_loop=h,
                                         return_prefix=True)]),
        "prefix": (eng, lambda h: [eng._run("sample", q, 40, None, 5,
                                            prefix=pc, sampling=top_k,
                                            host_loop=h,
                                            return_prefix=True)]),
        "batch": (eng, lambda h: eng._batch([p, q, p[:9]], 32, None, 0,
                                            [6, 7, 8], None, top_p,
                                            [0.7, 1.0, 1.2], None,
                                            host_loop=h)),
        "refill": (refill, lambda h: [refill._run("greedy", p, 48, None, 1,
                                                  host_loop=h,
                                                  return_prefix=True)]),
    }

    def outcome(e, name, res):
        if name == "batch":
            st = e._lane_slots[3].states
            tabs = [st.pool.values[:, :-1], st.pool.age[:, :-1],
                    st.pool.clock]
            draws = st.draws
        else:
            pool = res[0].prefix.pool
            tabs = [pool.values[:-1], pool.age[:-1], pool.clock]
            draws = e._slots[0].state.draws
        return ([r.tokens.tolist() for r in res], [r.steps for r in res],
                [t.cpu() for t in tabs], draws.cpu().view(-1).tolist())

    fetches, fetch = [], graphs.fetch

    def first_read(tensor):
        fetches.append(1)
        torch.cuda.set_sync_debug_mode("default")   # the call's one read
        return fetch(tensor)
    monkeypatch.setattr(graphs, "fetch", first_read)
    for name, (e, call) in calls.items():
        with graphs.eager():
            want = outcome(e, name, call(False))
        host = outcome(e, name, call(True))
        call(False)              # the first graphed call captures
        torch.cuda.synchronize()
        graphs.reset_stats()
        launches = philox.counts["kernel"]
        fetches.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = call(False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert fetches == [1], name
        got = outcome(e, name, res)
        st = graphs.read_stats()
        for a, b in ((got, want), (got, host)):
            assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3], name
            assert all(torch.equal(x, y) for x, y in zip(a[2], b[2])), name
        assert st["loops"] == 1 and st["captured"] == 0, (name, st)
        assert st["replays"] == max(got[1]), (name, st)
        # a launch a step, and one a request for its window seeding
        assert philox.counts["kernel"] - launches == max(got[1]) + len(res)
        assert got[3] == got[1], name
        if name == "eos":
            assert got[0][0][-1] == eos and len(got[0][0]) < len(p) + 48
