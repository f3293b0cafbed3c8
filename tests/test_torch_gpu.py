"""Card-only tests of the port's CUDA kernels (the composite attention on
a plain and on an int8 KV cache, flat and paged, in bfloat16 on the tensor
cores and in float32 on FMAs; the int8, int4 and pipelined int4 matrix
products, in bfloat16 on the tensor cores; the int4 product's two
micro-benchmark variants), each against its plain PyTorch version; the
attention also at head_dim 256 with Gemma-2B's heads. They skip without a CUDA device. This file imports no
JAX, so on a machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

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
        la.paged_lookahead_attention(q[..., :32].contiguous(),
                                     k[..., :32].contiguous(),
                                     k[..., :32].contiguous(), lens, tables,
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


@pytest.mark.gpu
@pytest.mark.parametrize("int8_kv", [False, True], ids=["plain", "int8_kv"])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(atol=1e-4, rtol=1e-4)),
    (torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
])
def test_attention_kernel_head_dim_256(dtype, tol, int8_kv):
    """head_dim 256 at Gemma-2B's heads (rep 8): composite at M=1024 and
    M=2048, causal prefill, a sliding window both ways, the one-row AR
    call, a small composite; a plain and an int8 cache. Each within ``tol``
    of its plain version (the tolerances of the D=64 tests), and in
    bfloat16 within the rounding limit of the float32 kernel (chip_smoke's
    limit, as in test_bf16_attention_within_rounding_limit_of_float32_kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from lookaheaddecoding_tpu_torch.models.llama import kv_cache_write
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(9)
    hq, hkv, d = GEMMA_HEADS["hq"], GEMMA_HEADS["hkv"], GEMMA_HEADS["d"]
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
            assert bool((err <= limit).all()), (s, m, kv, causal, sw,
                                                (err / limit).max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("int8_kv", [False, True], ids=["plain", "int8_kv"])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(atol=1e-4, rtol=1e-4)),
    (torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
])
def test_paged_attention_kernel_head_dim_256(dtype, tol, int8_kv):
    """The paged call at head_dim 256 and Gemma-2B's heads: four lanes of
    different ``kv_len`` on shuffled pages of 128, composite and causal,
    with and without a sliding window; within ``tol`` of its plain version
    and each lane bit-equal to the flat kernel on its contiguous cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from lookaheaddecoding_tpu_torch.core.paged import (paged_gather,
                                                        paged_write)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(10)
    hq, hkv, d = GEMMA_HEADS["hq"], GEMMA_HEADS["hkv"], GEMMA_HEADS["d"]
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
            assert torch.equal(flat, got[b]), (causal, sw, b)
