"""Card-only tests of the port's CUDA kernels (the composite attention on
a plain and on an int8 KV cache, flat and paged, the int8, int4 and
pipelined int4 matrix products, the int4 product's two micro-benchmark
variants), each against its plain PyTorch version. They skip without a CUDA device. This file imports no
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
    row count, both tile shapes, ragged N (not a multiple of 64), a K whose
    packed rows are zero-padded, and one layer of a stacked weight. A row's
    result does not depend on the rows beside it, and the pipelined int4
    kernel gives the int4 kernel's bits."""
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

    for t, k, n in [(1, 2048, 256), (8, 512, 80), (17, 2048, 2048),
                    (240, 5632, 2048), (128, 2048, 5632), (9, 5888, 48),
                    (141, 2048, 32000), (3, 11008, 4096)]:
        w = torch.from_numpy(rng.randn(2, k, n).astype(np.float32) * 0.02)
        stack = quant.quantize_weight(w.to(dev), bits)
        wq = {name: leaf[1] for name, leaf in stack.items()}
        x = torch.from_numpy(rng.randn(t, k).astype(np.float32)).to(dev, dtype)
        before = qm.counts[mode]
        got = run(x, wq)
        assert qm.counts[mode] == before + 1
        want = (qm.int8_matmul_ref(x, wq["q"], wq["scale"]) if bits == 8
                else qm.int4_matmul_ref(x, wq["q4"], wq["scale"]))
        torch.testing.assert_close(got.float(), want.float(), **tol)
        r = t // 2
        assert torch.equal(run(x[r:r + 1].contiguous(), wq)[0], got[r])
        if mode == "int4_pipe":
            assert torch.equal(got, run(x, wq, "int4"))


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
            before = la.paged_counts["kernel"]
            got = la.paged_lookahead_attention(q, k, v, kv_lens, tables,
                                               page_size=page, **kw)
            assert la.paged_counts["kernel"] == before + 1
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
    and a row alone gives the bits of the same row among T. Both tile
    shapes, ragged N, a K whose packed rows are zero-padded."""
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
                    (8, 2048, 32000)]:
        w = torch.from_numpy(rng.randn(k, n).astype(np.float32) * 0.02)
        wq = quant.quantize_weight(w.to(dev), 4)
        k2 = quant.logical_packed_rows(wq)
        x = torch.from_numpy(rng.randn(t, k).astype(np.float32)).to(dev, dtype)
        before = dict(im.counts)
        b4 = qm.int4_matmul(x, wq["q4"], wq["scale"], logical_k2=k2)
        shift = im.int4_matmul_shift(x, wq["q4"], wq["scale"], logical_k2=k2)
        kouter = im.int4_matmul_kouter(x, wq["q4"], wq["scale"],
                                       logical_k2=k2)
        assert im.counts == dict(before, shift=before["shift"] + 1,
                                 kouter=before["kouter"] + 1)
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
