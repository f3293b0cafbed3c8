"""The decode state's random stream (``lookaheaddecoding_tpu_torch/ops/
philox.py``) on the CPU: the plain Philox4x32-10 against Random123's
known-answer vectors and a pure-Python reference, the stream's layout
(counter, tags, lanes), the uniforms' range, and the wrapper's dispatch.
The CUDA kernel (``ops/csrc/philox.cu``) is held bit for bit against this
plain version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``
phase 3)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from lookaheaddecoding_tpu_torch.ops import philox

MASK = 0xFFFFFFFF

# Random123's kat_vectors for philox4x32 with 10 rounds: counter (four
# words), key (two words), output (four words)
KAT = [
    ([0, 0, 0, 0], [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([MASK] * 4, [MASK] * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                              0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
     [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
]


def philox_py(ctr, key):
    """Philox4x32-10 in Python integers, as Random123 writes it."""
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & MASK, (k[1] + 0xBB67AE85) & MASK]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & MASK, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & MASK]
    return c


def stream_py(key, draws, n, tag):
    """Lane words of the stream in Python: word k of block j is element
    4j + k, counter (j, draws_lo, draws_hi, tag)."""
    out = []
    for j in range(-(-n // 4)):
        out += philox_py([j, draws & MASK, draws >> 32, tag], key)
    return out[:n]


def lanes(keys, draws):
    key = torch.tensor([[int(np.uint32(w).view(np.int32)) for w in k]
                        for k in keys], dtype=torch.int32)
    return key, torch.tensor(draws, dtype=torch.int64)


@pytest.mark.parametrize("case", range(len(KAT)))
def test_known_answers(case):
    """Random123's three known-answer vectors, through the tensor version
    and the Python reference."""
    ctr, key, want = KAT[case]
    got = philox.philox_words([torch.tensor([c]) for c in ctr],
                              [torch.tensor([k]) for k in key])
    assert [int(w) for w in got] == want
    assert philox_py(ctr, key) == want


def test_plain_version_equals_python_reference():
    """Random keys, draw counters past 2**32 and tags, at lengths that are
    and are not multiples of four: the plain version's words equal the
    Python reference's, lane by lane."""
    rng = np.random.RandomState(0)
    keys = [[int(x) for x in rng.randint(0, 2**32, size=2, dtype=np.uint64)]
            for _ in range(5)]
    draws = [0, 1, 7, 2**32 + 3, 2**40 + 11]
    for n in (1, 4, 13, 64):
        for tag in (philox.STEP, philox.WINDOW, 12345):
            key, d = lanes(keys, draws)
            got = philox.bits_ref(key, d, n, tag)
            want = [stream_py(k, x, n, tag) for k, x in zip(keys, draws)]
            assert got.tolist() == want, (n, tag)


def test_mulhilo_is_exact_at_the_extremes():
    """The split product equals Python's 64-bit product for the largest
    and smallest u32 factors."""
    for a in (0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, MASK):
        for m in (philox.M0, philox.M1):
            hi, lo = philox._mulhilo(m, torch.tensor([a]))
            assert (int(hi) << 32) + int(lo) == a * m


def test_uniforms_lie_in_the_unit_interval_and_are_the_top_bits():
    """u = (w >> 8) * 2**-24: 0 at the word 0, 1 - 2**-24 (below 1) at
    the largest word, and the uniforms are the raw words' top 24 bits, so
    comparing either compares the draw. A long draw lies in [0, 1) with a
    mean and decile counts a uniform draw gives."""
    w = torch.tensor([0, 255, 256, MASK], dtype=torch.int64)
    assert philox.to_uniform(w).tolist() == [0.0, 0.0, 2**-24, 1 - 2**-24]
    key, d = lanes([[7, 9]], [3])
    u = philox.uniforms(key, d, 200_000)
    raw = philox.bits(key, d, 200_000)
    assert raw.dtype == torch.int32 and u.dtype == torch.float32
    assert torch.equal(philox.to_uniform(raw), u)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.double().mean()) - 0.5) < 0.005
    deciles = np.bincount((u[0].numpy() * 10).astype(np.int64), minlength=10)
    assert np.all(np.abs(deciles - 20_000) < 800), deciles


def test_lanes_are_independent_and_repeatable():
    """A lane's draw depends on its own key and counter alone: the same
    numbers alone as in a batch and on a second call; another counter,
    tag or key gives other numbers."""
    key, d = lanes([[1, 0], [2, 0], [1, 0]], [0, 0, 5])
    batch = philox.uniforms(key, d, 50)
    for b in range(3):
        alone = philox.uniforms(key[b:b + 1], d[b:b + 1], 50)
        assert torch.equal(alone[0], batch[b])
    assert torch.equal(philox.uniforms(key, d, 50), batch)
    assert not torch.equal(batch[0], batch[1])          # another key
    assert not torch.equal(batch[0], batch[2])          # another counter
    assert not torch.equal(
        batch[0], philox.uniforms(key[:1], d[:1], 50, philox.WINDOW)[0])
    # a shorter draw is the longer one's prefix
    assert torch.equal(philox.uniforms(key, d, 13), batch[:, :13])


def test_seed_key_and_dispatch():
    """A seed becomes its two words (mod 2**64, as int32 bits); CPU
    tensors run the plain version and count it; a tensor on another device
    than the CPU or a card, or a malformed key or counter, raises."""
    assert philox.seed_key(0) == (0, 0)
    assert philox.seed_key(5 + (3 << 32)) == (5, 3)
    assert philox.seed_key(-1) == (-1, -1)
    key, d = lanes([[1, 2]], [0])
    before = philox.counts["plain"]
    philox.uniforms(key, d, 8)
    philox.bits(key, d, 8)
    assert philox.counts["plain"] == before + 2
    with pytest.raises(ValueError, match="no philox kernel"):
        philox.uniforms(key.to("meta"), d.to("meta"), 8)
    with pytest.raises(ValueError, match="int32"):
        philox.uniforms(key.long(), d, 8)
    with pytest.raises(ValueError, match="int64"):
        philox.uniforms(key, d.int(), 8)


def test_kernel_source_reads_its_counter_from_device_memory():
    """The kernel is the repository's own Philox: no cuRAND, and the draw
    counter and key come through pointers (a captured launch reads them on
    every replay), never as values of the launch."""
    src = (Path(philox.__file__).parent / "csrc" / "philox.cu").read_text()
    assert "curand" not in src.lower()
    assert "const long long* __restrict__ draws" in src
    assert "draws[lane]" in src and "key[2 * lane]" in src
