"""The decode state's random stream: Philox4x32-10 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC'11; the Random123 library), drawn by
the hand-written CUDA kernel ``csrc/philox.cu`` and its plain PyTorch
version.

The counterpart of the JAX package's ``jax.random`` draws from
``DecodeState.rng`` (``lookaheaddecoding_tpu/core/step.py:104``, ``:207``,
``:217``, the key made at ``:318``; ``ops/sampling.py:77-104``). JAX keeps a
key in the state and splits it on the device every step; the port keeps a
lane's ``key`` (its seed as two u32 words, ``[2]`` int32, or ``[B, 2]`` for
lanes) and ``draws`` (int64: the draws made so far, ``[B]`` for lanes) in
the state, and a draw is a pure function of them:

    uniforms(key, draws, n, tag)[b, 4 * j + k] = u(word k of
        Philox4x32-10(counter = (j, draws_lo, draws_hi, tag), key[b]))
    u(w) = (w >> 8) * 2**-24, in [0, 1), exact in float32

``tag`` separates the uses of one position of the stream: ``STEP`` (0) a
decode step's noise, ``WINDOW`` (1) a request's window seeding. The kernel
reads ``key`` and ``draws`` from device memory, never as launch arguments,
so a launch captured in a CUDA graph draws from the current counter on
every replay and every iteration of a WHILE node: the step advances
``draws`` in place, and a decode loop on the device draws fresh numbers
each step. A lane draws the same numbers alone as in a batch, and the CPU
(the plain version) and the card (the kernel) the same numbers for the
same seed. The streams are not JAX's threefry bits: sampling is held
against JAX by explicit noise and by distribution bounds.

On a CUDA tensor :func:`uniforms` and :func:`bits` launch the kernel, or
raise; on a CPU tensor they run the plain version, exact u32 arithmetic on
int64 tensors. ``counts`` records both.
"""

from __future__ import annotations

import numpy as np
import torch

# Launches of the CUDA kernel and calls of the plain version. Reset with
# ``counts.update(dict.fromkeys(counts, 0))``.
counts = {"kernel": 0, "plain": 0}

STEP, WINDOW = 0, 1          # tags: a step's noise, the window seeding

# Philox4x32's round multipliers and Weyl key increments (Random123)
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
_MASK = 0xFFFFFFFF


def seed_key(seed: int):
    """A seed (any integer; taken mod 2**64) as the key's two words, low
    first, each as the signed int32 of the same bits: what
    ``key.fill_`` writes."""
    s = int(seed) % (1 << 64)
    return tuple(int(np.uint32(w).view(np.int32))
                 for w in (s & _MASK, s >> 32))


def start(key: torch.Tensor, draws: torch.Tensor, seed: int) -> None:
    """A lane's stream set to ``seed`` before its first draw, in place
    (``key`` [2] int32, ``draws`` 0-d): the words by ``fill_``, since an
    item assignment of a Python number copies it to the card from
    pageable memory, a sync."""
    for word, value in zip(key, seed_key(seed)):
        word.fill_(value)
    draws.zero_()


def philox_words(ctr, key):
    """Philox4x32-10 of counters ``ctr`` (four int64 tensors of u32 values,
    broadcasting) under ``key`` (two of them): the four output words, int64
    tensors of u32 values. Every product is split so that no int64 value
    passes 2**49."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + W0) & _MASK
            k1 = (k1 + W1) & _MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _mulhilo(m: int, a):
    """(high, low) u32 words of the 64-bit product of the constant ``m``
    and ``a`` (u32 values in int64): ``a * m_lo`` and ``a * m_hi`` (16-bit
    halves of m) are below 2**48, and ``a * m = t + (a * m_hi >> 16) *
    2**32`` with ``t = a * m_lo + ((a * m_hi) & 0xFFFF) << 16``."""
    x = a * (m & 0xFFFF)
    y = a * (m >> 16)
    t = x + ((y & 0xFFFF) << 16)
    return (t >> 32) + (y >> 16), t & _MASK


def bits_ref(key: torch.Tensor, draws: torch.Tensor, n: int,
             tag: int) -> torch.Tensor:
    """The plain version of :func:`bits`: [B, n] int64 u32 words."""
    k = key.long() & _MASK                                  # [B, 2]
    d = draws.long()                                        # [B]
    blocks = -(-n // 4)
    j = torch.arange(blocks, dtype=torch.int64, device=key.device)[None]
    ctr = (j, (d & _MASK)[:, None], ((d >> 32) & _MASK)[:, None],
           torch.full_like(j, tag & _MASK))
    words = philox_words(ctr, (k[:, :1], k[:, 1:]))
    out = torch.stack([w.expand(len(d), blocks) for w in words], dim=2)
    return out.reshape(len(d), 4 * blocks)[:, :n]


def to_uniform(words: torch.Tensor) -> torch.Tensor:
    """u32 words (any integer dtype, as their low 32 bits) as uniforms in
    [0, 1): the top 24 bits over 2**24, exact in float32."""
    return ((words.long() & _MASK) >> 8).float() * (1.0 / (1 << 24))


def _check(key: torch.Tensor, draws: torch.Tensor, n: int, tag: int):
    if key.dim() != 2 or key.shape[1] != 2 or key.dtype != torch.int32:
        raise ValueError(f"philox: key must be int32 [B, 2], got "
                         f"{key.dtype} {tuple(key.shape)}")
    if (draws.dim() != 1 or draws.shape[0] != key.shape[0]
            or draws.dtype != torch.int64):
        raise ValueError(f"philox: draws must be int64 [{key.shape[0]}], "
                         f"got {draws.dtype} {tuple(draws.shape)}")
    if draws.device != key.device:
        raise ValueError("philox: key and draws must be on one device")
    if not 0 <= n < 2**31 or not 0 <= tag < 2**31:
        raise ValueError(f"philox: n and tag must lie in [0, 2**31), got "
                         f"{n}, {tag}")


def _launch(key: torch.Tensor, draws: torch.Tensor, n: int, tag: int,
            raw: bool) -> torch.Tensor:
    """The kernel's launch: [B, n] float32 uniforms, or int32 words when
    ``raw``."""
    if not (key.is_contiguous() and draws.is_contiguous()):
        raise ValueError("philox kernel takes a contiguous key and draws")
    if key.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {key.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    b = key.shape[0]
    if b > 65535:
        raise ValueError(f"philox kernel: at most 65535 lanes (its grid's "
                         f"y axis), got {b}")
    out = torch.empty((b, n), dtype=torch.int32 if raw else torch.float32,
                      device=key.device)
    if b == 0 or n == 0:
        return out
    from ._build import load
    err = load("philox").philox_launch(
        key.data_ptr(), draws.data_ptr(), out.data_ptr(), b, n, tag,
        int(raw), torch.cuda.current_stream(key.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"philox kernel launch failed: CUDA error {err}")
    counts["kernel"] += 1
    return out


def _dispatch(key, draws, n: int, tag: int, raw: bool) -> torch.Tensor:
    _check(key, draws, n, tag)
    if key.device.type == "cpu":
        counts["plain"] += 1
        words = bits_ref(key, draws, n, tag)
        if raw:     # the u32 bits as int32: the top bit is the sign
            return (words - ((words >> 31) << 32)).to(torch.int32)
        return to_uniform(words)
    if key.device.type != "cuda":
        raise ValueError(f"no philox kernel for device {key.device}")
    return _launch(key, draws, n, tag, raw)


def uniforms(key: torch.Tensor, draws: torch.Tensor, n: int,
             tag: int = STEP) -> torch.Tensor:
    """[B, n] float32 uniforms in [0, 1): row b is lane b's draw number
    ``draws[b]`` under ``key[b]`` (int32 [B, 2]; int64 [B]), use ``tag``.
    Reads no tensor back to the host."""
    return _dispatch(key, draws, n, tag, raw=False)


def bits(key: torch.Tensor, draws: torch.Tensor, n: int,
         tag: int = STEP) -> torch.Tensor:
    """The raw words behind :func:`uniforms`: [B, n] int32 holding the u32
    bits, for comparing the kernel with its plain version bit for bit."""
    return _dispatch(key, draws, n, tag, raw=True)
