"""Static composite-step layout for lookahead decoding (numpy).

One layout is fixed when the engine is built; every per-step quantity is a
constant derived here or index arithmetic against the device scalar
``kv_len``.

Composite index space (one shape for the whole run):

    idx 0                        : the last confirmed token ("lst")
    idx [1, W)                   : window level 0   (W-1 tokens)
    idx [l*W, (l+1)*W), l=1..N-2 : window level l (W tokens each)
    idx [(N-1)*W, (N-1)*W + G*(N-1)) : G candidate n-grams, (N-1) tokens each

    S = (N-1)*W + G*(N-1) query tokens per step.

Relative positions (P = position of the last confirmed token):

    pos(lst)            = P
    pos(L0[j])          = P + 1 + j
    pos(Ll[j])  (l>=1)  = P + l + j
    pos(guess g, tok i) = P + 1 + i

Visibility inside the composite block: see ``_build_spec_mask``. Every
composite token also sees every committed KV slot (< kv_len).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import LookaheadConfig


@dataclasses.dataclass(frozen=True)
class Layout:
    """Geometry of the composite lookahead step."""

    level: int                 # N
    window: int                # W
    guess_set_size: int        # G
    guess_size: int            # N-1, tokens per candidate n-gram
    n_window: int              # (W-1) + (N-2)*W tokens of window levels
    n_guess_tokens: int        # G * (N-1)
    seq_len: int               # S: total composite query tokens
    rel_pos: np.ndarray        # [S] int32, position offsets relative to lst
    spec_mask: np.ndarray      # [S, S] bool, within-composite visibility
    window_start: int          # == 1
    inp_start: int             # start of the newest level (N-2)
    inp_stop: int              # inp_start + W
    guess_start: int           # start of the flattened guess region

    @property
    def window_slice(self) -> slice:
        return slice(1, 1 + self.n_window)

    @property
    def inp_slice(self) -> slice:
        """Rows whose argmax forms the next window level."""
        return slice(self.inp_start, self.inp_stop)

    @property
    def guess_slice(self) -> slice:
        """Rows of the verification branch."""
        return slice(self.guess_start, self.seq_len)


def build_layout(cfg: LookaheadConfig) -> Layout:
    n, w, g = cfg.level, cfg.window_size, cfg.guess_set_size
    gs = cfg.guess_size
    n_window = (w - 1) + (n - 2) * w
    n_guess_tokens = g * gs
    s = 1 + n_window + n_guess_tokens
    assert s == (n - 1) * w + g * gs

    rel = np.zeros((s,), dtype=np.int32)
    rel[1:w] = 1 + np.arange(w - 1)                 # level 0: +1+j
    for lvl in range(1, n - 1):                      # level l: +l+j
        rel[lvl * w:(lvl + 1) * w] = lvl + np.arange(w)
    gstart = (n - 1) * w
    rel[gstart:] = 1 + np.tile(np.arange(gs), g)     # guess token i: +1+i

    return Layout(
        level=n,
        window=w,
        guess_set_size=g,
        guess_size=gs,
        n_window=n_window,
        n_guess_tokens=n_guess_tokens,
        seq_len=s,
        rel_pos=rel,
        spec_mask=_build_spec_mask(n, w, g),
        window_start=1,
        inp_start=(n - 2) * w,
        inp_stop=(n - 1) * w,
        guess_start=gstart,
    )


def _build_spec_mask(n: int, w: int, g: int) -> np.ndarray:
    """Within-composite visibility in the steady state:

    - "block 0" = [lst] + level0 (W entries): causal among themselves.
    - level l>=1, column j: sees block-0 entries 0..j plus column j of
      every level 1..l-1, plus itself.
    - guess n-gram token i: sees lst and the earlier tokens of its own
      n-gram plus itself.
    """
    gs = n - 1
    s = (n - 1) * w + g * gs
    m = np.zeros((s, s), dtype=bool)

    for i in range(w):                                # block 0: causal
        m[i, : i + 1] = True
    for lvl in range(1, n - 1):                       # deeper levels
        base = lvl * w
        for j in range(w):
            q = base + j
            m[q, : j + 1] = True                      # block-0 causal part
            for r in range(1, lvl):                   # diagonals of levels 1..l-1
                m[q, r * w + j] = True
            m[q, q] = True                            # self
    gstart = (n - 1) * w
    for gg in range(g):                               # guesses
        for i in range(gs):
            q = gstart + gg * gs + i
            m[q, 0] = True                            # sees lst
            m[q, gstart + gg * gs: q + 1] = True      # own n-gram prefix + self
    return m
