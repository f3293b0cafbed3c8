"""The port's composite layout and in-kernel mask arithmetic against the JAX
package's, on the grid of test_layout_masks.py."""

import numpy as np
import pytest
import torch

from lookaheaddecoding_tpu.config import LookaheadConfig as JLookaheadConfig
from lookaheaddecoding_tpu.core.layout import build_layout as jbuild_layout
from lookaheaddecoding_tpu_torch.config import LookaheadConfig
from lookaheaddecoding_tpu_torch.core.layout import build_layout
from lookaheaddecoding_tpu_torch.ops.lookahead_attention import (
    _rel_pos, _spec_visible)

GRID = [(3, 2, 1), (4, 5, 4), (5, 7, 7), (5, 15, 15), (7, 20, 20), (4, 6, 0)]


@pytest.mark.parametrize("level,window,guess", GRID)
def test_layout_equals_jax(level, window, guess):
    kw = dict(level=level, window_size=window, guess_set_size=guess)
    mine, ref = build_layout(LookaheadConfig(**kw)), jbuild_layout(
        JLookaheadConfig(**kw))
    np.testing.assert_array_equal(mine.rel_pos, ref.rel_pos)
    np.testing.assert_array_equal(mine.spec_mask, ref.spec_mask)
    for name in ("seq_len", "n_window", "n_guess_tokens", "inp_start",
                 "inp_stop", "guess_start", "window_start"):
        assert getattr(mine, name) == getattr(ref, name), name


@pytest.mark.parametrize("level,window,guess", GRID)
def test_mask_arithmetic_matches_layout(level, window, guess):
    """_spec_visible and _rel_pos (the plain version's mask, and the
    kernel's formulas) equal the static layout."""
    lay = jbuild_layout(JLookaheadConfig(
        level=level, window_size=window, guess_set_size=guess))
    s = lay.seq_len
    qi = torch.arange(s)[:, None].expand(s, s)
    rj = torch.arange(s)[None, :].expand(s, s)
    geo = dict(level=level, window=window, guess_size=level - 1)
    np.testing.assert_array_equal(_spec_visible(qi, rj, **geo).numpy(),
                                  lay.spec_mask)
    np.testing.assert_array_equal(_rel_pos(torch.arange(s), **geo).numpy(),
                                  lay.rel_pos)


@pytest.mark.parametrize("kwargs,match", [
    (dict(level=2), "level"), (dict(window_size=1), "window_size"),
    (dict(guess_set_size=-1), "guess_set_size"),
    (dict(attention_impl="pallas"), "attention_impl"),
])
def test_config_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        LookaheadConfig(**kwargs)
