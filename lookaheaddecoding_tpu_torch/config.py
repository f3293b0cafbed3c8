"""Configuration objects for the PyTorch/CUDA lookahead decoding engine.

The same three frozen dataclasses as ``lookaheaddecoding_tpu.config``, with
the same fields and validation. ``LookaheadConfig.attention_impl`` names the
port's two attention paths: ``"kernel"`` (the hand-written CUDA kernel in
``ops/csrc/lookahead_attention.cu``, counterpart of ``"pallas"``) and
``"dense"`` (an explicit additive mask, counterpart of ``"xla"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

ATTENTION_IMPLS = ("auto", "kernel", "dense")


@dataclasses.dataclass(frozen=True)
class LookaheadConfig:
    """Lookahead decoding hyper-parameters (W / N / G in the paper)."""

    level: int = 5            # N: trajectory depth; n-gram size is level-1
    window_size: int = 7      # W: lookahead window width
    guess_set_size: int = 7   # G: max candidate n-grams verified per step & LRU cap
    pool_from_prompt: bool = False  # seed the n-gram pool from the prompt tokens
    # True slides the window one position per step; False additionally
    # advances every level by the step's accepted span and refills the
    # vacated tail with random copies of confirmed tokens. Window content
    # only proposes tokens, so either setting is token-exact.
    always_fwd_one: bool = True
    # Window seeding: "copy_from" (random prompt copies, the default),
    # "order_copy_from", "copy_from_last" or "random_set".
    window_init: str = "copy_from"
    # 1 keys pool candidates on the last confirmed token; 2 on the last two
    # (hashed into pool_hash_size rows; 0 = 4x vocab, capped at 262144).
    pool_key_len: int = 1
    pool_hash_size: int = 0
    # "kernel": the composite mask is computed inside the CUDA kernel;
    # "dense": an explicit [S, M] additive mask and plain attention;
    # "auto": kernel on a CUDA device, dense on the CPU.
    attention_impl: str = "auto"

    def __post_init__(self):
        if self.level < 3:
            raise ValueError("level must be >= 3 (need at least 2 window levels)")
        if self.window_size < 2:
            raise ValueError("window_size must be >= 2")
        if self.guess_set_size < 0:
            raise ValueError(
                "guess_set_size must be >= 0; an unbounded (-1) set must be "
                "mapped to an explicit cap for a device-resident pool")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {ATTENTION_IMPLS}, "
                f"got {self.attention_impl!r}")

    @property
    def guess_size(self) -> int:
        """Length of each candidate n-gram (LEVEL-1)."""
        return self.level - 1


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling parameters: the temperature / top-k / top-p warper set."""

    temperature: float = 1.0
    top_k: int = 0            # 0 = disabled
    top_p: float = 1.0        # 1.0 = disabled

    def __post_init__(self):
        if not self.temperature > 0:
            raise ValueError(
                "temperature must be > 0 (use generate() for greedy)")
        if not 0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")

    @property
    def is_greedy(self) -> bool:
        return False  # greedy mode is selected by the engine API, not here


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-level settings: buffer sizes, dtypes, parallelism."""

    max_seq_len: int = 2048          # KV cache capacity (prompt + generated + spec)
    prefill_chunk: int = 256         # prefill processed in fixed-size chunks
    dtype: str = "bfloat16"          # activation / weight compute dtype
    kv_quant: Optional[str] = None   # None | "int8": quantized KV cache
    fuse_projections: bool = False   # fuse qkv and gate/up projections
    tp: int = 1                      # tensor-parallel axis
    la: int = 1                      # lookahead-parallel axis (speculative tokens)
    dp: int = 1                      # data/request parallel axis
    pp: int = 1                      # pipeline stages
    donate_state: bool = True        # the port always updates state in
                                     # place (core/graphs.py)
