"""Decode state threaded through the lookahead loop.

Fixed-shape tensors on the engine's device, so a decode step reads and
writes them without a host round trip. Scalars are 0-d tensors; tokens and
counters are int32, the stream's draw counter int64.
"""

from __future__ import annotations

import dataclasses

import torch

from .pool import PoolState


@dataclasses.dataclass
class DecodeState:
    k_cache: object            # [L, Hkv, M, D] tensor or int8 {"q", "s"}
    v_cache: object            # dict of tensors; updated in place
    kv_len: torch.Tensor       # int32: committed cache slots
    window: torch.Tensor       # [n_window] int32 flattened lookahead levels
    pool: PoolState
    out_buf: torch.Tensor      # [M + GS] int32: prompt + confirmed tokens
    n_confirmed: torch.Tensor  # int32 (includes the prompt)
    init_len: torch.Tensor     # int32: prompt length
    step_idx: torch.Tensor     # int32: decode steps taken
    finished: torch.Tensor     # bool
    # the request's random stream (ops/philox.py): its seed as two u32
    # words, and the draws made (one a step that draws), on the device
    key: torch.Tensor          # [2] int32
    draws: torch.Tensor        # int64
