"""LookaheadEngine: greedy lookahead generation and its AR baseline.

    eng = LookaheadEngine(mcfg, params, LookaheadConfig(level=5,
                          window_size=7, guess_set_size=7))
    out = eng.generate(prompt_ids, max_new_tokens=256)

The engine runs on ``cuda`` unless it is given ``device="cpu"``; without a
CUDA device it raises rather than carry on on the CPU. ``generate`` builds
the KV caches and the pool, seeds the window, fills the pool from the
prompt, prefills, then runs the decode loop; the result comes back in one
device-to-host transfer.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import EngineConfig, LookaheadConfig
from ..models import llama
from ..ops.lookahead_attention import KERNEL_HEAD_DIMS
from .layout import Layout, build_layout
from .pool import apply_host_fill, host_prompt_fill, pool_init, pool_table_rows
from .state import DecodeState
from .step import build_step_fns

MAX_EOS_IDS = 4


def _eos_vec(eos_token_id, device) -> torch.Tensor:
    """Fixed-width EOS id vector (pad -1); any listed id stops generation."""
    if eos_token_id is None:
        ids = []
    elif isinstance(eos_token_id, (int, np.integer)):
        ids = [int(eos_token_id)]
    else:
        ids = [int(i) for i in eos_token_id]
        if len(ids) > MAX_EOS_IDS:
            raise ValueError(
                f"at most {MAX_EOS_IDS} eos ids supported, got {len(ids)}")
    v = np.full((MAX_EOS_IDS,), -1, np.int32)
    v[: len(ids)] = ids
    return torch.from_numpy(v).to(device)


@dataclasses.dataclass
class GenerationResult:
    """Output of one generate call with the acceleration accounting."""

    tokens: np.ndarray          # full sequence: prompt + generated
    prompt_len: int
    steps: int
    wall_time_s: float = 0.0

    @property
    def new_tokens(self) -> np.ndarray:
        return self.tokens[self.prompt_len:]

    @property
    def num_generated(self) -> int:
        return len(self.tokens) - self.prompt_len

    @property
    def compression_ratio(self) -> float:
        return self.num_generated / max(self.steps, 1)

    @property
    def tokens_per_sec(self) -> float:
        return self.num_generated / self.wall_time_s if self.wall_time_s else 0.0


class LookaheadEngine:
    def __init__(
        self,
        model_cfg: llama.LlamaConfig,
        params,
        lookahead: Optional[LookaheadConfig] = None,
        engine: Optional[EngineConfig] = None,
        device=None,
    ):
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LookaheadEngine runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        self.mcfg = model_cfg
        self.params = params
        self.lcfg = lookahead or LookaheadConfig()
        self.ecfg = engine or EngineConfig()
        if self.lcfg.attention_impl == "auto":
            # the kernel on the card, the plain version on the CPU; a card
            # never falls back to the dense path unless asked for it
            self.lcfg = dataclasses.replace(
                self.lcfg, attention_impl="kernel"
                if self.device.type == "cuda" else "dense")
        if (self.lcfg.attention_impl == "kernel"
                and self.device.type == "cuda"
                and model_cfg.head_dim not in KERNEL_HEAD_DIMS):
            raise ValueError(
                f"the attention kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                f"got {model_cfg.head_dim}; pass attention_impl='dense' to "
                f"run the plain version on the card")
        e = self.ecfg
        if max(e.tp, e.la, e.dp, e.pp) > 1:
            raise NotImplementedError("parallel meshes are not ported yet")
        self.layout: Layout = build_layout(self.lcfg)
        if e.max_seq_len < self.layout.seq_len + 8:
            raise ValueError("max_seq_len too small for the composite step")
        if e.prefill_chunk > e.max_seq_len:
            raise ValueError("prefill_chunk must not exceed max_seq_len")
        if (model_cfg.sliding_window is not None
                and self.layout.seq_len > model_cfg.sliding_window):
            # committed keys respect the window bound; within the composite
            # block the speculative positions span < S, so S must fit
            raise ValueError(
                "composite step size exceeds the model's sliding window; "
                "reduce level/window_size/guess_set_size")
        if e.fuse_projections:
            self.params = llama.fuse_params(self.params)
        self._fns = build_step_fns(model_cfg, self.lcfg, e, self.layout,
                                   self.device)

    # ------------------------------------------------------------------
    def _host_args(self, prompt_ids, max_new_tokens: int):
        """Validate the prompt; build the output buffer and the pool fill.
        ``max_new_tokens`` beyond capacity is legal (the loop stops at the
        KV budget) but must be at least 1."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        P = len(prompt)
        M = self.ecfg.max_seq_len
        if P < 1:
            raise ValueError("empty prompt")
        if P - 1 + self.layout.seq_len > M:
            raise ValueError(
                f"prompt ({P}) + composite step ({self.layout.seq_len}) "
                f"exceeds max_seq_len ({M})")
        if prompt.min() < 0 or prompt.max() >= self.mcfg.vocab_size:
            # an out-of-range id would be a device-side assert on CUDA
            raise ValueError(
                f"prompt token ids must lie in [0, {self.mcfg.vocab_size})")
        out_buf = np.zeros((M + self.layout.guess_size,), np.int32)
        out_buf[:P] = prompt
        fill = None
        if self.lcfg.pool_from_prompt:
            fill = host_prompt_fill(
                prompt, self.lcfg.level, self.layout.guess_set_size,
                pad_to=M, key_len=self.lcfg.pool_key_len,
                table_rows=pool_table_rows(self.mcfg.vocab_size,
                                           self.lcfg.pool_key_len,
                                           self.lcfg.pool_hash_size))
        return out_buf, P, fill

    def _prepare(self, out_buf: np.ndarray, prompt_len: int, seed: int,
                 fill) -> DecodeState:
        """Caches, pool, window seeding, prompt fill and prefill."""
        dev = self.device
        k_cache, v_cache = llama.make_kv_cache(
            self.mcfg, self.ecfg.max_seq_len, dev, quant=self.ecfg.kv_quant)
        pool = pool_init(
            pool_table_rows(self.mcfg.vocab_size, self.lcfg.pool_key_len,
                            self.lcfg.pool_hash_size),
            self.layout.guess_set_size, self.layout.guess_size, dev)
        rng = torch.Generator(device=dev)
        rng.manual_seed(seed)
        state = self._fns.init_state(
            k_cache, v_cache, pool, torch.from_numpy(out_buf).to(dev),
            prompt_len, rng)
        if fill is not None:
            apply_host_fill(state.pool, *fill)
        return self._fns.prefill_all(self.params, state, prompt_len)

    def _finalize(self, state: DecodeState, max_new: int,
                  t0: float) -> GenerationResult:
        # one device-to-host transfer for the scalars and the tokens
        host = torch.cat([torch.stack([state.n_confirmed, state.init_len,
                                       state.step_idx]),
                          state.out_buf]).cpu().numpy()
        n_confirmed, init_len, steps = (int(x) for x in host[:3])
        total = min(n_confirmed, init_len + max_new)   # trim overshoot
        return GenerationResult(tokens=host[3:3 + total].copy(),
                                prompt_len=init_len, steps=steps,
                                wall_time_s=time.perf_counter() - t0)

    def _run(self, loop, prompt_ids, max_new_tokens, eos_token_id, seed):
        t0 = time.perf_counter()
        out_buf, P, fill = self._host_args(prompt_ids, max_new_tokens)
        with torch.inference_mode():
            state = self._prepare(out_buf, P, seed, fill)
            state = loop(self.params, state, max_new_tokens,
                         _eos_vec(eos_token_id, self.device))
            return self._finalize(state, max_new_tokens, t0)

    # ------------------------------------------------------------------
    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int,
                 eos_token_id=None, seed: int = 0) -> GenerationResult:
        """Greedy lookahead generation. ``seed`` seeds the window (the
        ``copy_from`` and ``random_set`` seedings); the tokens do not
        depend on it."""
        return self._run(self._fns.decode_loop, prompt_ids, max_new_tokens,
                         eos_token_id, seed)

    def generate_baseline(self, prompt_ids: Sequence[int],
                          max_new_tokens: int, eos_token_id=None,
                          seed: int = 0) -> GenerationResult:
        """Plain autoregressive greedy decoding on the same weights and KV
        machinery: the comparison target for exactness and speedup."""
        return self._run(self._fns.baseline_loop, prompt_ids, max_new_tokens,
                         eos_token_id, seed)
