"""Lookahead hyper-parameter autotuning.

The right W/N/G depends on model size, hardware and how repetitive the
workload is. ``autotune`` measures a candidate grid on a sample prompt and
returns the fastest configuration; ``save_tune_artifact`` persists the
report in the JAX package's schema (the one ``bench.py`` reads back from
``data/tune_realistic.json``).

Each candidate is measured as the JAX package measures it: a warm
``generate(prompt, 8)``, then the median of three full runs. A candidate
whose engine cannot be built or whose step does not fit the prompt
(``ValueError``) is skipped; a mistyped field of a dict candidate
(``TypeError``) propagates. ``budget_s`` stops the sweep between
candidates.

The JAX module's ``enable_compile_cache`` and ``compile_cache=`` exist for
XLA's persistent compile cache: there every candidate compiles its own
decode loop. The port runs eagerly and compiles nothing a candidate; its
kernels are built once by ``nvcc`` and cached in ``build/kernels/``. So
neither exists here.

Candidates are (level, window, guess) triples or dicts of LookaheadConfig
fields (adding e.g. ``pool_key_len`` / ``attention_impl`` to the sweep).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple, Union

from ..config import EngineConfig, LookaheadConfig
from ..core.engine import LookaheadEngine

# The reference's recommended starting points plus smaller points for
# little models.
DEFAULT_CANDIDATES: List[Tuple[int, int, int]] = [
    (4, 5, 5),
    (5, 7, 7),
    (5, 15, 15),
    (7, 20, 20),
]

# The L4-L7 x W x G neighborhood around them (the JAX package's grid).
REALISTIC_GRID: List[Tuple[int, int, int]] = sorted(set(
    itertools.product((4, 5, 6, 7), (4, 5, 7, 10), (5, 7, 10, 15))
) | set(DEFAULT_CANDIDATES))


@dataclasses.dataclass
class TuneResult:
    config: LookaheadConfig
    tokens_per_sec: float
    compression_ratio: float


Candidate = Union[Tuple[int, int, int], dict]


def _as_lcfg(cand: Candidate, pool_from_prompt: bool,
             pool_key_len: int) -> LookaheadConfig:
    if isinstance(cand, dict):
        kw = dict(cand)
        kw.setdefault("pool_from_prompt", pool_from_prompt)
        kw.setdefault("pool_key_len", pool_key_len)
        return LookaheadConfig(**kw)
    level, window, guess = cand
    return LookaheadConfig(
        level=level, window_size=window, guess_set_size=guess,
        pool_from_prompt=pool_from_prompt, pool_key_len=pool_key_len)


def autotune(
    model_cfg,
    params,
    prompt_ids: Sequence[int],
    max_new_tokens: int = 128,
    candidates: Optional[Sequence[Candidate]] = None,
    engine_cfg: Optional[EngineConfig] = None,
    pool_from_prompt: bool = True,
    seed: int = 0,
    pool_key_len: int = 1,
    budget_s: float = 0.0,
    progress=None,
    device=None,
) -> Tuple[LookaheadConfig, List[TuneResult]]:
    """Measure each candidate; return the fastest LookaheadConfig and the
    full report sorted best-first. ``budget_s`` > 0 stops the sweep (never
    mid-candidate) when the wall budget is exhausted; ``progress`` is an
    optional callback(candidate, TuneResult-or-None). ``device`` is the
    engines' (the card unless it says otherwise)."""
    engine_cfg = engine_cfg or EngineConfig()
    grid = candidates if candidates is not None else DEFAULT_CANDIDATES
    t0 = time.time()
    report: List[TuneResult] = []
    for i, cand in enumerate(grid):
        if budget_s and time.time() - t0 > budget_s:
            print(f"autotune: budget exhausted after {i}/{len(grid)} "
                  "candidates; winner is of the measured subset only",
                  file=sys.stderr, flush=True)
            break
        try:
            # ValueError = infeasible (config validation or capacity);
            # a typo'd dict FIELD raises TypeError and must propagate
            lcfg = _as_lcfg(cand, pool_from_prompt, pool_key_len)
            eng = LookaheadEngine(model_cfg, params, lcfg, engine_cfg,
                                  device=device)
            eng.generate(prompt_ids, 8, seed=seed)       # warm
            # median of 3 full runs; generate() itself records wall time
            runs = [eng.generate(prompt_ids, max_new_tokens, seed=seed)
                    for _ in range(3)]
        except ValueError:
            if progress is not None:
                progress(cand, None)
            continue   # infeasible candidate (config or prompt vs capacity)
        runs.sort(key=lambda r: r.tokens_per_sec)
        r = runs[1]
        res = TuneResult(
            config=lcfg,
            tokens_per_sec=r.tokens_per_sec,
            compression_ratio=r.compression_ratio)
        report.append(res)
        if progress is not None:
            progress(cand, res)
    if not report:
        raise ValueError("no feasible candidates for this engine config")
    report.sort(key=lambda t: -t.tokens_per_sec)
    return report[0].config, report


def measure_ar_baseline(model_cfg, params, prompt_ids, max_new_tokens=128,
                        engine_cfg=None, seed=0, device=None) -> float:
    """Median AR tok/s on the same weights/engine config: the honest
    denominator for speedup_vs_ar in the persisted artifact."""
    eng = LookaheadEngine(
        model_cfg, params,
        LookaheadConfig(level=5, window_size=7, guess_set_size=7,
                        pool_from_prompt=True),
        engine_cfg or EngineConfig(), device=device)
    eng.generate_baseline(prompt_ids, 8, seed=seed)
    runs = [eng.generate_baseline(prompt_ids, max_new_tokens, seed=seed)
            for _ in range(3)]
    runs.sort(key=lambda r: r.tokens_per_sec)
    return runs[1].tokens_per_sec


def save_tune_artifact(path: str, report: Sequence[TuneResult],
                       ar_tokens_per_sec: float = 0.0, **meta) -> dict:
    """Persist an autotune report in the schema bench.py consumes
    (``results`` sorted best-first; each row carries the LookaheadConfig
    fields bench.py reads back: level/window_size/guess_set_size plus
    pool_key_len/attention_impl when non-default)."""
    rows = []
    for r in sorted(report, key=lambda t: -t.tokens_per_sec):
        row = {
            "level": r.config.level,
            "window_size": r.config.window_size,
            "guess_set_size": r.config.guess_set_size,
            "pool_key_len": r.config.pool_key_len,
            "tok_per_sec": round(r.tokens_per_sec, 1),
            "compression_ratio": round(r.compression_ratio, 2),
        }
        if r.config.attention_impl != "auto":
            row["attention_impl"] = r.config.attention_impl
        if ar_tokens_per_sec:
            row["speedup_vs_ar"] = round(
                r.tokens_per_sec / ar_tokens_per_sec, 3)
        rows.append(row)
    out = dict(meta)
    if ar_tokens_per_sec:
        out["ar_tok_per_sec"] = round(ar_tokens_per_sec, 1)
    out["n_candidates_measured"] = len(rows)
    out["results"] = rows
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out
