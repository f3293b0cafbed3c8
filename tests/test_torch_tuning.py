"""The port's autotune: the JAX package's three ``test_tuning.py`` cases,
and, on the same carried float32 weights, each feasible candidate's
compression equal to JAX's autotune and the same candidates skipped."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
from lookaheaddecoding_tpu.utils import tuning as jtuning
import lookaheaddecoding_tpu_torch as lt
from lookaheaddecoding_tpu_torch.utils.tuning import (
    REALISTIC_GRID, autotune, measure_ar_baseline, save_tune_artifact)

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)


def tree():
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    return jcfg, jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                                scale=0.5))


def port_model():
    cfg = lt.LlamaConfig(**ARCH, dtype=torch.float32)
    return cfg, lt.params_from_numpy(tree()[1], cfg, "cpu")


def ecfg():
    return lt.EngineConfig(max_seq_len=256, prefill_chunk=16)


def test_autotune_returns_best_feasible_config():
    mcfg, params = port_model()
    prompt = list(np.random.RandomState(0).randint(0, 128, size=16))
    best, report = autotune(
        mcfg, params, prompt, max_new_tokens=32,
        candidates=[(4, 5, 5), (5, 7, 7), (20, 40, 40)],  # last is infeasible
        engine_cfg=ecfg(), device="cpu")
    assert len(report) == 2           # infeasible candidate skipped
    assert best == report[0].config
    assert report[0].tokens_per_sec >= report[1].tokens_per_sec
    assert all(r.compression_ratio >= 1.0 for r in report)


def test_autotune_skips_candidate_whose_step_exceeds_capacity_with_prompt():
    """A candidate can pass engine construction but fail at generate time
    (prompt + composite step > max_seq_len); it must be skipped, not
    crash."""
    mcfg, params = port_model()
    prompt = list(np.random.RandomState(1).randint(0, 128, size=100))
    # (7,20,20): S=240 fits max_seq_len=256 alone but not with the prompt
    best, report = autotune(
        mcfg, params, prompt, max_new_tokens=16,
        candidates=[(4, 5, 5), (7, 20, 20)], engine_cfg=ecfg(),
        device="cpu")
    assert len(report) == 1
    assert report[0].config.window_size == 5


def test_autotune_dict_candidates_and_artifact_roundtrip(tmp_path):
    """Dict candidates sweep beyond W/N/G (pool_key_len); the artifact has
    the schema bench.py reads; a typo'd field propagates."""
    mcfg, params = port_model()
    prompt = list(np.random.RandomState(0).randint(0, 128, size=16))
    best, report = autotune(
        mcfg, params, prompt, max_new_tokens=24,
        candidates=[(4, 5, 5),
                    {"level": 4, "window_size": 5, "guess_set_size": 5,
                     "pool_key_len": 2}],
        engine_cfg=ecfg(), device="cpu")
    assert len(report) == 2
    assert {r.config.pool_key_len for r in report} == {1, 2}

    ar = measure_ar_baseline(mcfg, params, prompt, 24, ecfg(), device="cpu")
    assert ar > 0
    path = tmp_path / "tune.json"
    out = save_tune_artifact(str(path), report, ar_tokens_per_sec=ar,
                             noisy_scale=0.036)
    w = json.loads(path.read_text())["results"][0]
    # bench.py reads exactly these keys from results[0]
    assert {"level", "window_size", "guess_set_size",
            "pool_key_len", "speedup_vs_ar"} <= set(w)
    assert w["tok_per_sec"] >= out["results"][-1]["tok_per_sec"]
    assert json.loads(path.read_text())["noisy_scale"] == 0.036
    for pt in ((5, 4, 10), (5, 5, 10), (5, 7, 7), (7, 20, 20)):
        assert pt in REALISTIC_GRID
    assert REALISTIC_GRID == jtuning.REALISTIC_GRID
    with pytest.raises(TypeError):
        autotune(mcfg, params, prompt, 8, candidates=[{"levle": 4}],
                 engine_cfg=ecfg(), device="cpu")


def test_autotune_compression_equals_jax_per_candidate():
    """``order_copy_from`` seeds the window without a random draw, so the
    steps (and compression) of each candidate equal JAX's; (7,20,20) does
    not fit the 100-token prompt in either package."""
    jcfg, t = tree()
    mcfg, params = port_model()
    prompt = list(np.random.RandomState(3).randint(0, 128, size=12)) * 8
    cands = [dict(level=lv, window_size=w, guess_set_size=g,
                  window_init="order_copy_from")
             for lv, w, g in ((4, 5, 5), (5, 7, 7), (7, 20, 20))]
    seen = {"port": [], "jax": []}
    _, report = autotune(mcfg, params, prompt, 40, candidates=cands,
                         engine_cfg=ecfg(), device="cpu",
                         progress=lambda c, r: seen["port"].append(r))
    _, jreport = jtuning.autotune(
        jcfg, jax.tree.map(jnp.asarray, t), prompt, 40, candidates=cands,
        engine_cfg=jlt.EngineConfig(max_seq_len=256, prefill_chunk=16,
                                    dtype="float32"), compile_cache=False,
        progress=lambda c, r: seen["jax"].append(r))
    skipped = {k: [r is None for r in v] for k, v in seen.items()}
    assert skipped["port"] == skipped["jax"] == [False, False, True]
    by_cfg = {(r.config.level, r.config.window_size): r.compression_ratio
              for r in jreport}
    assert len(report) == len(jreport) == 2
    for r in report:
        assert r.compression_ratio == by_cfg[(r.config.level,
                                              r.config.window_size)]
    assert max(r.compression_ratio for r in report) > 1
