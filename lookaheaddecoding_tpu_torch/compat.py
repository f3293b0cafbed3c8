"""Reference-compatible configuration shim.

For users migrating from the reference's process-global API (``lade``:
``augment_all``, ``config_lade``, ``get_model``; the ``USE_LADE`` switch).
The engine has no monkey-patching, so ``augment_all`` is a no-op kept for
drop-in import compatibility; ``config_lade`` records the same knobs and
``get_engine`` builds a LookaheadEngine from them. The JAX package's shim,
with the port's attention names: ``USE_FLASH=1`` selects ``"kernel"`` (the
CUDA kernel, JAX's ``"pallas"``), 0 or unset ``"dense"`` (JAX's
``"xla"``).

    import lookaheaddecoding_tpu_torch.compat as lade
    lade.augment_all()
    lade.config_lade(LEVEL=5, WINDOW_SIZE=7, GUESS_SET_SIZE=7,
                     POOL_FROM_PROMPT=1, USE_FLASH=1, DEBUG=1)
    engine, tok = lade.get_engine("meta-llama/Llama-2-7b-chat-hf")
    out = engine.generate(tok("hi").input_ids, 128)
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from .config import EngineConfig, LookaheadConfig
from .core.engine import LookaheadEngine
from .utils.logging import DecodeLog

CONFIG_MAP = {}
FUNC_MAP = {}   # kept for import compatibility; nothing is patched

# The reference's unbounded pool mode (GUESS_SET_SIZE=-1): mapped to the
# bigram-key pool at cap 16, the static-shape equivalent that the JAX
# package measured lossless (its tests/test_unbounded_pool.py).
UNLIMITED_POOL_CAP = 16
UNLIMITED_POOL_KEY_LEN = 2

# Knob surface of the reference's config_lade plus its in-loop defaults.
# Unknown keys (typos, unsupported extensions) warn instead of silently
# absorbing.
_KNOWN_KEYS = frozenset({
    "LEVEL", "WINDOW_SIZE", "GUESS_SET_SIZE", "ALWAYS_FWD_ONE", "DEBUG",
    "SPLIT_FLAG", "POOL_FROM_PROMPT", "DIST_WORKERS", "LOCAL_RANK",
    "USE_FLASH", "MAX_SEQ_LEN", "log",
})


def augment_all() -> None:
    """No-op: the engine owns its model stack; nothing to monkey-patch."""


def config_lade(**kwargs) -> None:
    """Record reference-style knobs. Recognized: LEVEL, WINDOW_SIZE,
    GUESS_SET_SIZE (-1 = unbounded, mapped to the lossless bigram pool),
    ALWAYS_FWD_ONE, POOL_FROM_PROMPT, USE_FLASH, DEBUG (per-generate
    summary banner), DIST_WORKERS (-> tensor-parallel axis size, not ported
    yet), MAX_SEQ_LEN. Unknown keys raise a UserWarning: the reference
    silently absorbs them, which turns typos into silently-different
    behavior. SPLIT_FLAG is accepted but warned as a no-op: the reference
    sets it and never reads it."""
    import warnings
    unknown = set(kwargs) - _KNOWN_KEYS
    if unknown:
        warnings.warn(
            f"config_lade: unrecognized keys {sorted(unknown)} have no "
            "effect (reference CONFIG_MAP would silently absorb them)",
            UserWarning, stacklevel=2)
    if kwargs.get("SPLIT_FLAG") is not None:
        warnings.warn(
            "config_lade: SPLIT_FLAG is a dead key in the reference "
            "(set at utils.py:24-25, never read) and has no effect here",
            UserWarning, stacklevel=2)
    CONFIG_MAP.update(kwargs)
    if "log" not in CONFIG_MAP:
        CONFIG_MAP["log"] = DecodeLog()


def _configs() -> Tuple[LookaheadConfig, EngineConfig]:
    g = CONFIG_MAP.get("GUESS_SET_SIZE", 60)
    key_len = 1
    if g == -1:
        g = UNLIMITED_POOL_CAP
        key_len = UNLIMITED_POOL_KEY_LEN
    lcfg = LookaheadConfig(
        level=CONFIG_MAP.get("LEVEL", 8),
        window_size=CONFIG_MAP.get("WINDOW_SIZE", 60),
        guess_set_size=g,
        pool_key_len=key_len,
        pool_from_prompt=bool(CONFIG_MAP.get("POOL_FROM_PROMPT", 0)),
        always_fwd_one=bool(CONFIG_MAP.get("ALWAYS_FWD_ONE", 1)),
        attention_impl="kernel" if CONFIG_MAP.get("USE_FLASH", 0) else "dense",
    )
    ecfg = EngineConfig(
        max_seq_len=CONFIG_MAP.get("MAX_SEQ_LEN", 2048),
        tp=CONFIG_MAP.get("DIST_WORKERS", 1),
    )
    return lcfg, ecfg


def get_engine(model_path: str, dtype=None, device=None):
    """Analog of the reference's ``get_model``: loads and converts the
    checkpoint through the port's ``load_pretrained`` onto ``device`` (the
    card unless it says otherwise) and builds the engine from CONFIG_MAP.
    ``DIST_WORKERS`` above 1 is the tensor-parallel mesh: every rank of a
    started world (``parallel/launch.py`` or ``torchrun``) calls this,
    builds ``make_mesh(tp=DIST_WORKERS)`` and keeps its shard of the
    model."""
    import torch
    from .models.convert import load_pretrained
    from .parallel.sharding import make_mesh, shard_params

    lcfg, ecfg = _configs()
    log = CONFIG_MAP.get("log")
    if log is not None and "DEBUG" in CONFIG_MAP:
        # only an explicit DEBUG knob overrides a user-constructed
        # DecodeLog(debug=True); absent means "leave the log's own flag"
        log.debug = bool(CONFIG_MAP["DEBUG"])
    device = device if device is not None else "cuda"
    mesh = None
    if ecfg.tp > 1:
        mesh = make_mesh(tp=ecfg.tp, devices=device)
        device = mesh.device
    mcfg, params, tok = load_pretrained(
        model_path, dtype=dtype or torch.bfloat16, device=device)
    if mesh is not None:
        params = shard_params(params, mesh, mcfg)
    eng = LookaheadEngine(mcfg, params, lcfg, ecfg, log=log, device=device,
                          mesh=mesh)
    return eng, tok


def log_history(clear: bool = False) -> None:
    """The reference's ``log_history``: print the acceleration summary."""
    log: Optional[DecodeLog] = CONFIG_MAP.get("log")
    if log is not None:
        msg = log.log_history(clear=clear)
        if msg:
            print(msg)


def save_log(path: str) -> None:
    """The reference's ``save_log`` (JSON instead of ``torch.save``)."""
    log: Optional[DecodeLog] = CONFIG_MAP.get("log")
    if log is not None:
        log.save(path)


def use_lade() -> bool:
    """Env-tier switch (the reference's ``USE_LADE``)."""
    return bool(int(os.environ.get("USE_LADE", "1")))
