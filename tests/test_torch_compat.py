"""The port's compat shim against the JAX package's: ``_configs()`` field
by field for several knob dicts (the JAX ``"pallas"`` / ``"xla"`` read as
the port's ``"kernel"`` / ``"dense"``), the same warnings, ``get_engine``
through a stubbed loader (and with ``DIST_WORKERS=2`` on a two-rank gloo
world), and the ``always_fwd_one`` and window-init
cases of the JAX package's ``test_compat.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lookaheaddecoding_tpu as jlt
import lookaheaddecoding_tpu.compat as jlade
import lookaheaddecoding_tpu_torch as lt
import lookaheaddecoding_tpu_torch.compat as lade
import torch_parallel_worker as W
from lookaheaddecoding_tpu_torch.parallel.launch import launch

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)
IMPL = {"pallas": "kernel", "xla": "dense"}


@pytest.fixture(autouse=True)
def fresh_config_maps():
    for m in (lade, jlade):
        m.CONFIG_MAP.clear()
    yield
    for m in (lade, jlade):
        m.CONFIG_MAP.clear()


@pytest.mark.parametrize("knobs", [
    {},
    dict(LEVEL=5, WINDOW_SIZE=7, GUESS_SET_SIZE=-1, POOL_FROM_PROMPT=1,
         USE_FLASH=1, DEBUG=1, MAX_SEQ_LEN=512),
    dict(LEVEL=4, WINDOW_SIZE=5, GUESS_SET_SIZE=4, ALWAYS_FWD_ONE=0,
         USE_FLASH=0),
    dict(LEVEL=7, WINDOW_SIZE=20, GUESS_SET_SIZE=20, DIST_WORKERS=2,
         LOCAL_RANK=0, MAX_SEQ_LEN=4096),
], ids=["defaults", "unbounded_flash", "afo0_dense", "dist"])
def test_configs_equal_jax_field_by_field(knobs):
    for m in (lade, jlade):
        m.augment_all()
        m.config_lade(**knobs)
    lcfg, ecfg = lade._configs()
    jl, je = jlade._configs()
    want = dataclasses.asdict(jl)
    want["attention_impl"] = IMPL[want["attention_impl"]]
    assert dataclasses.asdict(lcfg) == want
    assert dataclasses.asdict(ecfg) == dataclasses.asdict(je)
    assert isinstance(lade.CONFIG_MAP["log"], lt.DecodeLog)
    if knobs.get("GUESS_SET_SIZE") == -1:
        assert lcfg.guess_set_size == lade.UNLIMITED_POOL_CAP == 16
        assert lcfg.pool_key_len == lade.UNLIMITED_POOL_KEY_LEN == 2


@pytest.mark.parametrize("knobs,match", [
    (dict(WINDOWSIZE=7), "unrecognized keys.*WINDOWSIZE"),
    (dict(SPLIT_FLAG=1), "SPLIT_FLAG is a dead key"),
])
def test_config_lade_warns_as_jax_does(knobs, match):
    msgs = []
    for m in (lade, jlade):
        with pytest.warns(UserWarning, match=match) as rec:
            m.config_lade(**knobs)
        msgs.append([str(w.message) for w in rec])
    assert msgs[0] == msgs[1]


def test_always_fwd_one_knob():
    lade.config_lade(ALWAYS_FWD_ONE=0, LEVEL=4, WINDOW_SIZE=5,
                     GUESS_SET_SIZE=4)
    assert lade._configs()[0].always_fwd_one is False
    lade.CONFIG_MAP.clear()
    lade.config_lade(ALWAYS_FWD_ONE=1)
    assert lade._configs()[0].always_fwd_one is True


def tree_of_tiny():
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    return jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                          scale=0.5))


def tiny():
    cfg = lt.LlamaConfig(**ARCH, dtype=torch.float32)
    return cfg, lt.params_from_numpy(tree_of_tiny(), cfg, "cpu")


def test_use_lade_reads_the_environment(monkeypatch):
    monkeypatch.setenv("USE_LADE", "0")
    assert lade.use_lade() is jlade.use_lade() is False
    monkeypatch.delenv("USE_LADE")
    assert lade.use_lade() is jlade.use_lade() is True


def test_get_engine_loads_through_the_ports_loader(monkeypatch, tmp_path):
    import lookaheaddecoding_tpu_torch.models.convert as convert
    cfg, params = tiny()
    calls = []

    def fake_load(path, dtype=None, device=None):
        calls.append((path, dtype, device))
        return cfg, params, "tok"
    monkeypatch.setattr(convert, "load_pretrained", fake_load)
    lade.config_lade(LEVEL=4, WINDOW_SIZE=5, GUESS_SET_SIZE=4,
                     POOL_FROM_PROMPT=1, USE_FLASH=1, MAX_SEQ_LEN=256,
                     DEBUG=0)
    eng, tok = lade.get_engine("some/model", device="cpu")
    assert calls == [("some/model", torch.bfloat16, "cpu")] and tok == "tok"
    assert eng.lcfg.attention_impl == "kernel" and eng.lcfg.level == 4
    prompt = list(np.random.RandomState(0).randint(0, 128, size=16))
    r = eng.generate(prompt, 24)
    assert (r.tokens == eng.generate_baseline(prompt, 24).tokens).all()
    assert lade.CONFIG_MAP["log"].records
    lade.save_log(str(tmp_path / "log.json"))
    assert lt.DecodeLog.load(str(tmp_path / "log.json")).records
    # DIST_WORKERS=2: each rank of a two-rank gloo world builds the tp=2
    # mesh and its shard through the same stubbed loader, and decodes the
    # unsharded engine's tokens
    W.save_tree(tmp_path / "tiny.npz", tree_of_tiny())
    ranks = launch(f"{W.__file__}:compat_tp2", 2, "gloo",
                   "cpu", dict(data=str(tmp_path), prompt=[int(t) for t in prompt],
                        n=24),
                   timeout=240, threads=1)
    for rank, got in enumerate(ranks):
        assert got["tp"] == 2 and got["coords"]["tp"] == rank
        assert got["embed_rows"] == 64 and got["loaded_on"] == ["cpu"]
        assert got["tokens"] == r.tokens.tolist()


def test_always_fwd_one_zero_token_exact_and_productive():
    """AFO=0 (slide the window by the full accepted span, random-refill
    the tail) stays token-exact against the AR baseline and still
    compresses on a repetitive prompt."""
    cfg, params = tiny()
    eng = lt.LookaheadEngine(
        cfg, params,
        lt.LookaheadConfig(level=4, window_size=5, guess_set_size=4,
                           always_fwd_one=False, pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=256, prefill_chunk=16), device="cpu")
    prompt = list(np.random.RandomState(3).randint(0, 128, size=12)) * 2
    base = eng.generate_baseline(prompt, 48)
    r = eng.generate(prompt, 48)
    np.testing.assert_array_equal(base.tokens, r.tokens)
    assert r.steps < base.steps
    assert eng.generate_sample(prompt, 24).num_generated > 0


@pytest.mark.parametrize("init", [
    "copy_from", "random_set", "order_copy_from", "copy_from_last"])
def test_window_init_variants_stay_token_exact(init):
    cfg, params = tiny()
    eng = lt.LookaheadEngine(
        cfg, params,
        lt.LookaheadConfig(level=4, window_size=5, guess_set_size=4,
                           window_init=init),
        lt.EngineConfig(max_seq_len=256, prefill_chunk=16), device="cpu")
    prompt = list(np.random.RandomState(0).randint(0, 128, size=14))
    np.testing.assert_array_equal(eng.generate_baseline(prompt, 40).tokens,
                                  eng.generate(prompt, 40).tokens)
