"""The port's applications on the CPU at tiny sizes: the Markov corpus
and the transition-cycle recipe equal the JAX package's, the chatbot's
canned, ``--kv-reuse`` and context-full paths (stub tokenizer, stubbed
``load_pretrained``, as ``test_chatbot_app.py`` does), ``run_eval``'s
answer file equal to the JAX harness's on the same carried weights,
``minimal --synthetic``, ``train_synthetic`` and ``bench_learned``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import lookaheaddecoding_tpu as jlt
from applications import eval_common as jeval
from applications import train_synthetic as jtrain_synthetic
from applications.eval_mtbench import build_prompt as jmtbench_prompt
import lookaheaddecoding_tpu_torch as lt
import torch_parallel_worker as W
from lookaheaddecoding_tpu_torch.parallel.launch import launch
from lookaheaddecoding_tpu_torch.applications import (
    bench_learned, chatbot, eval_common, eval_mtbench, minimal, synthetic,
    train_synthetic)

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512)


class StubTokenizer:
    eos_token_id = 1

    def __init__(self, cap=48):
        self.cap = cap

    def __call__(self, text, **kw):
        ids = [(2 + (ord(c) % 60)) for c in text][:self.cap]

        class R:
            input_ids = ids
        return R()

    def decode(self, ids, **kw):
        return "".join(chr(int(i) % 26 + 97) for i in ids)


def carried():
    """float32 weights from JAX's init, for both packages."""
    jcfg = jlt.LlamaConfig(**ARCH, dtype=jnp.float32)
    tree = jax.device_get(jlt.init_params(jcfg, jax.random.PRNGKey(0),
                                          scale=0.5))
    cfg = lt.LlamaConfig(**ARCH, dtype=torch.float32)
    return jcfg, tree, cfg, lt.params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("order,active", [(1, 0), (2, 16)])
def test_markov_sampler_equals_jax(order, active, seed):
    ours = train_synthetic.make_markov_sampler(2048, seed=seed, order=order,
                                               active_vocab=active)
    theirs = jtrain_synthetic.make_markov_sampler(
        2048, seed=seed, order=order, active_vocab=active)
    a = ours(4, 65, np.random.RandomState(seed + 1))
    b = theirs(4, 65, np.random.RandomState(seed + 1))
    assert a.dtype == b.dtype == np.int64
    np.testing.assert_array_equal(a, b)
    assert a.max() < (active or 2048)


def test_model_config_has_the_published_widths():
    j = jtrain_synthetic.model_config()
    t = train_synthetic.model_config()
    for f in ("vocab_size", "hidden_size", "intermediate_size",
              "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "max_position_embeddings"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.head_dim == 64 and t.dtype == torch.bfloat16


def test_transition_recipe_equals_bench():
    ours = synthetic.transition_embed_head(3, 32, 300)
    theirs = bench._transition_embed_head(3, 32, 300)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    nxt = ours[2]
    p = synthetic.make_prompt(nxt, start=5, n=10)
    assert all(p[i + 1] == nxt[p[i]] for i in range(9))


def _fake_load(model, dtype=None, device=None):
    _, _, cfg, params = carried()
    return cfg, params, StubTokenizer()


CHAT = ["--canned", "--level", "3", "--window", "4", "--guess", "3",
        "--prefill-chunk", "16", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    [], ["--kv-reuse"],
    ["--do-sample", "--temperature", "0.9", "--top-k", "16"],
    ["--kv-reuse", "--do-sample"],
])
def test_chatbot_canned_smoke(monkeypatch, capsys, extra):
    monkeypatch.setattr(lt, "load_pretrained", _fake_load)
    chatbot.main(CHAT + ["--max-new-tokens", "8", "--max-seq-len", "256"]
                 + extra)
    out = capsys.readouterr().out
    assert out.count("tok/s]") == len(chatbot.CANNED)
    assert "ASSISTANT:" in out


def test_chatbot_kv_reuse_context_full_recovers(monkeypatch, capsys):
    """A conversation that outgrows max_seq_len drops its history and
    retries the turn instead of crashing."""
    monkeypatch.setattr(lt, "load_pretrained", _fake_load)
    chatbot.main(CHAT + ["--kv-reuse", "--max-new-tokens", "24",
                         "--max-seq-len", "128"])
    cap = capsys.readouterr()
    assert cap.out.count("tok/s]") == len(chatbot.CANNED)
    assert "context full" in cap.err


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


QUESTIONS = [{"question_id": 82, "turns": ["hello there", "tell me more"]},
             {"question_id": 81, "turns": ["compose a report"]}]
EVAL_ARGS = ["--max-new-token", "16", "--level", "4", "--window", "5",
             "--guess", "4", "--device", "cpu"]


def test_run_eval_answer_file_equals_jax_harness(tmp_path, monkeypatch):
    jcfg, tree, cfg, params = carried()
    lcfg = dict(level=4, window_size=5, guess_set_size=4)

    def port_engine(args):
        log = lt.DecodeLog()
        return (lt.LookaheadEngine(
            cfg, params, lt.LookaheadConfig(**lcfg),
            lt.EngineConfig(max_seq_len=256, prefill_chunk=16), log=log,
            device="cpu"), StubTokenizer(64), log)

    def jax_engine(args):
        log = jlt.DecodeLog()
        return (jlt.LookaheadEngine(
            jcfg, jax.tree.map(jnp.asarray, tree), jlt.LookaheadConfig(**lcfg),
            jlt.EngineConfig(max_seq_len=256, prefill_chunk=16,
                             dtype="float32"), log=log),
            StubTokenizer(64), log)

    monkeypatch.setattr(eval_common, "make_engine", port_engine)
    monkeypatch.setattr(jeval, "make_engine", jax_engine)
    files = {}
    for name, mod, prompt in (("port", eval_common, eval_mtbench.build_prompt),
                              ("jax", jeval, jmtbench_prompt)):
        args = mod.base_parser().parse_args(
            [a for a in EVAL_ARGS if name == "port" or a not in
             ("--device", "cpu")])
        files[name] = str(tmp_path / f"{name}.jsonl")
        stats = mod.run_eval(args, QUESTIONS, prompt, files[name],
                             num_turns=lambda q: len(q["turns"]))
        assert len(stats) == 3
    rows = {k: read_jsonl(v) for k, v in files.items()}
    assert [r["question_id"] for r in rows["port"]] == [81, 82]
    for r in rows.values():
        for row in r:
            row.pop("tstamp")
    assert rows["port"] == rows["jax"]

    # a duplicate answer appended: reorg keeps the last, sorted
    with open(files["port"], "a") as f:
        f.write(json.dumps({"question_id": 81, "model_id": "x",
                            "choices": [{"index": 0, "turns": ["v2"]}],
                            "tstamp": 0}) + "\n")
    eval_common.reorg_answer_file(files["port"])
    lines = read_jsonl(files["port"])
    assert [r["question_id"] for r in lines] == [81, 82]
    assert lines[0]["choices"][0]["turns"] == ["v2"]


def test_run_eval_baseline_sample_and_synthetic_modes(tmp_path, capsys):
    for i, extra in enumerate((["--use-lade", "0"], ["--do-sample"], [])):
        args = eval_common.base_parser().parse_args(
            ["--max-new-token", "8", "--synthetic", "--max-seq-len", "512",
             "--device", "cpu"] + extra)
        stats = eval_common.run_eval(
            args, [{"question_id": 1, "turns": ["hi"]}],
            eval_mtbench.build_prompt, str(tmp_path / f"a{i}.jsonl"))
        assert stats and stats[0][1] > 0
    assert "AVERAGE THROUGHPUT2" in capsys.readouterr().out
    # --tp 2: each rank of a two-rank gloo world builds the tp=2 mesh and
    # its shard through the stubbed loader, and decodes the unsharded
    # engine's tokens
    jcfg, tree, cfg, params = carried()
    W.save_tree(tmp_path / "tiny.npz", tree)
    prompt = list(np.random.RandomState(0).randint(0, 128, size=16))
    want = lt.LookaheadEngine(
        cfg, params, lt.LookaheadConfig(level=5, window_size=10,
                                        guess_set_size=10,
                                        pool_from_prompt=True),
        lt.EngineConfig(max_seq_len=256, prefill_chunk=128),
        device="cpu").generate(prompt, 24)
    ranks = launch(f"{W.__file__}:eval_tp2", 2, "gloo",
                   "cpu", dict(data=str(tmp_path), prompt=[int(t) for t in prompt],
                        n=24),
                   timeout=240, threads=1)
    for rank, got in enumerate(ranks):
        assert got["tp"] == 2 and got["coords"]["tp"] == rank
        assert got["wq_cols"] == 32 and got["loaded_on"] == ["cpu"]
        assert got["tokens"] == want.tokens.tolist()


def test_minimal_synthetic_tiny_on_cpu(capsys):
    minimal.main(["--synthetic", "--tiny", "--device", "cpu",
                  "--max-new-tokens", "48", "--level", "4", "--window", "5",
                  "--guess", "4"])
    out = capsys.readouterr().out
    assert "greedy outputs identical: True" in out
    steps = int(out.split("lookahead:")[1].split("(")[1].split()[0])
    assert steps < 48          # the cycle's guesses were accepted


def test_train_synthetic_main_saves_a_bf16_checkpoint(tmp_path, capsys):
    out = str(tmp_path / "ckpt")
    train_synthetic.main(["--steps", "2", "--batch", "2", "--seq-len", "9",
                          "--order", "2", "--active-vocab", "16",
                          "--device", "cpu", "--out", out])
    assert "step 1: loss" in capsys.readouterr().out
    cfg, params = lt.load_params(out, device="cpu")
    assert cfg == train_synthetic.model_config()
    assert params["layers"]["wq"].dtype == torch.bfloat16
    # the JAX rule: every float32 leaf of more than one axis (the stacked
    # norms too) is saved in bfloat16, the final norm stays float32
    assert params["layers"]["input_norm"].dtype == torch.bfloat16
    assert params["final_norm"].dtype == torch.float32
    assert params["embed"].device.type == "cpu"


def test_train_stops_at_its_budget_and_logs():
    logged = []
    _, _, losses, done, _ = train_synthetic.train(
        steps=50, batch=2, seq_len=9, order=1, device="cpu", budget_s=1e-9,
        log_every=10, log=logged.append)
    assert done == 1 and list(losses) == [0] and len(logged) == 1


def test_bench_learned_prints_jax_json_line(tmp_path, capsys, monkeypatch):
    """On a tiny saved checkpoint (no training): AR against the three
    candidates, token-exact in float32, JAX's JSON line last."""
    _, _, cfg, params = carried()
    ckpt = str(tmp_path / "tiny")
    lt.save_params(ckpt, cfg, params)
    bench_learned.main(["--ckpt", ckpt, "--max-new", "16", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == (
        "learned_model_order1_k1_greedy_lookahead_speedup_vs_ar")
    assert set(line["detail"]) == {"ar_tokens_per_sec", "N5_W7_G7",
                                   "N5_W15_G15", "N7_W20_G20"}
    assert all(v["token_exact"] for k, v in line["detail"].items()
               if k.startswith("N"))
