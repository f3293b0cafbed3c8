"""Shared evaluation harness (the JAX package's
``applications/eval_common.py`` on the port).

The reference's five FastChat-derived eval scripts share one skeleton:
question loading, conversation templating, per-turn timing, JSONL answers
with append-mode + dedup/sort ``reorg_answer_file``, an AVERAGE THROUGHPUT
report. Here the skeleton is factored once; dataset frontends
(``eval_mtbench``, ``eval_xsum``, ``eval_cnndm``, ``eval_humaneval``,
``eval_classeval``) plug in a ``load_questions`` and a ``build_prompt``.
``--synthetic`` runs the real engine on a structured synthetic model with a
byte-level tokenizer, with no download.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, List


LLAMA2_SYS = (
    "You are a helpful, respectful and honest assistant. Always answer as "
    "helpfully as possible, while being safe.")


def llama2_chat_prompt(user_msg: str, system: str = LLAMA2_SYS) -> str:
    """Llama-2-chat [INST] templating (reference eval_xsum.py:285-301)."""
    return f"[INST] <<SYS>>\n{system}\n<</SYS>>\n\n{user_msg} [/INST]"


def base_parser() -> argparse.ArgumentParser:
    """CLI surface mirroring the reference's flags
    (eval_mtbench.py:484-523)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=False,
                    default="TinyLlama/TinyLlama-1.1B-Chat-v1.0")
    ap.add_argument("--model-id", default="lade-tpu")
    ap.add_argument("--answer-file", default=None)
    ap.add_argument("--question-begin", type=int, default=None)
    ap.add_argument("--question-end", type=int, default=None)
    ap.add_argument("--max-new-token", type=int, default=1024)
    ap.add_argument("--level", type=int, default=5)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--guess", type=int, default=10)
    ap.add_argument("--use-flash", type=int, default=None,
                    help="1 = the CUDA attention kernel, 0 = the dense "
                    "path; unset = auto (the kernel on the card)")
    ap.add_argument("--do-sample", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--use-lade", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks: above 1, every rank of a "
                    "started world (parallel/launch.py or torchrun) builds "
                    "make_mesh(tp=...) and keeps its shard of the model")
    ap.add_argument("--device", default="cuda",
                    help="where to run (the card unless 'cpu')")
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--stats-file", default=None,
                    help="JSON dump of per-turn [latency_s, tokens] pairs "
                         "(reference saves these as .pt, eval_mtbench.py:381)")
    ap.add_argument("--synthetic", action="store_true",
                    help="zero-egress mode: run the REAL engine end-to-end "
                         "on a structured synthetic model with a byte-level "
                         "tokenizer (no HF checkpoint needed); the text is "
                         "meaningless but every harness/engine path is live")
    return ap


class ByteTokenizer:
    """Trivial reversible-enough tokenizer for the --synthetic eval mode:
    token = 2 + byte (ids 0/1 reserved for pad/eos)."""

    eos_token_id = 1

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, text, truncation=False, max_length=None):
        import types
        ids = [2 + (b % (self.vocab_size - 2)) for b in text.encode()]
        if truncation and max_length:
            ids = ids[:max_length]
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens=True):
        return bytes(
            (int(i) - 2) % 256 for i in ids if int(i) >= 2
        ).decode("latin1")


def _attention_impl(args) -> str:
    if args.use_flash is None:
        return "auto"
    return "kernel" if args.use_flash else "dense"


def make_synthetic_engine(args):
    """Small structured-weight model whose greedy decode follows a
    deterministic token cycle (``synthetic.py``'s construction, scaled
    down, with a 48-token cycle): real prefill/decode/pool/verification,
    no network."""
    import numpy as np
    import torch
    import lookaheaddecoding_tpu_torch as lt

    v, h = 258, 256
    mcfg = lt.LlamaConfig(
        vocab_size=v, hidden_size=h, intermediate_size=512,
        num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=args.max_seq_len, dtype=torch.float32)
    params = lt.init_params(mcfg, seed=0, scale=0.002, device=args.device)
    rng = np.random.RandomState(0)
    embed = rng.randn(v, h).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    cycle = rng.choice(v, size=48, replace=False)
    nxt = np.full(v, cycle[0], np.int64)
    nxt[cycle] = np.roll(cycle, -1)
    head = np.zeros((h, v), np.float32)
    head[:, nxt[cycle]] = embed[cycle].T
    params["embed"] = torch.from_numpy(embed * np.sqrt(h)).to(
        args.device, torch.float32)
    params["lm_head"] = torch.from_numpy(head).to(args.device)

    log = lt.DecodeLog()
    eng = lt.LookaheadEngine(
        mcfg, params,
        lt.LookaheadConfig(
            level=args.level, window_size=args.window,
            guess_set_size=args.guess, pool_from_prompt=True,
            attention_impl=_attention_impl(args)),
        lt.EngineConfig(max_seq_len=args.max_seq_len, prefill_chunk=128),
        log=log, device=args.device)
    return eng, ByteTokenizer(v), log


def make_engine(args):
    import torch
    import lookaheaddecoding_tpu_torch as lt

    if getattr(args, "synthetic", False):
        return make_synthetic_engine(args)
    mesh, device = None, args.device
    if args.tp > 1:
        from ..parallel.sharding import make_mesh, shard_params
        mesh = make_mesh(tp=args.tp, devices=args.device)
        device = mesh.device
    mcfg, params, tok = lt.load_pretrained(
        args.model_path, dtype=torch.bfloat16, device=device)
    if mesh is not None:
        params = shard_params(params, mesh, mcfg)
    log = lt.DecodeLog()
    eng = lt.LookaheadEngine(
        mcfg, params,
        lt.LookaheadConfig(
            level=args.level, window_size=args.window,
            guess_set_size=args.guess, pool_from_prompt=True,
            attention_impl=_attention_impl(args)),
        lt.EngineConfig(max_seq_len=args.max_seq_len, prefill_chunk=128,
                        tp=args.tp),
        log=log, device=device, mesh=mesh)
    return eng, tok, log


def run_eval(
    args,
    questions: List[dict],
    build_prompt: Callable[[dict, List[str]], str],
    answer_file: str,
    num_turns: Callable[[dict], int] = lambda q: 1,
    question_id: Callable[[dict], object] = lambda q: q.get("question_id"),
):
    """Per-question generate loop with timing + JSONL answers (reference
    eval_mtbench.py:195-386)."""
    import lookaheaddecoding_tpu_torch as lt

    eng, tok, log = make_engine(args)
    qs = questions[args.question_begin:args.question_end]

    # warm-up on the SAME path that will be timed (reference warms on the
    # first question, eval_mtbench.py:272-289)
    if qs:
        warm = tok(build_prompt(qs[0], []), truncation=True,
                   max_length=args.max_seq_len // 2).input_ids
        if args.do_sample:
            eng.generate_sample(
                warm, 8, lt.SamplingConfig(temperature=args.temperature),
                eos_token_id=tok.eos_token_id)
        elif args.use_lade:
            eng.generate(warm, 8, eos_token_id=tok.eos_token_id)
        else:
            eng.generate_baseline(warm, 8, eos_token_id=tok.eos_token_id)

    stats = []
    os.makedirs(os.path.dirname(os.path.abspath(answer_file)), exist_ok=True)
    for qi, q in enumerate(qs):
        turns_out = []
        prior: List[str] = []
        for t in range(num_turns(q)):
            prompt_text = build_prompt(q, prior)
            ids = tok(prompt_text, truncation=True,
                      max_length=args.max_seq_len - args.max_new_token - 64
                      ).input_ids
            t0 = time.perf_counter()
            if args.do_sample:
                r = eng.generate_sample(
                    ids, args.max_new_token,
                    lt.SamplingConfig(temperature=args.temperature),
                    eos_token_id=tok.eos_token_id)
            elif args.use_lade:
                r = eng.generate(ids, args.max_new_token,
                                 eos_token_id=tok.eos_token_id)
            else:
                r = eng.generate_baseline(ids, args.max_new_token,
                                          eos_token_id=tok.eos_token_id)
            dt = time.perf_counter() - t0
            text = tok.decode(r.new_tokens, skip_special_tokens=True)
            turns_out.append(text)
            prior.append(text)
            stats.append([dt, r.num_generated])

        with open(answer_file, "a") as f:
            f.write(json.dumps({
                "question_id": question_id(q),
                "model_id": args.model_id,
                "choices": [{"index": 0, "turns": turns_out}],
                "tstamp": time.time(),
            }) + "\n")
        print(f"[{qi + 1}/{len(qs)}] {question_id(q)} "
              f"({stats[-1][1]} tok, {stats[-1][1] / stats[-1][0]:.1f} tok/s)")

    reorg_answer_file(answer_file)
    if getattr(args, "stats_file", None):
        with open(args.stats_file, "w") as f:
            json.dump(stats, f)
    total_t = sum(s[0] for s in stats)
    total_tok = sum(s[1] for s in stats)
    # reference prints AVERAGE THROUGHPUT1/2 (eval_mtbench.py:381-386)
    print("AVERAGE THROUGHPUT1: ",
          sum(s[1] / s[0] for s in stats) / max(len(stats), 1))
    print("AVERAGE THROUGHPUT2: ", total_tok / max(total_t, 1e-9))
    if log.records:
        print(log.log_history())
    return stats


def reorg_answer_file(answer_file: str) -> None:
    """Sort by question id and de-duplicate, keeping the last answer
    (reference eval_mtbench.py:389-400) — enables crude re-runs of
    partially-completed evals via append mode."""
    answers = {}
    with open(answer_file) as fin:
        for line in fin:
            qid = json.loads(line)["question_id"]
            answers[qid] = line
    with open(answer_file, "w") as fout:
        for qid in sorted(answers.keys(), key=lambda x: str(x)):
            fout.write(answers[qid])
