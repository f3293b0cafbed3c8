"""Minimal lookahead decoding demo: generate 256 tokens greedily with and
without lookahead and report throughput, compression ratio and output
equality (the JAX package's ``applications/minimal.py``).

With local weights:
    python -m lookaheaddecoding_tpu_torch.applications.minimal \\
        --model TinyLlama/TinyLlama-1.1B-Chat-v1.0
Without downloads (the transition-cycle model at TinyLlama-1.1B's widths):
    python -m lookaheaddecoding_tpu_torch.applications.minimal --synthetic
"""

from __future__ import annotations

import argparse
import time

import numpy as np

# ``--tiny``: the transition-cycle recipe at a width a CPU runs in seconds
TINY_ARCH = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=2048)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="TinyLlama/TinyLlama-1.1B-Chat-v1.0")
    ap.add_argument("--synthetic", action="store_true",
                    help="use synthetic predictable weights (no downloads)")
    ap.add_argument("--tiny", action="store_true",
                    help="with --synthetic: a 2-layer model of hidden 128 "
                    "and vocab 512, in float32")
    ap.add_argument("--level", type=int, default=7)
    ap.add_argument("--window", type=int, default=20)
    ap.add_argument("--guess", type=int, default=20)
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--attention", choices=["auto", "kernel", "dense"],
                    default="auto",
                    help="auto: the CUDA kernel on the card")
    ap.add_argument("--device", default="cuda",
                    help="where to run (the card unless 'cpu')")
    args = ap.parse_args(argv)

    import torch
    import lookaheaddecoding_tpu_torch as lt
    from .synthetic import build_headline

    lcfg = lt.LookaheadConfig(
        level=args.level, window_size=args.window, guess_set_size=args.guess,
        pool_from_prompt=True, attention_impl=args.attention)
    ecfg = lt.EngineConfig(max_seq_len=1024, prefill_chunk=128)

    tok = None
    eos = None
    if args.synthetic:
        mcfg, params, prompt, _ = build_headline(
            args.device, TINY_ARCH if args.tiny else None,
            torch.float32 if args.tiny else torch.bfloat16)
    else:
        mcfg, params, tok = lt.load_pretrained(
            args.model, dtype=torch.bfloat16, device=args.device)
        text = ("Explain, step by step, why the sky appears blue during the "
                "day and red at sunset.")
        chat = f"<|user|>\n{text}</s>\n<|assistant|>\n"
        prompt = tok(chat).input_ids
        eos = tok.eos_token_id

    log = lt.DecodeLog()
    eng = lt.LookaheadEngine(mcfg, params, lcfg, ecfg, log=log,
                             device=args.device)

    # warm both paths (the first launch of a kernel builds it)
    eng.generate(prompt, 8, eos_token_id=eos)
    eng.generate_baseline(prompt, 8, eos_token_id=eos)

    t0 = time.perf_counter()
    base = eng.generate_baseline(prompt, args.max_new_tokens, eos_token_id=eos)
    t_base = time.perf_counter() - t0

    t0 = time.perf_counter()
    if args.sample:
        lade = eng.generate_sample(
            prompt, args.max_new_tokens,
            lt.SamplingConfig(temperature=args.temperature),
            eos_token_id=eos)
    else:
        lade = eng.generate(prompt, args.max_new_tokens, eos_token_id=eos)
    t_lade = time.perf_counter() - t0

    if tok is not None:
        print("=== output ===")
        print(tok.decode(lade.new_tokens))

    print(f"\nbaseline : {base.num_generated} tok in {t_base:.2f}s "
          f"= {base.num_generated / t_base:.1f} tok/s")
    print(f"lookahead: {lade.num_generated} tok in {t_lade:.2f}s "
          f"= {lade.num_generated / t_lade:.1f} tok/s "
          f"({lade.steps} steps, compression {lade.compression_ratio:.2f})")
    print(f"speedup  : {t_base / t_lade:.2f}x")
    if not args.sample:
        same = np.array_equal(base.tokens, lade.tokens)
        print(f"greedy outputs identical: {same}")
    print(log.log_history())


if __name__ == "__main__":
    main()
