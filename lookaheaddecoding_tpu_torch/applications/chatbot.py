"""Interactive chatbot REPL with streaming lookahead decoding.

The JAX package's ``applications/chatbot.py`` on the port (Llama-2-chat
``[INST]`` templating, warm-up generate, per-turn throughput report,
colored accepted-token streaming via COLOR_PRINT; ``--kv-reuse`` carries
the conversation's KV as a ``PrefixCache``, and a conversation that
outgrows ``--max-seq-len`` drops its history instead of crashing):

    python -m lookaheaddecoding_tpu_torch.applications.chatbot \\
        --model TinyLlama/TinyLlama-1.1B-Chat-v1.0 [--kv-reuse] [--do-sample]
"""

import argparse
import os
import sys
import time

SYSTEM_PROMPT = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers.")

CANNED = [
    "Hello! What can you do?",
    "Write a poem about TPUs.",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="TinyLlama/TinyLlama-1.1B-Chat-v1.0")
    ap.add_argument("--level", type=int, default=5)
    ap.add_argument("--window", type=int, default=15)
    ap.add_argument("--guess", type=int, default=15)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--canned", action="store_true",
                    help="run canned prompts instead of interactive input")
    ap.add_argument("--attention", choices=["auto", "kernel", "dense"],
                    default="auto",
                    help="auto: the CUDA kernel on the card")
    ap.add_argument("--device", default="cuda",
                    help="where to run (the card unless 'cpu')")
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--prefill-chunk", type=int, default=128)
    ap.add_argument("--do-sample", action="store_true",
                    help="stream the SpecInfer-verified sampling decode "
                    "instead of greedy (beyond the reference, whose chat "
                    "mode is greedy-only)")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--kv-reuse", action="store_true",
                    help="carry the conversation KV across turns (prefix "
                    "caching): each turn prefills only the new user "
                    "message. History is tokenized per segment so earlier "
                    "token ids never change.")
    ap.add_argument("--steps-per-yield", type=int, default=1,
                    help="decode steps fused per streamed chunk: >1 "
                    "amortizes the per-step host read at the cost of "
                    "chunkier streaming; output is identical for any value")
    ap.add_argument("--seed", type=int, default=None,
                    help="base sampling seed; default draws one from the "
                    "OS so repeated --do-sample runs actually vary. Each "
                    "turn advances it so draws never repeat across turns.")
    args = ap.parse_args(argv)
    if not args.do_sample and (args.temperature != 0.7 or args.top_k != 0
                               or args.top_p != 1.0):
        print("warning: --temperature/--top-k/--top-p have no effect "
              "without --do-sample (chat runs greedy)", file=sys.stderr)
    color = int(os.environ.get("COLOR_PRINT", 0))

    import torch
    import lookaheaddecoding_tpu_torch as lt

    mcfg, params, tok = lt.load_pretrained(args.model, dtype=torch.bfloat16,
                                           device=args.device)
    eng = lt.LookaheadEngine(
        mcfg, params,
        lt.LookaheadConfig(level=args.level, window_size=args.window,
                           guess_set_size=args.guess, pool_from_prompt=True,
                           attention_impl=args.attention),
        lt.EngineConfig(max_seq_len=args.max_seq_len,
                        prefill_chunk=args.prefill_chunk),
        device=args.device,
    )
    sampling = (lt.SamplingConfig(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p)
                if args.do_sample else None)
    seed = (args.seed if args.seed is not None
            else int.from_bytes(os.urandom(4), "little"))
    turn_no = [0]   # each turn advances the seed so draws never repeat

    history = ""
    # --kv-reuse state: token-level history (tokenized per segment so ids
    # are stable) + the previous turn's PrefixCache
    hist_ids = tok(f"<<SYS>>{SYSTEM_PROMPT}<</SYS>>").input_ids
    last_px = None

    def stream_print(gen, t0):
        n = 0
        pieces = []
        prev = ""
        while True:
            try:
                chunk = next(gen)
            except StopIteration as e:
                px = e.value
                break
            n += len(chunk)
            pieces.extend(chunk.tolist())
            text = tok.decode(pieces, skip_special_tokens=True)
            delta = text[len(prev):]
            if color and len(chunk) > 1:
                delta = f"\033[94m{delta}\033[0m"   # accepted-run highlight
            print(delta, end="", flush=True)
            prev = text
        dt = time.time() - t0
        print(f"\n[{n} tokens, {n / dt:.1f} tok/s]")
        return prev, pieces, px

    def _reset_conversation():
        nonlocal history, hist_ids, last_px
        history = ""
        hist_ids = tok(f"<<SYS>>{SYSTEM_PROMPT}<</SYS>>").input_ids
        last_px = None

    def _turn_inner(user_text, turn_seed):
        nonlocal history, hist_ids, last_px
        if args.kv_reuse:
            new_hist = hist_ids + tok(f"[INST] {user_text} [/INST]",
                                      add_special_tokens=False).input_ids
            prev, pieces, last_px = stream_print(
                eng.generate_stream(new_hist, args.max_new_tokens,
                                    eos_token_id=tok.eos_token_id,
                                    seed=turn_seed, sampling=sampling,
                                    prefix=last_px, return_prefix=True,
                                    steps_per_yield=args.steps_per_yield),
                time.time())
            hist_ids = new_hist + pieces
            return
        new_history = history + f"[INST] {user_text} [/INST]"
        prompt = tok(f"<<SYS>>{SYSTEM_PROMPT}<</SYS>>{new_history}").input_ids
        prev, _, _ = stream_print(
            eng.generate_stream(prompt, args.max_new_tokens,
                                eos_token_id=tok.eos_token_id,
                                seed=turn_seed, sampling=sampling,
                                steps_per_yield=args.steps_per_yield),
            time.time())
        history = new_history + prev

    def turn(user_text):
        turn_no[0] += 1
        turn_seed = seed + turn_no[0]
        try:
            _turn_inner(user_text, turn_seed)
        except ValueError:
            # conversation outgrew max_seq_len (the prompt+composite
            # capacity check): degrade gracefully instead of crashing the
            # REPL — drop the history (and any carried KV) and retry the
            # turn on a fresh context
            print(f"\n[context full at max_seq_len={args.max_seq_len}; "
                  "dropping conversation history]", file=sys.stderr)
            _reset_conversation()
            try:
                _turn_inner(user_text, turn_seed)
            except ValueError as e:
                print(f"[message too long for this engine: {e}]",
                      file=sys.stderr)

    print("warming up (the first launch of a kernel builds it)...")
    eng.generate(tok("warmup").input_ids, 8)

    if args.canned:
        for q in CANNED:
            print(f"\nUSER: {q}\nASSISTANT: ", end="")
            turn(q)
    else:
        while True:
            try:
                q = input("\nUSER: ")
            except EOFError:
                break
            if q.strip() in ("exit", "quit"):
                break
            print("ASSISTANT: ", end="")
            turn(q)


if __name__ == "__main__":
    main()
