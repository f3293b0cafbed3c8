"""Learned-model lookahead benchmark.

Unlike the transition-cycle model (``synthetic.py``), which saturates the
GUESS_SIZE compression cap, this benchmark uses a model TRAINED on
partially-predictable synthetic text (``train_synthetic.py``), so window
trajectories and pool n-grams succeed at realistic rates. Trains on first
use (on the card), then runs AR against lookahead at (5,7,7), (5,15,15)
and (7,20,20) and prints one JSON line, the JAX package's
``bench_learned.py`` line.

    python -m lookaheaddecoding_tpu_torch.applications.bench_learned \\
        [--ckpt PATH] [--retrain] [--order 2 --active-vocab 16]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

CANDIDATES = ((5, 7, 7), (5, 15, 15), (7, 20, 20))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt",
                    default=os.path.expanduser("~/.cache/lade_synth_ckpt"))
    ap.add_argument("--retrain", action="store_true")
    ap.add_argument("--max-new", type=int, default=256)
    ap.add_argument("--order", type=int, default=1, choices=(1, 2))
    ap.add_argument("--pool-key-len", type=int, default=1, choices=(1, 2))
    ap.add_argument("--active-vocab", type=int, default=128,
                    help="order-2 corpus token range (must match training)")
    ap.add_argument("--device", default="cuda",
                    help="where to train and serve (the card unless 'cpu')")
    args = ap.parse_args(argv)
    if args.order == 2 and args.ckpt.endswith("lade_synth_ckpt"):
        args.ckpt += "_o2"

    import lookaheaddecoding_tpu_torch as lt
    from . import train_synthetic

    if args.retrain or not os.path.exists(args.ckpt + ".npz"):
        print("training synthetic model...", file=sys.stderr, flush=True)
        train_synthetic.main(
            ["--out", args.ckpt, "--order", str(args.order),
             "--active-vocab", str(args.active_vocab), "--device",
             args.device] + (["--steps", "2500"] if args.order == 2 else []))

    mcfg, params = lt.load_params(args.ckpt, device=args.device)
    sampler = train_synthetic.make_markov_sampler(
        mcfg.vocab_size, order=args.order,
        active_vocab=args.active_vocab if args.order == 2 else 0)
    prompt = sampler(1, 128, np.random.RandomState(7))[0].tolist()

    results = {}
    base_tps = None
    for (level, window, guess) in CANDIDATES:
        eng = lt.LookaheadEngine(
            mcfg, params,
            lt.LookaheadConfig(level=level, window_size=window,
                               guess_set_size=guess, pool_from_prompt=True,
                               pool_key_len=args.pool_key_len),
            lt.EngineConfig(max_seq_len=1024, prefill_chunk=128),
            device=args.device)
        if base_tps is None:
            eng.generate_baseline(prompt, 8)
            eng.generate_baseline(prompt, args.max_new)
            t0 = time.perf_counter()
            rb = eng.generate_baseline(prompt, args.max_new)
            base_tps = rb.num_generated / (time.perf_counter() - t0)
            print(f"AR baseline: {base_tps:.1f} tok/s", file=sys.stderr)
        eng.generate(prompt, 8)
        eng.generate(prompt, args.max_new)
        t0 = time.perf_counter()
        r = eng.generate(prompt, args.max_new)
        tps = r.num_generated / (time.perf_counter() - t0)
        exact = bool(np.array_equal(r.tokens, rb.tokens))
        key = f"N{level}_W{window}_G{guess}"
        results[key] = {
            "tokens_per_sec": round(tps, 1),
            "speedup": round(tps / base_tps, 3),
            "compression_ratio": round(r.compression_ratio, 2),
            "token_exact": exact,
        }
        print(f"  {key}: {tps:.1f} tok/s, speedup {tps/base_tps:.2f}x, "
              f"ratio {r.compression_ratio:.2f}, exact {exact}",
              file=sys.stderr)

    best = max(results.values(), key=lambda r: r["speedup"])
    print(json.dumps({
        "metric": f"learned_model_order{args.order}_k{args.pool_key_len}"
                  "_greedy_lookahead_speedup_vs_ar",
        "value": best["speedup"],
        "unit": "x",
        "vs_baseline": round(best["speedup"] / 1.68, 3),
        "detail": {"ar_tokens_per_sec": round(base_tps, 1), **results},
    }))


if __name__ == "__main__":
    main()
