"""Train a small LLaMA on synthetic partially-predictable text, on the card.

Purpose: a *learned* benchmark model where no pretrained weights are
reachable. The corpus is a Markov chain with sparse transitions, so a
trained model predicts the next token at realistic rates: the
partial-predictability regime where lookahead decoding's window and pool
earn a compression between 1 and the GS cap, unlike the transition-cycle
model (``synthetic.py``) that saturates it. The port of the JAX package's
``applications/train_synthetic.py``: the same corpus for the same seed,
the same model widths, Adam, float32 training and bfloat16 matrices in the
saved checkpoint.

    python -m lookaheaddecoding_tpu_torch.applications.train_synthetic \\
        --order 2 --active-vocab 16 --steps 2500 --out ~/.cache/lade_ckpt

The checkpoint is then consumed by ``bench_learned.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch


def make_markov_sampler(vocab: int, seed: int = 0, branch: int = 4,
                        det_frac: float = 0.3, order: int = 1,
                        active_vocab: int = 0):
    """Markov-chain corpus with directly learnable transition tables.

    order=1: each token has ``branch`` successors ([0.55,0.25,0.13,0.07]);
    ``det_frac`` of tokens are fully deterministic. Greedy decoding of a
    well-trained model is then itself deterministic: compression saturates.

    order=2: successors depend on the PAIR of previous tokens (explicit
    [V, V, branch] table over a small ``active_vocab``). The n-gram pool
    keys on a single token, so candidates collide across different
    second-order contexts and verification misses at realistic rates: the
    mid-compression regime. (Tables are explicit, NOT hashed: a hashed
    context function is modular arithmetic the model would have to grok.)

    Returns ``sample(batch, length, rng)`` -> int64 [batch, length], the
    JAX package's tokens for the same seeds (numpy ``RandomState``).
    """
    rng = np.random.RandomState(seed)
    av = active_vocab or vocab
    p = np.array([0.55, 0.25, 0.13, 0.07][:branch])
    p = p / p.sum()
    if order == 1:
        succ = rng.randint(0, av, size=(av, branch))
        deterministic = rng.rand(av) < det_frac

        def sample(batch, length, rng):
            out = np.empty((batch, length), np.int64)
            out[:, 0] = rng.randint(0, av, size=batch)
            for t in range(1, length):
                prev = out[:, t - 1]
                choice = rng.choice(branch, size=batch, p=p)
                choice = np.where(deterministic[prev], 0, choice)
                out[:, t] = succ[prev, choice]
            return out
    else:
        succ = rng.randint(0, av, size=(av, av, branch))
        deterministic = rng.rand(av, av) < det_frac

        def sample(batch, length, rng):
            out = np.empty((batch, length), np.int64)
            out[:, 0] = rng.randint(0, av, size=batch)
            out[:, 1] = rng.randint(0, av, size=batch)
            for t in range(2, length):
                a, b = out[:, t - 2], out[:, t - 1]
                choice = rng.choice(branch, size=batch, p=p)
                choice = np.where(deterministic[a, b], 0, choice)
                out[:, t] = succ[a, b, choice]
            return out

    return sample


def model_config(dtype=None):
    """The JAX package's learned benchmark model: ~20M parameters at
    vocab 2048, hidden 512, intermediate 1280, 6 layers, 8 query / 4 KV
    heads (head_dim 64), 2048 positions; bfloat16 unless ``dtype``."""
    from ..models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=2048, hidden_size=512, intermediate_size=1280,
        num_hidden_layers=6, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=2048, dtype=dtype or torch.bfloat16)


def train(steps=1500, batch=64, seq_len=129, lr=2e-3, order=1,
          active_vocab=128, device="cuda", budget_s=0.0, log_every=100,
          log=print):
    """Train ``model_config`` in float32 on ``device`` with Adam from
    ``init_params(seed=0, scale=0.02)`` on the corpus of
    ``make_markov_sampler(order, active_vocab)``, batches drawn by
    ``RandomState(1)``. Stops after ``steps`` or, with ``budget_s`` > 0,
    at the first step past that many seconds.
    Returns (float32 config, params, {step: loss} of the logged steps,
    steps done, seconds)."""
    from ..models.llama import init_params
    from ..training.train_step import init_opt_state, make_train_step

    mcfg = model_config(dtype=torch.float32)     # train fp32, serve bf16
    params = init_params(mcfg, seed=0, scale=0.02, device=device)
    step = make_train_step(mcfg, seq_len=seq_len + 1, learning_rate=lr)
    opt = init_opt_state(params)
    sampler = make_markov_sampler(
        mcfg.vocab_size, order=order,
        active_vocab=active_vocab if order == 2 else 0)
    rng = np.random.RandomState(1)
    pin = torch.device(device).type == "cuda"
    losses = {}
    t0 = time.perf_counter()
    i = 0
    while i < steps:
        b = torch.from_numpy(sampler(batch, seq_len, rng))
        if pin:      # a pageable copy would wait for the card every step
            b = b.pin_memory()
        params, opt, loss = step(params, opt, b.to(device, non_blocking=pin))
        i += 1
        last = i == steps or (budget_s and time.perf_counter() - t0 > budget_s)
        if (i - 1) % log_every == 0 or last:
            losses[i - 1] = float(loss)
            log(f"step {i - 1}: loss {losses[i - 1]:.3f} "
                f"({time.perf_counter() - t0:.0f}s)")
        if last:
            break
    if pin:
        torch.cuda.synchronize()
    return mcfg, params, losses, i, time.perf_counter() - t0


def serving_params(params):
    """The checkpoint's tree: float32 matrices cast to bfloat16, vectors
    (the norms) kept in float32, as the JAX package saves them."""
    if isinstance(params, dict):
        return {k: serving_params(v) for k, v in params.items()}
    if params.dtype == torch.float32 and params.dim() > 1:
        return params.to(torch.bfloat16)
    return params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=129)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default=os.path.expanduser(
        "~/.cache/lade_synth_ckpt"))
    ap.add_argument("--order", type=int, default=1, choices=(1, 2))
    ap.add_argument("--active-vocab", type=int, default=128,
                    help="token range actually used by the order-2 corpus")
    ap.add_argument("--device", default="cuda",
                    help="where to train (the card unless 'cpu')")
    args = ap.parse_args(argv)

    from ..utils.checkpoint import save_params

    mcfg, params, _, _, _ = train(
        args.steps, args.batch, args.seq_len, args.lr, args.order,
        args.active_vocab, args.device)
    save_params(args.out, dataclasses.replace(mcfg, dtype=torch.bfloat16),
                serving_params(params))
    print(f"saved checkpoint to {args.out}.npz")


if __name__ == "__main__":
    main()
