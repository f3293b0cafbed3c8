"""Synthetic weights whose greedy decoding follows a token cycle.

Unit-vector embeddings and an LM head whose columns map each of 64 cycle
tokens to the next, under layer weights small enough (scale 0.002) that
the residual stream stays dominated by the token embedding: greedy
decoding then follows the cycle through every layer, so lookahead's
guesses are accepted at the GS cap. This is the recipe of the JAX
package's ``bench.py`` (``_transition_embed_head``,
``build_predictable_model``), with the layer weights drawn by the port's
``init_params`` from a numpy seed. ``chip_smoke.py`` builds its headline
model here; ``minimal.py --synthetic`` runs it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.llama import LlamaConfig, init_params

# the headline configuration: TinyLlama-1.1B's widths and depth
HEADLINE_ARCH = dict(vocab_size=32000, hidden_size=2048,
                     intermediate_size=5632, num_hidden_layers=22,
                     num_attention_heads=32, num_key_value_heads=4,
                     max_position_embeddings=2048)


def transition_embed_head(seed, h, vocab):
    """Unit-vector embeddings [vocab, h], an LM head [h, vocab] whose
    columns realize a deterministic token-transition cycle, and the
    successor map ``nxt`` [vocab] (numpy ``RandomState(seed)``)."""
    rng = np.random.RandomState(seed)
    embed = rng.randn(vocab, h).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    cycle = rng.choice(vocab, size=64, replace=False)
    nxt = np.full(vocab, cycle[0], np.int64)
    nxt[cycle] = np.roll(cycle, -1)
    head = np.zeros((h, vocab), np.float32)
    head[:, nxt[cycle]] = embed[cycle].T          # logits peak at nxt(token)
    return embed, head, nxt


def make_prompt(nxt, start=0, n=64):
    """``n`` tokens of the cycle, from the successor of ``start``."""
    t = int(nxt[start])
    prompt = [t]
    for _ in range(n - 1):
        t = int(nxt[t])
        prompt.append(t)
    return prompt


def build_headline(device="cuda", arch=None, dtype=torch.bfloat16):
    """(model config, params, 64-token prompt, successor map) of the
    transition-cycle model at ``arch`` (the headline's widths by default)
    in ``dtype``: layer weights from ``init_params(seed=0, scale=0.002)``,
    the embedding scaled by sqrt(hidden) and the cycle's head."""
    mcfg = LlamaConfig(**(arch or HEADLINE_ARCH), dtype=dtype)
    params = init_params(mcfg, seed=0, scale=0.002, device=device)
    embed, head, nxt = transition_embed_head(0, mcfg.hidden_size,
                                             mcfg.vocab_size)
    params["embed"] = torch.from_numpy(embed * np.sqrt(mcfg.hidden_size)).to(
        device, mcfg.dtype)
    params["lm_head"] = torch.from_numpy(head).to(device, mcfg.dtype)
    return mcfg, params, make_prompt(nxt), nxt
