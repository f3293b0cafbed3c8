"""Logit warpers and SpecInfer-style multi-candidate rejection sampling.

The counterpart of ``lookaheaddecoding_tpu.ops.sampling``: the temperature,
top-k and top-p warper chain, and the verification that accepts a draft
token with probability min(1, p(draft)) and otherwise samples the residual,
which keeps the model's warped sampling distribution whatever the drafts
propose. Plain PyTorch on a leading lane axis ``[B, ...]`` in float32; the
JAX package has no kernel here either.

Every random number comes from explicit noise: ``rejection_sample_verify``
draws it from each lane's Philox stream (``ops/philox.py``: the lane's key
and draw counter) and hands it to ``rejection_sample_verify_core``, which
the tests also feed the JAX package's own noise. A residual draw is
Gumbel-max, ``argmax(log p + g)``, as ``jax.random.categorical`` computes
it; nothing here reads a tensor back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import philox

NEG_INF = float("-inf")
_TINY = torch.finfo(torch.float32).tiny


def _per_lane(x, like: torch.Tensor):
    """A float, or a [B] tensor shaped to broadcast over ``like`` [B, ..., V]."""
    if not isinstance(x, torch.Tensor):
        return x
    x = x.to(torch.float32)
    return x.view(x.shape + (1,) * (like.dim() - x.dim()))


def warp_logits(logits: torch.Tensor, temperature, top_k: int = 0,
                top_p=None) -> torch.Tensor:
    """Temperature, then top-k, then top-p (the order transformers applies
    them) on logits [B, ..., V]. ``temperature`` and ``top_p`` are floats
    or [B] tensors, one value a lane; a lane whose ``top_p`` is at least 1
    keeps its whole support. ``top_p=None`` skips the vocabulary sort, for
    a caller that knows on the host that no lane asks for top-p.

    The nucleus keeps the smallest prefix of descending-probability tokens
    whose cumulative probability reaches ``top_p`` (the crossing token is
    kept: HF ``TopPLogitsWarper`` with min_tokens_to_keep=1). The sort is
    stable, as ``jnp.argsort`` is, so tied logits keep their index order."""
    logits = logits / _per_lane(temperature, logits)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p is None:
        return logits
    top_p = _per_lane(top_p, logits)
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True,
                                      stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = (cum_before < top_p) | (top_p >= 1.0)
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return logits.masked_fill(~keep, NEG_INF)


def lane_uniforms(key: torch.Tensor, draws: torch.Tensor, n: int,
                  tag: int = philox.STEP) -> torch.Tensor:
    """[B, n] uniforms in [0, 1), row b lane b's draw number ``draws[b]``
    under ``key[b]`` (int32 [B, 2], int64 [B]; ``ops/philox.py``): every
    lane draws the same numbers alone as in a batch, and a captured draw
    reads the counter on the device."""
    return philox.uniforms(key, draws, n, tag)


def gumbel(uniforms: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms, as ``jax.random.gumbel`` makes
    it (the uniform is kept at or above the smallest normal float)."""
    return -torch.log(-torch.log(uniforms.clamp_min(_TINY)))


def gumbel_max(probs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One draw from each row of ``probs`` [..., V] with Gumbel noise of the
    same shape: ``jax.random.categorical`` on ``log(max(p, 1e-38))``."""
    return (torch.log(probs.clamp_min(1e-38)) + noise).argmax(dim=-1)


class AcceptResult(NamedTuple):
    hits: torch.Tensor     # [B, GS] int32 accepted tokens (+ the residual)
    max_hit: torch.Tensor  # [B] int32: the count of hits less one
    winner: torch.Tensor   # [B] int64: candidate whose KV block to commit


def rejection_sample_verify_core(
    probs_next: torch.Tensor,    # [B, V] warped softmax of the next-token row
    guess_probs: torch.Tensor,   # [B, G, GS, V] warped softmax a guess row
    guess_tokens: torch.Tensor,  # [B, G, GS] candidate n-grams
    guess_valid: torch.Tensor,   # [B, G] bool
    uniforms: torch.Tensor,      # [B, GS, G] in [0, 1)
    noise: torch.Tensor,         # [B, GS, V] Gumbel noise of the residuals
) -> AcceptResult:
    """SpecInfer verification with explicit noise: the JAX package's
    ``rejection_sample_verify`` with its uniforms and residual noise given.

    The JAX function walks the candidates of a position one after another:
    an active candidate (valid, agreeing with the tokens accepted so far)
    is accepted with probability min(1, p[draft]); a rejected draft is
    zeroed and p renormalized. Here the walk over the G candidates is one
    vectorised pass. Before candidate g is tried every earlier active
    candidate was rejected, so g sees p with the distinct drafts of the
    earlier active candidates zeroed and renormalized: its acceptance
    probability is p[d_g] / (sum of p outside those drafts), and 0 when
    d_g repeats one of them. The accepted candidate is the first active g
    whose uniform lies below it, and the residual is p with every active
    draft zeroed, renormalized. With the same noise the decisions are
    JAX's, except where a uniform lies within rounding of its threshold.
    Only the GS positions are a loop."""
    b, g, gs = guess_tokens.shape
    dev = probs_next.device
    lane = torch.arange(b, device=dev)
    if g == 0:
        hits = torch.zeros((b, gs), dtype=torch.int32, device=dev)
        hits[:, 0] = gumbel_max(probs_next, noise[:, 0]).int()
        zero = torch.zeros(b, dtype=torch.int32, device=dev)
        return AcceptResult(hits, zero, zero.long())
    tokens = guess_tokens.long()
    cand = torch.ones((b, g), dtype=torch.bool, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    count = torch.zeros(b, dtype=torch.int32, device=dev)
    winner = torch.zeros(b, dtype=torch.long, device=dev)
    probs = probs_next
    hits = []
    for i in range(gs):
        draft = tokens[:, :, i]                                   # [B, G]
        active = cand & guess_valid
        # drafts zeroed before candidate g is tried: the active ones of
        # the candidates before it
        onehot = torch.zeros(probs.shape[:1] + (g,) + probs.shape[1:],
                             dtype=probs.dtype, device=dev).scatter_(
            2, draft[..., None], active[..., None].to(probs.dtype))
        before = onehot.cumsum(dim=1) - onehot > 0                # [B, G, V]
        rest = (probs[:, None, :] * ~before).sum(dim=-1)          # [B, G]
        p_draft = torch.where(before.gather(2, draft[..., None])[..., 0],
                              0.0, probs.gather(1, draft))
        p_acc = torch.where(before.any(dim=-1),
                            p_draft / rest.clamp_min(1e-38), p_draft)
        take = active & (uniforms[:, i] < p_acc.clamp_max(1.0))
        acc_g = take.int().argmax(dim=1)        # first accepted, else 0
        accepted = take.any(dim=1) & alive
        # the residual: every active draft zeroed, renormalized
        zeroed = onehot.sum(dim=1) > 0
        resid = probs * ~zeroed
        resid = torch.where(active.any(dim=1, keepdim=True),
                            resid / resid.sum(dim=1, keepdim=True)
                            .clamp_min(1e-38), probs)
        draft_tok = draft.gather(1, acc_g[:, None])[:, 0]
        tok = torch.where(accepted, draft_tok, gumbel_max(resid, noise[:, i]))
        hits.append(torch.where(alive, tok, 0))
        # on accept: keep the candidates that agree at position i and go on
        # from the accepted row's distribution
        cand = cand & (draft == draft_tok[:, None])
        probs = torch.where(accepted[:, None], guess_probs[lane, acc_g, i],
                            resid)
        winner = torch.where(accepted, acc_g, winner)
        count = count + alive.int()
        alive = accepted
    return AcceptResult(torch.stack(hits, dim=1).int(), count - 1, winner)


def verify_noise_size(g: int, gs: int, vocab: int) -> int:
    """Uniforms a lane draws for one verification: G a position and a
    Gumbel vector a position (one Gumbel vector when G = 0)."""
    return gs * (g + vocab) if g else vocab


def split_verify_noise(u: torch.Tensor, g: int, gs: int, vocab: int):
    """(uniforms [B, GS, G], Gumbel noise [B, GS, V]) from [B, n] uniforms
    of :func:`verify_noise_size`."""
    b = u.shape[0]
    if not g:
        return u.new_zeros((b, gs, 0)), gumbel(u).view(b, 1, vocab)
    return (u[:, :gs * g].view(b, gs, g),
            gumbel(u[:, gs * g:]).view(b, gs, vocab))


def rejection_sample_verify(probs_next, guess_probs, guess_tokens,
                            guess_valid, key: torch.Tensor,
                            draws: torch.Tensor) -> AcceptResult:
    """:func:`rejection_sample_verify_core` with its noise drawn from each
    lane's stream (lane b's draw ``draws[b]`` under ``key[b]``)."""
    b, g, gs = guess_tokens.shape
    vocab = probs_next.shape[-1]
    u = lane_uniforms(key, draws, verify_noise_size(g, gs, vocab))
    return rejection_sample_verify_core(
        probs_next, guess_probs, guess_tokens, guess_valid,
        *split_verify_noise(u, g, gs, vocab))


def sample_token(logits: torch.Tensor, temperature, top_k: int,
                 top_p: Optional[object], key: torch.Tensor,
                 draws: torch.Tensor) -> torch.Tensor:
    """One warped sample a lane from logits [B, V] (Gumbel-max on the
    warped logits), with lane b's noise its draw ``draws[b]`` under
    ``key[b]``. Returns [B] int32."""
    warped = warp_logits(logits.float(), temperature, top_k, top_p)
    u = lane_uniforms(key, draws, logits.shape[-1])
    return (warped + gumbel(u)).argmax(dim=-1).int()
