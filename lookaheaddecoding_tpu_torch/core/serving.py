"""The serving request record.

One dataclass, shared by the serving engines. The paged engine
(core/paged_serving.py) is the one carried so far; the flat
continuous-batching engine is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int
    eos_token_id: Optional[object] = None
    seed: int = 0
    request_id: Optional[object] = None
    # per-request sampling knobs (sampling-mode engines only; None = the
    # engine-level SamplingConfig defaults)
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    # shared-prompt KV reuse: a ``precompute_prefix`` result; the prompt
    # must start with its tokens (system-prompt caching)
    prefix: Optional[object] = None
    # per-request streaming: called with each np.ndarray of newly confirmed
    # token ids as the scheduler observes them, once per host read (every
    # ``steps_per_sync`` decode steps). Exceptions propagate to ``step()``.
    on_tokens: Optional[object] = None
    # paged serving only: attach ``result.prefix``, a PagedPrefix over this
    # request's confirmed tokens (conversation KV carry at the cost of a
    # few page references, not of a copy of the cache)
    return_prefix: bool = False
    # latency class: an interactive request jumps the admission queue
    interactive: bool = False
