"""Profiling helpers.

``trace`` is the counterpart of the JAX package's ``jax.profiler`` trace: it
records the enclosed block with ``torch.profiler`` (host activity, and the
card's kernels where there is a card) and writes a Chrome trace, which
TensorBoard's profiler plugin and ``chrome://tracing`` read, under
``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace of the enclosed block:

        with profiling.trace("/tmp/lade_trace"):
            eng.generate(ids, 256)

    writes ``log_dir/<pid>.<time in ms>.pt.trace.json``. The card's kernels
    are recorded as they finish: the block's last call should be one that
    reads its result back (``generate`` does)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"))


class StepTimer:
    """Lightweight wall-clock step accounting for streaming loops. The card
    runs ahead of the host: time a step that ends in a host read."""

    def __init__(self):
        self.times = []
        self._t = None

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t)

    @property
    def mean_ms(self) -> float:
        return 1000 * sum(self.times) / max(len(self.times), 1)
