"""CUDA-graph IF nodes: the device side of ``core.graphs.cond``, the
counterpart of ``lax.cond`` in the JAX step
(``lookaheaddecoding_tpu/core/pool.py:144-148``).

``if_node(pred, body, body_stream(device))`` inside a CUDA-graph capture
records ``body`` as an IF node (``csrc/graph_cond.cu``): a one-thread kernel
reads the one-byte ``pred`` each replay and sets the node's condition with
``cudaGraphSetConditional``, and the device runs or skips the body's
captured work. PyTorch's own ``CUDAGraph.begin_capture_to_if_node`` is not
in every build (PyTorch 2.11 has none), so the node is made here from the
capture's ``cudaGraph_t`` (``cudaStreamGetCaptureInfo``). The body is
captured on ``body_stream``, a capture PyTorch's allocator does not know:
it must allocate no device memory (every tensor it writes is made before
the node), and the wrapper raises if it does. On a CPU tensor the wrapper
runs the plain version, ``if_node_ref``: ``if bool(pred): body()``.

``counts["set_if"]`` counts the condition kernel's launches (a replay of a
captured step counts them again, ``core/graphs.py``); ``counts["plain"]``
the plain version's calls.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

counts = {"set_if": 0, "plain": 0}

_streams: dict = {}    # CUDA device index -> the bodies' stream


def if_node_ref(pred: torch.Tensor, body: Callable[[], object]) -> None:
    """The plain version: read ``pred`` on the host, run ``body`` if it
    holds."""
    if bool(pred):
        body()


def _launch(op: int, stream, pred, body_stream) -> int:
    from ._build import load
    return load("graph_cond").graph_cond_launch(op, stream, pred,
                                                body_stream)


def body_stream(device):
    """The stream IF bodies capture on, for ``device``: one the library
    made itself (a pooled ``torch.cuda.Stream`` may be the very stream a
    capture runs on), made at first use, which must precede any capture;
    None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    got = _streams.get(index)
    if got is None:
        handle = ctypes.c_void_p()
        with torch.cuda.device(index):
            err = _launch(2, ctypes.addressof(handle), None, None)
        if err != 0:
            raise RuntimeError(f"CUDA-graph IF node's stream: CUDA error "
                               f"{err}")
        got = _streams[index] = torch.cuda.ExternalStream(
            handle.value, device=torch.device("cuda", index))
    return got


def _allocations(device) -> int:
    return torch.cuda.memory_stats(device).get("allocation.all.allocated", 0)


def if_node(pred: torch.Tensor, body: Callable[[], object],
            body_stream) -> None:
    """Record ``body`` as an IF node of the graph being captured on the
    current stream, on ``pred``, a one-element bool tensor; ``body_stream``
    is :func:`body_stream` of its device (unused on the CPU). Raises on a
    CUDA error (a driver or runtime older than 12.4 has no conditional
    nodes), outside a capture, and when ``body`` allocates device
    memory."""
    if pred.numel() != 1 or pred.dtype != torch.bool:
        raise ValueError(f"an IF node's predicate is one bool element, got "
                         f"{pred.dtype} {tuple(pred.shape)}")
    if pred.device.type == "cpu":
        counts["plain"] += 1
        return if_node_ref(pred, body)
    if pred.device.type != "cuda":
        raise ValueError(f"no IF node for device {pred.device}")
    stream = torch.cuda.current_stream(pred.device)
    err = _launch(0, stream.cuda_stream, pred.contiguous().data_ptr(),
                  body_stream.cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"CUDA-graph IF node failed: CUDA error {err} (conditional nodes "
            f"need CUDA 12.4 or later and a capture in progress); PyTorch "
            f"{torch.__version__} with CUDA {torch.version.cuda}")
    counts["set_if"] += 1
    made = _allocations(pred.device)
    try:
        with torch.cuda.stream(body_stream):
            body()
    finally:
        err = _launch(1, None, None, body_stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA-graph IF node's body capture failed: CUDA "
                           f"error {err}")
    if _allocations(pred.device) != made:
        raise RuntimeError(
            "an IF node's body allocated device memory, which the graph's "
            "memory pool does not hold: make its tensors before the node")
