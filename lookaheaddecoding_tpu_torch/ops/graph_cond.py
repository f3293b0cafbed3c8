"""CUDA-graph conditional nodes: the device side of ``core.graphs.cond``, the
counterpart of ``lax.cond`` in the JAX step
(``lookaheaddecoding_tpu/core/pool.py:144-148``), and of
``core.graphs.LoopGraph``, the counterpart of the JAX decode loop's
``lax.while_loop`` on ``~finished``
(``lookaheaddecoding_tpu/core/step.py:520-529``, ``:568-575``).

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

``while_node(finished, cap, iters, body, body_stream(device), pool)``
records ``body`` as a WHILE node the same way: a one-thread kernel upstream
of the node zeroes the int32 counter ``iters`` and sets the first
condition, and one at the body's end adds one to it and sets the next, both
``any(~finished) && iters < cap``. A loop whose lanes have all finished
runs no iteration; one that stops at ``cap`` with a lane unfinished is the
caller's to refuse (``core/engine.py`` raises). The body may allocate when
``pool`` (a ``torch.cuda.MemPool``) is given: its allocations go there
(``torch.cuda.use_mem_pool``), which keeps them, at the addresses the body
captured, as long as the pool lives. A WHILE node may sit in another's
body (``body_stream`` one depth deeper); given the same pool, it
allocates there under its parent's routing. On a CPU tensor the wrapper runs the
plain version, ``while_node_ref``: ``while pred(): body()``.

A body is checked when its capture ends: a node that a conditional body
cannot hold (a host node, an event, a memory allocation, a copy to or from
the host) raises, naming its type.

``counts["set_if"]`` counts the IF condition kernel's launches,
``counts["set_while"]`` the WHILE condition kernel's (one before the loop
and one an iteration; a replay of a captured step counts them again,
``core/graphs.py``); ``counts["plain"]`` the plain versions' calls.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable

import torch

counts = {"set_if": 0, "set_while": 0, "plain": 0}

_streams: dict = {}    # (CUDA device index, depth) -> the bodies' stream

# the MemPools this thread's open WHILE bodies route their allocations to
_routed = threading.local()

_FORBIDDEN = 100000    # csrc/graph_cond.cu's kForbiddenNode
# cudaGraphNodeType values, for the message naming a forbidden body node
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "child graph", 5: "empty", 6: "event wait",
               7: "event record", 8: "external semaphore signal",
               9: "external semaphore wait", 10: "memory allocation",
               11: "memory free", 12: "batch memory operation",
               13: "conditional"}


def if_node_ref(pred: torch.Tensor, body: Callable[[], object]) -> None:
    """The plain version: read ``pred`` on the host, run ``body`` if it
    holds."""
    if bool(pred):
        body()


def while_node_ref(pred: Callable[[], bool],
                   body: Callable[[], object]) -> None:
    """The plain version of a WHILE node: ``while pred(): body()`` on the
    host."""
    while pred():
        body()


def _launch(op: int, stream, pred, n: int, iters, cap, body_stream, handle,
            info) -> int:
    from ._build import load
    return load("graph_cond").graph_cond_launch(op, stream, pred, n, iters,
                                                cap, body_stream, handle,
                                                info)


def body_stream(device, depth: int = 0):
    """The stream conditional bodies capture on at nesting ``depth`` (an IF
    node inside a WHILE body captures at depth 1), for ``device``: one the
    library made itself (a pooled ``torch.cuda.Stream`` may be the very
    stream a capture runs on), made at first use, which must precede any
    capture; None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    got = _streams.get((index, depth))
    if got is None:
        handle = ctypes.c_void_p()
        with torch.cuda.device(index):
            err = _launch(2, ctypes.addressof(handle), None, 0, None, None,
                          None, None, None)
        if err != 0:
            raise RuntimeError(f"CUDA-graph conditional body's stream: CUDA "
                               f"error {err}")
        got = _streams[(index, depth)] = torch.cuda.ExternalStream(
            handle.value, device=torch.device("cuda", index))
    return got


@contextlib.contextmanager
def _allocating_in(pool, device):
    """This thread's allocations routed to ``pool`` (a
    ``torch.cuda.MemPool``), unless an enclosing WHILE body already routes
    them there: a nested body allocates in its parent's pool, which
    PyTorch refuses to route twice."""
    pools = _routed.__dict__.setdefault("pools", [])
    if any(p is pool for p in pools):
        yield
        return
    pools.append(pool)
    try:
        with torch.cuda.use_mem_pool(pool, device):
            yield
    finally:
        pools.pop()


def _device_type(t: torch.Tensor) -> str:
    """The device type a wrapper dispatches on: "cpu" runs the plain
    version, "cuda" records the node."""
    return t.device.type


def _allocations(device) -> int:
    return torch.cuda.memory_stats(device).get("allocation.all.allocated", 0)


def _end_body(op: int, what: str, body_stream, loop=(None, 0, None, None),
              handle=None) -> None:
    """End the capture of a conditional body (op 1, or 4 with the WHILE
    node's end kernel over ``loop``, its flags, their count, counter and
    cap, and ``handle``) and raise on a CUDA error or a forbidden node."""
    info = ctypes.c_int(-1)
    err = _launch(op, None, *loop, body_stream.cuda_stream, handle,
                  ctypes.addressof(info))
    if err == _FORBIDDEN:
        raise RuntimeError(
            f"a CUDA-graph {what} body holds a "
            f"{_NODE_TYPES.get(info.value, f'type {info.value}')} node, "
            f"which a conditional body cannot hold (only kernel, empty, "
            f"child-graph, memset, device-to-device memcpy and conditional "
            f"nodes)")
    if err != 0:
        raise RuntimeError(f"CUDA-graph {what} node's body capture failed: "
                           f"CUDA error {err}")


def _begin_failed(what: str, err: int) -> RuntimeError:
    return RuntimeError(
        f"CUDA-graph {what} node failed: CUDA error {err} (conditional nodes "
        f"need CUDA 12.4 or later and a capture in progress); PyTorch "
        f"{torch.__version__} with CUDA {torch.version.cuda}")


def if_node(pred: torch.Tensor, body: Callable[[], object],
            body_stream) -> None:
    """Record ``body`` as an IF node of the graph being captured on the
    current stream, on ``pred``, a one-element bool tensor; ``body_stream``
    is :func:`body_stream` of its device (unused on the CPU). Raises on a
    CUDA error (a driver or runtime older than 12.4 has no conditional
    nodes), outside a capture, on a node the body cannot hold, and when
    ``body`` allocates device memory."""
    if pred.numel() != 1 or pred.dtype != torch.bool:
        raise ValueError(f"an IF node's predicate is one bool element, got "
                         f"{pred.dtype} {tuple(pred.shape)}")
    if _device_type(pred) == "cpu":
        counts["plain"] += 1
        return if_node_ref(pred, body)
    if _device_type(pred) != "cuda":
        raise ValueError(f"no IF node for device {pred.device}")
    stream = torch.cuda.current_stream(pred.device)
    err = _launch(0, stream.cuda_stream, pred.contiguous().data_ptr(), 0,
                  None, None, body_stream.cuda_stream, None, None)
    if err != 0:
        raise _begin_failed("IF", err)
    counts["set_if"] += 1
    made = _allocations(pred.device)
    try:
        with torch.cuda.stream(body_stream):
            body()
    finally:
        _end_body(1, "IF", body_stream)
    if _allocations(pred.device) != made:
        raise RuntimeError(
            "an IF node's body allocated device memory, which the graph's "
            "memory pool does not hold: make its tensors before the node")


def while_node(finished: torch.Tensor, cap: torch.Tensor,
               iters: torch.Tensor, body: Callable[[], object], body_stream,
               pool=None) -> None:
    """Record ``body`` as a WHILE node of the graph being captured on the
    current stream: it runs while any of the bool flags ``finished`` is
    clear and fewer than ``cap`` (an int32 tensor; its first element)
    iterations have run, counting them in ``iters`` (a one-element int32
    tensor, zeroed before the first). ``body_stream`` is :func:`body_stream`
    of the device; ``pool`` a ``torch.cuda.MemPool`` that takes the body's
    allocations (without one the body may not allocate). Raises as
    :func:`if_node` does. On the CPU it runs :func:`while_node_ref`."""
    if finished.dtype != torch.bool or not finished.is_contiguous():
        raise ValueError(f"a WHILE node's flags are contiguous bools, got "
                         f"{finished.dtype}")
    if (iters.numel() != 1 or iters.dtype != torch.int32 or cap.numel() < 1
            or cap.dtype != torch.int32):
        raise ValueError("a WHILE node's counter and cap are int32 tensors")
    if _device_type(finished) == "cpu":
        counts["plain"] += 1
        iters.zero_()

        def pred():
            return bool((~finished).any()) and int(iters) < int(cap.view(-1)[0])

        def step():
            body()
            iters.add_(1)
        return while_node_ref(pred, step)
    if _device_type(finished) != "cuda":
        raise ValueError(f"no WHILE node for device {finished.device}")
    stream = torch.cuda.current_stream(finished.device)
    handle = ctypes.c_ulonglong()
    loop = (finished.data_ptr(), finished.numel(), iters.data_ptr(),
            cap.data_ptr())
    err = _launch(3, stream.cuda_stream, *loop, body_stream.cuda_stream,
                  ctypes.addressof(handle), None)
    if err != 0:
        raise _begin_failed("WHILE", err)
    counts["set_while"] += 2            # before the loop, at the body's end
    made = _allocations(finished.device)
    try:
        with torch.cuda.stream(body_stream):
            if pool is None:
                body()
            else:
                with _allocating_in(pool, finished.device):
                    body()
    finally:
        _end_body(4, "WHILE", body_stream, loop, ctypes.addressof(handle))
    if pool is None and _allocations(finished.device) != made:
        raise RuntimeError(
            "a WHILE node's body allocated device memory without a pool to "
            "keep it: pass a torch.cuda.MemPool")
