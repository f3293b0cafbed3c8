"""Every collective of the parallel forward and train step.

JAX needs none of these: XLA's partitioner inserts them. Each call takes
the process group of one mesh axis (``Mesh.group``); a group of None is an
axis of size 1, where the call returns its input and moves nothing.

The transport follows the group's backend, here alone, and never a
failure: NCCL takes CUDA tensors as they are; gloo takes CPU tensors, and
of CUDA tensors only in the collectives it implements for them
(``GLOO_CUDA_OPS``), so this module stages the others through host
memory. With PyTorch 2.11 (CUDA 12.8) on an H100,
``scripts/torch_gloo_cuda_ops.py`` found gloo taking CUDA tensors in
all-reduce, broadcast and all-gather (float32, and bfloat16 as bytes),
while a send of a CUDA tensor aborts the process (gloo's ``writev``:
"Bad address"); so send and receive are staged. bfloat16 tensors
travel as their bytes in every collective that moves values without
summing them, so a gather is bit-exact whatever the backend supports; a
sum is taken in the caller's dtype (the model sums its partial products in
float32).

Under CUDA-graph capture (``core/graphs.py``: an engine or train step on
a mesh whose groups are all NCCL) every call here is recorded into the
graph as it is: nothing touches the host, and a call that would stage
through host memory (a gloo group) raises instead. ``counts`` tallies the
calls that moved data, by kind; a capture records a step's calls, takes
them back and adds them again on each replay, as it does the kernels'
launch counts.

Megatron's f/g pair for training. The loss is computed whole on every tp
rank (replicated), so the gradient that reaches a replicated activation is
the same on every rank: ``copy_to_region`` (identity forward, all-reduce
backward) sums the partial gradients of the column-parallel products'
input, ``reduce_from_region`` (all-reduce forward, identity backward)
hands that gradient back unchanged, and ``gather_from_region`` (all-gather
forward, this rank's slice backward) does the same for the vocabulary-
sharded logits. ``torch.distributed.nn.functional`` has all-reduce and
all-gather, but with the backward of a loss that is a sum of one term a
rank (all-reduce, reduce-scatter), which would scale these gradients by
the axis size, so the three are written out here.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})

counts = {"all_reduce": 0, "all_gather": 0, "send": 0, "recv": 0,
          "broadcast": 0}


def staged(group, x: torch.Tensor, op: str) -> bool:
    """Whether ``op`` on ``x`` goes through host memory on ``group``.
    Raises if it would while the current stream is being captured: a
    capture cannot record a copy to the host, and a replay would skip
    it."""
    if not (x.is_cuda and dist.get_backend(group) == "gloo"
            and op not in GLOO_CUDA_OPS):
        return False
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{op} of a CUDA tensor on a gloo group stages through host "
            f"memory, which a CUDA graph cannot capture: capture needs "
            f"NCCL groups")
    return True


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A bfloat16 tensor's bytes (gloo has no int16 and may lack
    bfloat16); any other tensor as it is."""
    return x.view(torch.uint8) if x.dtype == torch.bfloat16 else x


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, a new tensor."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    counts["all_reduce"] += 1
    return out


def all_gather(x: torch.Tensor, group, dim: int = 0,
               sizes: Optional[List[int]] = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order.
    ``sizes`` are the parts' lengths along ``dim`` (``torch.tensor_split``
    sizes; equal parts by default), so the axis need not divide the rows:
    every part travels padded to the longest, into one buffer."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    sizes = sizes or [x.shape[dim]] * n
    part = x.movedim(dim, 0)
    longest = max(sizes)
    if part.shape[0] == longest:
        buf = part.contiguous()
    else:
        buf = part.new_zeros((longest,) + part.shape[1:])
        buf[:part.shape[0]] = part
    if staged(group, buf, "all_gather"):
        buf = buf.cpu()
    out = buf.new_empty((n * longest,) + buf.shape[1:])
    dist.all_gather_into_tensor(_bits(out), _bits(buf), group=group)
    counts["all_gather"] += 1
    if any(s != longest for s in sizes):
        out = torch.cat([out[i * longest:i * longest + s]
                         for i, s in enumerate(sizes)])
    return out.to(x.device).movedim(0, dim)


def send(x: torch.Tensor, dst: int, group) -> None:
    """Send ``x`` to global rank ``dst`` of ``group``."""
    if staged(group, x, "send"):
        x = x.cpu()
    dist.send(_bits(x.contiguous()), dst, group=group)
    counts["send"] += 1


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor shaped like ``like`` received from global rank ``src``."""
    buf = torch.empty_like(like)
    host = buf.cpu() if staged(group, buf, "recv") else buf
    dist.recv(_bits(host), src, group=group)
    counts["recv"] += 1
    return host.to(like.device)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank of ``group`` (``x`` gives
    the shape elsewhere)."""
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.broadcast(_bits(out), src, group=group)
    counts["broadcast"] += 1
    return out


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.dim, ctx.width = dim, x.shape[dim]
        rank = dist.get_rank(group)
        ctx.start = sum(sizes[:rank]) if sizes else rank * x.shape[dim]
        return all_gather(x.contiguous(), group, dim, sizes)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.width), None, None, None


def copy_to_region(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, all-reduce of the gradient."""
    return x if group is None else _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: all-reduce forward, identity backward."""
    return x if group is None else _ReduceFromRegion.apply(x, group)


def gather_from_region(x: torch.Tensor, group, dim: int = -1,
                       sizes: Optional[List[int]] = None) -> torch.Tensor:
    """All-gather forward along ``dim``, this rank's slice of the gradient
    backward."""
    if group is None:
        return x
    return _GatherFromRegion.apply(x, group, dim % x.dim(), sizes)
