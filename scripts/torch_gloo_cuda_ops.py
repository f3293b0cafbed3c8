#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives the gloo backend takes on CUDA
tensors, in the installed PyTorch.

    python3 scripts/torch_gloo_cuda_ops.py

For each collective it starts a world of two ranks on the card(s) of this
machine (both on one card where there is one) over gloo, calls the
collective once on CUDA tensors directly (not through
``parallel/collectives.py``) and checks the values: one world an op, since
an op that gloo does not take on CUDA tensors may raise or may abort the
rank's process. It prints one JSON line: each op, "ok", the error's first
line, or how the world failed.
``parallel/collectives.py`` stages through host memory every op that
this does not list as "ok" (its ``GLOO_CUDA_OPS``).
"""

from __future__ import annotations

import json
import os
import sys


def probe(device, op):
    import torch
    import torch.distributed as dist

    rank, dev = dist.get_rank(), torch.device(device)

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        assert x.tolist() == [3.0] * 4, x

    def broadcast():
        x = torch.full((4,), float(rank), device=dev)
        dist.broadcast(x, 1)
        assert x.tolist() == [1.0] * 4, x

    def all_gather():
        parts = [torch.empty(2, device=dev) for _ in range(2)]
        dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
        assert [p.tolist() for p in parts] == [[0.0] * 2, [1.0] * 2]

    def all_gather_bytes():
        # a bfloat16 tensor as its bytes, as parallel/collectives.py sends it
        x = torch.full((2,), float(rank) + 0.5, device=dev,
                       dtype=torch.bfloat16)
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather([p.view(torch.uint8) for p in parts],
                        x.view(torch.uint8))
        assert [p.float().tolist() for p in parts] == [[0.5] * 2, [1.5] * 2]

    def send_recv():
        x = torch.full((3,), 7.0, device=dev)
        if rank == 0:
            dist.send(x, 1)
        else:
            y = torch.empty(3, device=dev)
            dist.recv(y, 0)
            assert y.tolist() == [7.0] * 3, y

    fn = {"all_reduce": all_reduce, "broadcast": broadcast,
          "all_gather": all_gather, "all_gather_bytes": all_gather_bytes,
          "send_recv": send_recv}[op]
    try:
        fn()
        torch.cuda.synchronize(dev)
        return "ok"
    except Exception as e:          # the report is the point: record it
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from lookaheaddecoding_tpu_torch.parallel.launch import WorldError, launch
    report = {}
    for op in ("all_reduce", "broadcast", "all_gather", "all_gather_bytes",
               "send_recv"):
        try:
            ranks = launch(f"{os.path.abspath(__file__)}:probe", 2, "gloo",
                           "cuda", dict(op=op), timeout=60)
            report[op] = ranks[0] if ranks[0] == ranks[1] else ranks
        except WorldError as e:
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            report[op] = f"world failed: {lines[0]} ... {lines[-1][:200]}"
    print(json.dumps({"torch": torch.__version__, "gloo_cuda": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
