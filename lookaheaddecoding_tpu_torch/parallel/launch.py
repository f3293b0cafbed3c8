"""Start a world of ranks and collect each rank's result.

    python -m lookaheaddecoding_tpu_torch.parallel.launch --nproc 4 \\
        --backend gloo --device cpu package.module:function '{"n": 3}'

spawns ``--nproc`` processes on this host that rendezvous at
``tcp://localhost:{a free port}``, sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (every rank is on this host),
starts the default process group on ``--backend`` and calls
``function(device=..., **args)`` (``module:function`` or
``path/to/file.py:function``) on every rank, ``device`` being the
rank's device (``cuda:{rank % cards}``, or ``cpu``). It prints each
rank's JSON result, one line a rank, or the first failing rank's
traceback, and exits non-zero if any rank failed. :func:`launch` is the
same as a function that returns the results, for tests and scripts that
need them in the parent.

Every rank has a time limit: the process group's collectives time out
after it, a rank still running five seconds before it prints every
thread's stack, and the parent kills the whole world once any rank fails
or the limit has passed, reporting the logs of the ranks at fault. A
rank that is done frees its CUDA graphs before it tears its process group
down (a graph that captured NCCL collectives holds the communicator); a
teardown that still outlives ``TEARDOWN_S`` fails the rank, and with it
the world. A rank whose function raises prints its traceback and exits at
once, without tearing down its process group (which could wait on a
collective it left open), so the world ends with that rank's error even
when the others wait in a collective, a captured one included.
``torchrun`` starts the same ranks (the functions read their rank from
the process group), but returns nothing to its caller.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import faulthandler
import gc
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
_MODULE = "lookaheaddecoding_tpu_torch.parallel.launch"
TEARDOWN_S = 30.0   # seconds a rank's teardown may take once it is done


class WorldError(RuntimeError):
    """A rank failed or the world outlived its time limit."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(target: str, nproc: int, backend: str = "gloo",
           device: str = "cuda", args: Optional[Dict] = None,
           timeout: float = 600.0, threads: Optional[int] = None) -> List:
    """Run ``target`` ("module:function") on ``nproc`` ranks and return
    each rank's JSON result, in rank order. Raises :class:`WorldError`
    with the first failing rank's traceback (or on the time limit), after
    killing every rank. ``threads`` sets ``torch.set_num_threads`` on each
    rank."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    with tempfile.TemporaryDirectory(prefix="lade_world_") as tmp, \
            contextlib.ExitStack() as files:
        outs = [Path(tmp) / f"rank{rank}.json" for rank in range(nproc)]
        specs = [json.dumps(dict(
            target=target, rank=rank, world=nproc, port=port,
            backend=backend, device=device, args=args or {},
            timeout=timeout, out=str(outs[rank]), threads=threads))
            for rank in range(nproc)]
        logs = [files.enter_context(open(Path(tmp) / f"rank{rank}.log",
                                         "w+")) for rank in range(nproc)]
        procs = []
        try:
            for spec, log in zip(specs, logs):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", _MODULE, "--rank-spec", spec],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
            _wait(procs, logs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        return [json.loads(o.read_text())["result"] for o in outs]


def _wait(procs, logs, timeout: float) -> None:
    """Until every rank has exited; raises on the first failure or at the
    time limit (the caller kills the rest)."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        failed = [(rank, code) for rank, code in enumerate(codes)
                  if code not in (None, 0)]
        if failed:
            # every rank that has failed by now: the one at fault may not
            # be the lowest (its peers then fail in the collective)
            parts = []
            for rank, code in failed:
                logs[rank].seek(0)
                parts.append(f"rank {rank} exited with {code}:\n"
                             f"{logs[rank].read()[-6000:]}")
            raise WorldError("\n".join(parts))
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            running = [r for r, c in enumerate(codes) if c is None]
            parts = [f"the world did not finish within {timeout} s (ranks "
                     f"still running: {running})"]
            for rank in running:        # each with its stacks (_run_rank)
                logs[rank].seek(0)
                parts.append(f"rank {rank}:\n{logs[rank].read()[-6000:]}")
            raise WorldError("\n".join(parts))
        time.sleep(0.05)


def _function(target: str):
    """``module:function``, or ``path/to/file.py:function``."""
    module, fn = target.rsplit(":", 1)
    if module.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(module).stem,
                                                      module)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(module)
    return getattr(mod, fn)


def _run_rank(spec: Dict) -> None:
    """One rank: the environment, the process group, the function."""
    import torch
    import torch.distributed as dist

    rank, world = spec["rank"], spec["world"]
    # a rank still running near the time limit prints every thread's
    # stack into its log, which the parent reports
    faulthandler.dump_traceback_later(max(spec["timeout"] - 5, 1))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    if spec["device"] == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, and no CUDA device is here")
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(torch.device(device))
    else:
        device = "cpu"
    dist.init_process_group(
        spec["backend"], init_method=f"tcp://localhost:{spec['port']}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        result = _function(spec["target"])(device=device, **spec["args"])
        Path(spec["out"]).write_text(json.dumps({"result": result}))
    except Exception:
        # End here, with this rank's error: tearing the process group down
        # could wait on a collective this rank left open (a capture that
        # raised, a peer that never answers). The parent sees the exit and
        # ends the other ranks, which may be waiting in a collective.
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    # The teardown. A CUDA graph that captured NCCL collectives holds its
    # communicator, and the engines keep their graphs in reference cycles:
    # free them first, or the teardown waits on them. A teardown that
    # still outlives TEARDOWN_S ends the rank as failed.
    guard = threading.Timer(TEARDOWN_S, _end_torn_down_rank)
    guard.daemon = True
    guard.start()
    gc.collect()
    if device != "cpu":
        torch.cuda.synchronize()
    dist.destroy_process_group()


def _end_torn_down_rank() -> None:
    print(f"the process group's teardown took over {TEARDOWN_S} s; ending "
          f"the rank as failed", flush=True)
    os._exit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank-spec", help=argparse.SUPPRESS)
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a rank may take")
    ap.add_argument("target", nargs="?", help="module:function")
    ap.add_argument("args", nargs="?", default="{}",
                    help="keyword arguments of the function, as JSON")
    a = ap.parse_args(argv)
    if a.rank_spec:
        try:
            _run_rank(json.loads(a.rank_spec))
        except BaseException:
            traceback.print_exc()
            sys.stdout.flush()
            raise
        return 0
    if not a.target:
        ap.error("target (module:function) is required")
    try:
        results = launch(a.target, a.nproc, a.backend, a.device,
                         json.loads(a.args), a.timeout)
    except WorldError as e:
        print(e, file=sys.stderr)
        return 1
    for rank, r in enumerate(results):
        print(json.dumps({"rank": rank, "result": r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
