"""Captured decode steps: the counterpart of the JAX engine's
``jax.jit(..., donate_argnums=...)``.

JAX compiles a generation into one device program over donated buffers,
dispatched once. The port's decode step is a Python function that launches
some 1,200-2,000 kernels, so run op by op the card waits on the host for
most of a step. On the card every engine therefore captures its step once
into a ``torch.cuda.CUDAGraph`` and replays it: one launch from the host a
step. Capture records device addresses, so the step runs over a state
whose tensors never move: the engines own one static state for each kind
of step (made at first use), write each request into it in place
(``_prepare``, admission), and the step writes every field in place.

:class:`StepGraph` makes one warm step on a side stream, which does every
piece of first-use work (the ``nvcc`` build and ``dlopen`` of a kernel,
``cudaFuncSetAttribute``, the SM-count query, lazily made tables), and
then captures one step. The warm step is a real step of the run that
triggered the capture. A failed capture raises; nothing falls back to the
eager step on the card.

On a ``mesh`` (``parallel.make_mesh``) each rank captures and replays its
own step, collectives included, when every process group of the mesh is
NCCL (:func:`capturable`): the counterpart of JAX's ``jit`` over a mesh,
whose one program holds the collectives XLA inserted. The warm step runs
every collective of the step once, so ProcessGroupNCCL has made each of
its lazily made communicators (the pp stages' send/recv pairs too) before
the capture, which cannot make one; every rank runs the same step, so
every rank captures the same sequence of collectives. The capture is
``thread_local``: ProcessGroupNCCL's watchdog thread may go on querying
the events of earlier collectives while this thread captures. gloo's
collectives cannot be captured (they stage CUDA tensors through the host),
so a mesh with a gloo group steps eagerly, as the CPU does, through
:class:`EagerSteps` and the same step functions; so does everything inside
``with eager():``, the comparison that ``chip_smoke.py`` and the card tests
make.

The kernels' launch counts (``counts`` in ``ops/``) and the collectives'
(``parallel/collectives.py``) tick in Python, which a replay does not run:
a capture records how many launches of each kernel and calls of each
collective the step made, takes them back (capture launches nothing), and
every replay adds them again, so the counts stay the number launched.
``stats`` counts the captures and the replays: those of decode steps
(``replays``) apart from those of prefill chunks (``prefills``).

The prefill is captured too (the counterpart of JAX's fused prepare call,
``jax.jit(self._make_fused(None))``, whose prefill is a ``fori_loop``): one
chunk reads its start from device counters and advances them, so the
prompt's chunks are iterations of one captured chunk. :func:`upload` and
:func:`upload_into` are the host-to-device copies that a request makes
before its graphs run: from pinned memory and without a wait, so nothing
between a request's start and its one read stops the host.

:class:`LoopGraph` is the counterpart of the JAX decode loop's
``lax.while_loop`` on ``~finished``: the whole loop of greedy, sampling
and AR decode steps captured as one graph, a WHILE node around the step
(``ops/graph_cond.py``), launched once a call; the iterations it ran stay
on the device until the caller's final transfer reads them
(:meth:`LoopGraph.account`). The step is captured straight into the
node's body, whose allocations go to a ``torch.cuda.MemPool`` of the
engine (PyTorch's allocator routes a capture's allocations to its graph's
pool only on the capturing stream, and the body captures on a stream of
its own); the step's IF nodes nest in the body, captured on a second
body stream. On a mesh that captures, each rank captures its own loop,
the step's collectives inside the body (the counterpart of JAX's
``while_loop`` under ``jit`` over the mesh), and launches it once a call.

:class:`RequestGraph` is the counterpart of the JAX engine's one traced
call a request (``_make_fused``: ``_fused_prepare``, ``_fused_greedy``,
``_fused_baseline`` and the fused sampling loop; ``_make_fused_prefix``;
``generate_batch``'s ``bcall`` / ``bcall_px``): on one card a flat
request, with or without a prefix, and a whole batch are each one graph,
launched once and read once. It holds the resets (or the copy of a
prefix from the engine's prefix source), the stream's seeding, the window
seeding, the pool fill, the prefill as a WHILE node whose cap, the chunk
count, the device computes from the prompt's and the prefix's lengths,
and, in a whole call, the decode loop's WHILE node after it; a batch
prepares its lanes in a WHILE node over them, each lane's prefill a WHILE
node nested in its body. Every argument of the request (its length, the
prefix's, seed, output buffer, fill, budget, EOS ids and warpers) is on
the device, uploaded before the launch, so one graph serves every request
of its key; its loops' iterations stay on the device until the call's
read (:meth:`RequestGraph.account`).

:func:`cond` is the counterpart of ``lax.cond``: inside a capture it records
its body as a CUDA-graph IF node (``ops/graph_cond.py``), which the device
runs or skips on each replay by a predicate it computed itself; eagerly it
reads the predicate on the host. ``stats`` counts the branches evaluated
and the bodies run (a replay's on the device: :func:`read_stats` folds
them in).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref
from typing import Callable, List, Tuple

import torch
import torch.distributed as dist

from ..ops import (graph_cond, int4_micro, lookahead_attention, philox,
                   quant, quant_matmul)
from ..parallel import collectives

# Captures made, replays run (decode steps, a device loop's iterations
# included), prefill chunks run (replays of a chunk graph and a request
# graph's prefill iterations), device loops launched (LoopGraph replays
# and the decode loops of RequestGraph launches), RequestGraph launches,
# cond branches evaluated (eagerly, or by a replay's IF nodes) and their
# bodies run. Read with read_stats() and reset with reset_stats(), which
# fold in the bodies that replays ran.
stats = {"captured": 0, "replays": 0, "prefills": 0, "loops": 0,
         "requests": 0, "branches": 0, "taken": 0}

# every launch counter of the port's kernels, and the collectives' calls
_TALLIES = (lookahead_attention.counts, lookahead_attention.paged_counts,
            quant_matmul.counts, int4_micro.counts, graph_cond.counts,
            philox.counts, collectives.counts)

_eager_depth = 0

# (StepGraph, capturing) while a StepGraph runs its warm step (False) or
# captures (True); None otherwise
_active = None

# StepGraphs whose captured step holds IF nodes, for read_stats()
_with_conds: "weakref.WeakSet" = weakref.WeakSet()


@contextlib.contextmanager
def eager():
    """Inside this block engines step eagerly on the card too (no capture,
    no replay): the eager side of a graphed-against-eager comparison."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def cond(pred: torch.Tensor, body: Callable[[], object]) -> None:
    """``lax.cond(pred, body, no-op)``: run ``body`` when the one-element
    boolean tensor ``pred`` is true. ``body`` takes no arguments, writes
    its results in place into tensors made before the call, and allocates
    no device memory itself.

    - Inside a :class:`StepGraph` capture the body is recorded as an IF
      node (``ops/graph_cond.py``): each replay computes ``pred`` on the
      device and runs or skips the body there, and a body that runs adds
      one to its graph's device counter (``StepGraph.taken``). Where the
      node cannot be made the capture raises; nothing runs the body
      unconditionally instead. A body must launch none of the port's
      counted kernels (a replay could not tell whether it ran them) and
      call no collective (each rank evaluates its IF node on its own
      device: a collective under a predicate that differed between ranks
      would hang the world): the capture raises if it does.
    - The warm step before a capture runs every body once, whatever
      ``pred`` says, so that no body is captured before its first-use work
      is done. A body must therefore change nothing that is read when
      ``pred`` is false; that run is counted in neither ``stats`` entry.
    - Anywhere else (the CPU, a mesh, inside :func:`eager`) it reads
      ``pred`` on the host, a sync, and runs the body if it is true."""
    if _active is None:
        stats["branches"] += 1
        if bool(pred):
            stats["taken"] += 1
            body()
        return
    owner, capturing = _active
    if not capturing:                   # the warm step
        body()
        return

    def counted():
        before = [dict(t) for t in _TALLIES]
        body()
        owner.taken.add_(1)
        if [dict(t) for t in _TALLIES] != before:
            raise RuntimeError(
                "a graphs.cond body launched one of the port's counted "
                "kernels or called a collective: a replay could not count "
                "its launches, and a collective under a rank's own "
                "predicate could hang the world")
    graph_cond.if_node(pred.reshape(()).to(torch.bool), counted,
                       owner.body_stream)
    owner.conds += 1
    _with_conds.add(owner)


def read_stats() -> dict:
    """``stats`` after adding the IF bodies that replays ran since the last
    read, from each live graph's device counter (a sync)."""
    for g in list(_with_conds):
        n = int(g.taken)
        stats["taken"] += n - g.taken_read
        g.taken_read = n
    return dict(stats)


def reset_stats() -> None:
    """Set every ``stats`` entry to 0 (after :func:`read_stats`, so bodies
    run before the reset are not counted after it)."""
    read_stats()
    stats.update(dict.fromkeys(stats, 0))


def eager_depth() -> int:
    """How many :func:`eager` blocks are open (0: engines capture)."""
    return _eager_depth


def _leaves(tree):
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def state_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a state tree (dataclasses, dicts, lists)."""
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def state_generators(tree) -> List[torch.Generator]:
    """Every ``torch.Generator`` of a state tree."""
    return [x for x in _leaves(tree) if isinstance(x, torch.Generator)]


class EagerSteps:
    """``run(n)``: ``n`` calls of the step, launched op by op."""

    def __init__(self, step: Callable[[], object]):
        self.step = step

    def run(self, n: int) -> None:
        for _ in range(n):
            self.step()


class StepGraph:
    """One decode step (or prefill chunk) captured over ``state``, a tree
    whose tensors the step reads and writes in place and whose generators
    it draws from. ``run(n)`` runs ``n`` steps: on first use one warm step
    and the capture, then replays, each counted in ``stats[counter]``.
    ``pool`` is a graph memory pool (``torch.cuda.graph_pool_handle()``)
    shared by an engine's graphs, which never run at once and keep no
    output alive past a replay."""

    # nesting depth of the graph's IF bodies (graph_cond.body_stream)
    if_depth = 0

    def __init__(self, step: Callable[[], object], state, pool=None,
                 counter: str = "replays"):
        self.step = step
        self.state = state
        self.pool = pool
        self.counter = counter
        self.graph = None
        self.replays = 0
        # (tally, key, launches a replay) of each kernel the step launches
        self.launches: list = []
        self.conds = 0           # IF nodes (graphs.cond) in the capture
        self.body_stream = None  # the stream IF bodies capture on
        self.taken = None        # device counter: IF bodies replays ran
        self.taken_read = 0      # what read_stats() has counted of it

    def run(self, n: int) -> None:
        if n <= 0:
            return
        if self.graph is None:
            self._capture()
            n -= 1
        for _ in range(n):
            self.graph.replay()
        collectives.graph_launched()
        self._count(n)

    def _count(self, n: int) -> None:
        """Fold ``n`` steps that replays ran into the counts."""
        self.replays += n
        stats[self.counter] += n
        stats["branches"] += n * self.conds
        for tally, key, k in self.launches:
            tally[key] += k * n

    def branches(self) -> Tuple[int, int]:
        """(IF bodies run, IF nodes evaluated) by the replays so far; reads
        the device counter."""
        taken = 0 if self.taken is None else int(self.taken)
        return taken, self.replays * self.conds

    def launches_per_replay(self) -> dict:
        """{kernel counter key: launches a replay}."""
        out: dict = {}
        for _, key, k in self.launches:
            out[key] = out.get(key, 0) + k
        return out

    def _warm(self) -> None:
        """The warm step before the capture: a real step of the run."""
        self.step()

    def _record(self) -> None:
        """What the capture records: one step."""
        self.step()

    def _capture(self) -> None:
        global _active
        tensors = state_tensors(self.state)
        ptrs = [t.data_ptr() for t in tensors]
        device = tensors[0].device if tensors else torch.device("cuda")
        self.conds = 0
        self.body_stream = graph_cond.body_stream(device, self.if_depth)
        self.taken = torch.zeros((), dtype=torch.int64, device=device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _active = (self, False)
            try:
                self._warm()                # the warm step, a real one
            finally:
                _active = None
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for gen in state_generators(self.state):
            graph.register_generator_state(gen)
        before = [dict(t) for t in _TALLIES]
        # An engine's graphs sit in reference cycles (step closures over
        # its slots), which only the cycle collector frees; destroying a
        # graph during a capture invalidates the capture. So collect now,
        # and not while capturing.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                _active = (self, True)
                try:
                    self._record()
                finally:
                    _active = None
        finally:
            if collecting:
                gc.enable()
            captured = [dict(t) for t in _TALLIES]
            for tally, old in zip(_TALLIES, before):
                tally.update(old)           # the capture launched nothing
        if [t.data_ptr() for t in state_tensors(self.state)] != ptrs:
            raise RuntimeError(
                "the step rebound a state tensor: a captured step must "
                "write its state in place")
        self.launches = [(tally, key, captured[i][key] - old[key])
                         for i, (tally, old) in enumerate(zip(_TALLIES,
                                                              before))
                         for key in tally if captured[i][key] != old[key]]
        self.graph = graph
        stats["captured"] += 1


class LoopGraph(StepGraph):
    """The whole decode loop of one static state captured as one graph: the
    counterpart of the JAX decode loop's ``lax.while_loop`` on
    ``~finished``. A WHILE node (``ops/graph_cond.py``) runs the step while
    any of the bool flags ``finished`` is clear and fewer than ``cap`` (an
    int32 tensor of the state, the call's ``max_new``: every live step
    confirms a token) iterations have run; the step's own IF nodes nest in
    its body. ``run()`` launches the loop once (on first use after one warm
    step, a real step of the run, and the capture); the iterations it ran
    are on the device, in ``iters``, which the caller reads in its final
    transfer and hands to :meth:`account`, which counts them in ``stats``
    (``replays``, ``branches``) and the kernels' launches. ``body_pool``
    (a ``torch.cuda.MemPool``) takes the step's allocations in the body.

    A step draws its random numbers from the state's Philox streams
    (``ops/philox.py``), whose kernel reads the draw counter that the step
    advances on the device, so each iteration draws fresh numbers. A
    capture raises instead of looping on the host: on a step that moves a
    ``torch.Generator`` of its state (a replay advances a generator's
    philox offsets on the host, so every iteration would draw the same
    numbers: any draw that bypasses the state's stream), and where the
    WHILE node or a node of its body cannot be made (NCCL's graph mixing
    on, which puts event nodes into a captured collective, for one:
    ``parallel/collectives.py``).

    On a ``mesh`` (one for which :func:`capturable` holds: its groups are
    all NCCL; any other raises) each rank captures and launches its own
    loop, the step's collectives inside the body, and no rank reads or
    sends its condition to another. Every rank must therefore run the same
    iterations, or one that stopped early would leave the others blocked
    in a collective. JAX has that for free (the ``while_loop``'s predicate
    under ``jit`` over a mesh is a replicated value); here it holds by
    construction, because ``finished``, like all of the state, is written
    from values that are bit-equal on every rank:

    - tp: the LM head's vocabulary shards are all-gathered (a copy), so
      every rank holds the same logits; the hidden rows before it come
      from NCCL all-reduces, whose result is the same on every rank
      (NCCL's algorithms reduce each element once and pass the sum on),
      and from the same kernels on the same inputs;
    - la: each rank's share of the composite rows, and their K/V, are
      all-gathered before the logits and the cache write, so every rank
      holds all rows;
    - pp: the last stage broadcasts its hidden rows to every stage, which
      applies the replicated final norm and LM head;
    - sampling: the noise comes from the state's Philox stream, whose key
      and counter are state too.

    The tokens, EOS ids, budgets and ``kv_len`` that ``finished`` is
    computed from are thus the same on every rank, and so is the
    condition; the checks compare the iterations each rank ran (the
    ``replays`` a call counts). The collectives in the body need NCCL's
    graph mixing off, which ``make_mesh`` sets; how the port keeps the
    two conditions NCCL then sets is in ``parallel/collectives.py``."""

    if_depth = 1

    def __init__(self, step: Callable[[], object], state,
                 finished: torch.Tensor, cap: torch.Tensor, pool=None,
                 body_pool=None, mesh=None):
        if mesh is not None and not capturable(finished.device, mesh):
            raise ValueError(
                "the decode loop runs on the device on a mesh only when the "
                "mesh captures (every process group NCCL, on the card): "
                "this mesh steps from the host")
        super().__init__(step, state, pool)
        self.finished, self.cap = finished, cap
        self.body_pool = body_pool
        # device counter: the last launch's iterations
        self.iters = torch.zeros(1, dtype=torch.int32, device=finished.device)

    def run(self) -> None:
        """Launch the loop once (the first call: after one warm step and
        the capture). Reads nothing back."""
        if self.graph is None:
            self._capture()
        self.graph.replay()
        collectives.graph_launched()
        stats["loops"] += 1

    def account(self, iters: int) -> None:
        """Count the ``iters`` iterations of the last launch, read by the
        caller from ``self.iters``: each is a step, with its branches and
        launches, and the WHILE node's condition kernel ran once more."""
        self._count(iters)
        graph_cond.counts["set_while"] += 1

    def _warm(self) -> None:
        _without_generators(self.state, self.step)

    def _record(self) -> None:
        graph_cond.while_node(self.finished, self.cap, self.iters, self.step,
                              graph_cond.body_stream(self.iters.device),
                              self.body_pool)

    def _capture(self) -> None:
        super()._capture()
        # the condition kernel before the loop runs once a launch, the one
        # at the body's end once an iteration (account)
        self.launches = [(tally, key, k - (tally is graph_cond.counts
                                           and key == "set_while"))
                         for tally, key, k in self.launches]


def _without_generators(state, run: Callable[[], object]) -> None:
    """``run()``, refused where it moved a ``torch.Generator`` of
    ``state``: a loop on the device would draw the same numbers every
    iteration."""
    gens = state_generators(state)
    before = [g.get_state() for g in gens]
    run()
    if any(not torch.equal(g.get_state(), b) for g, b in zip(gens, before)):
        raise RuntimeError(
            "the step drew random numbers from a torch.Generator: a "
            "device loop would draw the same ones every iteration (a "
            "replay advances its philox offsets on the host); draw "
            "from the state's stream (ops/philox.py) or step it from "
            "the host")


def _minus(launches: list, less: list) -> list:
    """(tally, key, launches) of ``launches`` less those of ``less``, none
    at zero."""
    out = {(id(t), key): [t, key, k] for t, key, k in launches}
    for t, key, k in less:
        out[(id(t), key)][2] -= k
    return [tuple(x) for x in out.values() if x[2]]


def _since(before) -> list:
    """(tally, key, launches) of every count that moved since ``before``
    (``[dict(t) for t in _TALLIES]``)."""
    return [(tally, key, tally[key] - old.get(key, 0))
            for tally, old in zip(_TALLIES, before)
            for key in tally if tally[key] != old.get(key, 0)]


class RequestGraph(StepGraph):
    """A whole request captured as one graph: the counterpart of the JAX
    engine's fused call (``_make_fused``: ``_fused_prepare``,
    ``_fused_greedy``, ``_fused_baseline``, the fused sampling loop; their
    ``_make_fused_prefix`` variants; ``generate_batch``'s ``bcall`` /
    ``bcall_px``).

    ``record(graph)`` enqueues the request over ``state`` (a ``FlatSlot``,
    or a batch's flat slot and ``LaneSlot``): the preparation as it stands,
    and each loop through :meth:`loop`, a WHILE node (``ops/graph_cond.py``)
    whose body is captured straight into the node, its allocations in
    ``body_pool`` (a ``torch.cuda.MemPool``), its IF nodes nested on a
    deeper body stream: the prefill's chunks under a cap the device
    computed, then, in a whole call, the decode loop on ``~finished``; a
    batch's lanes in a loop whose body holds each lane's prefill loop,
    nested. The request's arguments are in ``state`` on the device (the
    engine uploads them before the launch), so one graph serves every
    request of its key.

    The warm run before the capture runs the preparation and one pass of
    each loop's body, which does every first-use piece of work (builds,
    ``dlopen``, lazy tables) and is refused where it moved a
    ``torch.Generator``; the launch that follows starts over from the
    resets. ``run()`` launches the graph once and reads nothing back; the
    loops' iterations stay in their counters on the device until the
    caller's read hands them to :meth:`account`, which counts the
    preparation's launches once and each loop's per iteration (a prefill
    iteration as ``stats["prefills"]``, a decode one as ``replays``, a
    lane's in no entry), each loop's condition kernel once before it (a
    nested loop's once an iteration of its parent) and once an
    iteration."""

    if_depth = 1

    def __init__(self, record: Callable[["RequestGraph"], None], state,
                 pool=None, body_pool=None):
        super().__init__(lambda: record(self), state, pool)
        self.body_pool = body_pool
        device = state_tensors(state)[0].device
        self.iters = torch.zeros(1, dtype=torch.int32, device=device)
        # name -> (stats entry or None, launches an iteration, IF nodes an
        # iteration), recorded by the capture; then the launches once a
        # launch, and each loop's counter
        self.loops: dict = {}
        self.fixed: list = []
        self.counters: dict = {}
        # while capturing: the loops open around the capture's position,
        # each with the launches and IF nodes of the loops nested in it
        self._open: list = []

    def loop(self, name: str, counter, finished: torch.Tensor,
             cap: torch.Tensor, iters: torch.Tensor,
             body: Callable[[], object]) -> None:
        """The request's WHILE node ``name``: ``body`` while any of
        ``finished`` is clear and fewer than ``cap`` iterations have run,
        counted in ``iters`` on the device (``graph_cond.while_node``);
        ``counter`` is the ``stats`` entry its iterations count in (None:
        none). Inside another loop's body it nests: its body captures one
        stream deeper (``graph_cond.body_stream``), its IF nodes one
        deeper still, and its launches count by its own iterations, not
        by the outer loop's. The body may read ``iters``, the iteration
        under way. In the warm run, one pass of ``body``, ``iters``
        zeroed."""
        if _active is not None and not _active[1]:
            iters.zero_()
            body()
            return
        self.counters[name] = iters
        device, depth = iters.device, len(self._open)

        def counted():
            before, conds = [dict(t) for t in _TALLIES], self.conds
            inner = {"launches": [], "conds": 0}
            self._open.append(inner)
            outer, self.body_stream = (self.body_stream,
                                       graph_cond.body_stream(device,
                                                              depth + 1))
            try:
                body()
            finally:
                self._open.pop()
                self.body_stream = outer
            if self.graph is None:            # the capture's own pass
                launches = _minus(_since(before), inner["launches"]) + [
                    (graph_cond.counts, "set_while", 1)]
                own = self.conds - conds - inner["conds"]
                self.loops[name] = (counter, launches, own)
                if self._open:                # nested: its parent's share
                    self._open[-1]["launches"] += launches
                    self._open[-1]["conds"] += own
        graph_cond.while_node(finished, cap, iters, counted,
                              graph_cond.body_stream(device, depth),
                              self.body_pool)

    def run(self) -> None:
        """Launch the request once (the first call: after the warm run and
        the capture). Reads nothing back."""
        if self.graph is None:
            self._capture()
        self.graph.replay()
        collectives.graph_launched()
        stats["requests"] += 1
        stats["loops"] += any(c == "replays" for c, _, _ in
                              self.loops.values())

    def account(self, **iters: int) -> None:
        """Count the last launch: its launches outside the loops once, and
        ``iters[name]`` iterations of each loop, read by the caller from
        ``counters[name]`` (a nested loop's: summed over the outer loop's
        iterations): their launches, ``stats`` entries and branches."""
        for tally, key, k in self.fixed:
            tally[key] += k
        for name, n in iters.items():
            counter, launches, conds = self.loops[name]
            if counter is not None:
                stats[counter] += n
            stats["branches"] += conds * n
            for tally, key, k in launches:
                tally[key] += k * n

    def per_iteration(self, name: str) -> dict:
        """{kernel counter key: launches an iteration of loop ``name``}."""
        out: dict = {}
        for _, key, k in self.loops[name][1]:
            out[key] = out.get(key, 0) + k
        return out

    def _warm(self) -> None:
        _without_generators(self.state, self.step)

    def _capture(self) -> None:
        super()._capture()
        # the capture ran each body once and counted both of its WHILE
        # node's condition kernels; a launch runs the one before the loop
        # once (a nested loop's: once an outer iteration) and the rest an
        # iteration
        self.fixed = _minus(self.launches, [
            x for _, launches, _ in self.loops.values() for x in launches])


def capturable(device, mesh=None) -> bool:
    """Whether a step on ``device`` over ``mesh`` may be captured: on the
    card, without a mesh or on one whose process groups are all NCCL (an
    axis of size 1 has no group, so a mesh without groups counts)."""
    return torch.device(device).type == "cuda" and (
        mesh is None or all(dist.get_backend(g) == "nccl"
                            for g in mesh.groups.values()))


def runner(cache: dict, key, step: Callable[[], object], state, graphed: bool,
           pool=None, counter: str = "replays"):
    """The step runner of ``key`` in ``cache``: a :class:`StepGraph` when
    ``graphed`` (:func:`capturable`) and not inside :func:`eager`, else
    :class:`EagerSteps`. Graphs are cached; the step
    closure must read only ``state`` and tensors that outlive the cache.
    ``ops.quant.INT4_PIPELINE`` picks the int4 kernel inside the step, so
    it is part of the key too. ``counter`` is the ``stats`` entry that
    counts the graph's replays."""
    if not graphed or eager_depth():
        return EagerSteps(step)
    key = (key, quant.INT4_PIPELINE)
    got = cache.get(key)
    if got is None:
        got = cache[key] = StepGraph(step, state, pool, counter)
    return got


def loop_runner(cache: dict, key, step: Callable[[], object], state,
                finished: torch.Tensor, cap: torch.Tensor, pool=None,
                body_pool=None, mesh=None) -> LoopGraph:
    """The :class:`LoopGraph` of ``key`` in ``cache`` (made at first use;
    keyed with ``ops.quant.INT4_PIPELINE`` as :func:`runner`): the whole
    decode loop of ``step`` over ``state`` while any of ``finished`` is
    clear, at most ``cap`` iterations. Only on the card outside
    :func:`eager`, on one card or a ``mesh`` that captures: the caller
    chooses it by mode."""
    key = ("loop", key, quant.INT4_PIPELINE)
    got = cache.get(key)
    if got is None:
        got = cache[key] = LoopGraph(step, state, finished, cap, pool,
                                     body_pool, mesh)
    return got


def request_runner(cache: dict, key, record, state, pool=None,
                   body_pool=None) -> RequestGraph:
    """The :class:`RequestGraph` of ``key`` in ``cache`` (made at first use;
    keyed with ``ops.quant.INT4_PIPELINE`` as :func:`runner`). Only on one
    card outside :func:`eager`: the caller chooses it by the call's
    kind."""
    key = ("request", key, quant.INT4_PIPELINE)
    got = cache.get(key)
    if got is None:
        got = cache[key] = RequestGraph(record, state, pool, body_pool)
    return got


def fetch(tensor: torch.Tensor):
    """``tensor`` as a numpy array on the host: a call's read back from the
    device (a copy, which waits for the work queued before it)."""
    return tensor.to("cpu", copy=True).numpy()


def upload(array, device, dtype=None) -> torch.Tensor:
    """A host array (numpy, or a CPU tensor) on ``device``. To the card the
    copy goes from pinned memory with ``non_blocking=True``: it is queued
    behind the work before it and the host goes on (a pageable copy would
    wait for that work); the caching host allocator keeps the pinned block
    until the copy has run. On the CPU it is the array itself."""
    t = torch.as_tensor(array)
    if dtype is not None:
        t = t.to(dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def upload_into(dst: torch.Tensor, array) -> None:
    """A host array written into ``dst`` (a contiguous tensor of the same
    dtype and size) in place, as :func:`upload` copies: to the card from
    pinned memory without a wait (the caching host allocator keeps the
    pinned block until the copy has run)."""
    t = torch.as_tensor(array).view(dst.shape)
    if dst.device.type == "cuda":
        t = t.pin_memory()
    dst.copy_(t, non_blocking=True)
