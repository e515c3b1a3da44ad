"""Whole searches captured as CUDA graphs: the counterpart of `jax.jit`'s
cache.

In the JAX package each search path is one jitted program and costs one
dispatch. Here a search on the card is captured once per static key into a
`torch.cuda.CUDAGraph`; a later search of that key copies its queries (and a
filter's mask) into the graph's static inputs, replays the graph as one
launch and copies its static outputs out. The eager code is the body that is
captured, and it is what runs on the CPU.

- **The key** holds every host-side value the body reads: the path, metric,
  kind, padded query count, k, nprobe, the probe's flavour, and the
  decisions a search takes from host counts (``all_live``, the fresh list's
  padded length, the shadows, whether a filter mask is given). The caller
  builds it (`Index._search_plan`, `IVFPartitions.plan`,
  `ShardedIndex._shard_plans`).
- **The generation.** A graph reads the index's tensors by address. Every
  change that replaces one (an add that grows the table, `compact`,
  `optimize`, `clear`, a load, a rebuilt fresh list, an installed IVF)
  changes the index's generation, and a new generation empties the cache.
  Removals update the validity mask in place, so replays see them.
- **Memory.** A cache holds at most ``max_graphs`` graphs (`MAX_GRAPHS`),
  least recently used first out, in one private memory pool. After a
  capture the pools of every cache on the card are held to
  `POOL_BUDGET_SHARE` of its memory together: past it, the caches used
  least recently (not the one that captured) are emptied, and their pools
  go back to the card.
- **Replays.** A graph of one pool may hold its outputs in blocks another
  graph of that pool wrote while it ran, so a cache's lock is held from the
  copy into a graph's static inputs until the copy of its outputs is
  enqueued: all replays run on the card's default stream, in that order.
- **Launch counts.** A replay calls no kernel wrapper, so each graph keeps
  the launches its capture recorded and adds them at every replay. A
  wrapper counts a launch through `count_launch`, which, while this thread
  captures, writes it to the capture's log instead of the counter (the
  capture launched nothing).
- **The profiler.** A graph replayed in a torch.profiler session two
  sessions after its capture crashed the process (`CUDAGraph.replay`, CUDA
  12.8), while graphs captured since the last session profiled cleanly.
  So a search that sees the profiler on where the last search saw it off,
  or the reverse, drops the graphs it would replay (`profiler_epoch`): a
  session replays only graphs captured within it, and a session that runs
  no search changes nothing. Two sessions with no search between them are
  seen as one.
- **Failures.** The first search of a key runs the body eagerly on the
  capture stream (the warm run, whose result it returns), then captures it.
  A capture that fails raises: no search falls back from a graph to eager
  without saying so. The paths that stay eager are named in `EAGER`.
- **Steps.** The k-means fits (kmeans.py) repeat small steps that update
  their state in place: `GraphCache.repeat` runs such a step a number of
  times, the first of a key as the warm run and then a capture, every
  other as a replay. The step's tensors are the graph's own inputs, read
  by address and allocated outside the pool; a generator it draws from is
  registered with the graph, so each replay draws what the eager step
  would. A fit's graphs live in a cache of their own (one a top-level fit),
  under the same budget.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch

#: graphs a cache keeps, least recently used first out
MAX_GRAPHS = 8

#: the share of a card's memory that the pools of all its caches may hold
#: together
POOL_BUDGET_SHARE = 0.25

#: the paths that stay eager on the card, and why (ROADMAP A.14d onward)
EAGER = {
    "streamed views": "driven tile by tile from the host: each tile's rows are copied out of the file's map "
                      "and uploaded while the last tile is searched (stream.py; ROADMAP A.14d)",
    "exact_search": "the package-level `exact_search` builds a new table at each call, so no graph would be "
                    "replayed (ROADMAP A.14e)",
    "plain scans and probes": "no kernel on the path: the plain scan (`ops/topk.scan_topk`: k past the kernels' "
                              "gates, f16, pearson, the dot metrics over b1; ROADMAP A.16b), the plain probes (the "
                              "copied IVF layout, windows past B3's guard), the metric tail and user-defined metrics "
                              "(ROADMAP A.14f)",
    "add": "`Index._scatter` and `_cast_device` are 3-6 launches a batch against a host-bound call, and a "
           "bucketed `index_copy_` would need the drop slot the JAX scatter gets from out-of-bounds semantics "
           "(ROADMAP A.14h)",
    "the fits' once-a-build bodies": "the coarse assignment (`kmeans._coarse_assign`), the flat pass "
                                     "(`_flat_pass`, `assign_flat`), the assigned distances (`_assigned_dists`) and "
                                     "a fit's set-up (the padded copy, the seeding's norms and first draw): each "
                                     "runs once a build, so a capture would cost more than it saves (ROADMAP A.14g)",
}


#: every live cache, for the budget
_CACHES: "weakref.WeakSet[GraphCache]" = weakref.WeakSet()
#: the launch log of the capture this thread is making
_capturing = threading.local()
#: the order in which caches were used, for the budget
_ticks = itertools.count()
_budget_lock = threading.Lock()
_profiler_lock = threading.Lock()
_profiler = {"seen_on": False, "epoch": 0}


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: on its ``launches`` counter, or,
    while this thread captures a graph, in the capture's log (a capture
    launches nothing; each replay adds the log to the counters)."""
    log = getattr(_capturing, "log", None)
    if log is None:
        wrapper.launches += 1
    else:
        log[wrapper] = log.get(wrapper, 0) + 1


@contextlib.contextmanager
def recording():
    """The launches this thread counts inside, kept off the counters: a
    capture's log (a dict of wrapper to launches)."""
    outer, _capturing.log = getattr(_capturing, "log", None), {}
    try:
        yield _capturing.log
    finally:
        _capturing.log = outer


def add_launches(counts: Dict[Callable, int]) -> None:
    """Add a replayed graph's recorded ``counts`` to the wrappers' counters."""
    for f, n in counts.items():
        f.launches += n


def profiler_epoch() -> int:
    """A count that moves whenever a call sees torch.profiler on where the
    last call saw it off, or the reverse: graphs captured before it are not
    replayed after."""
    on = bool(torch.autograd.profiler._is_profiler_enabled)
    with _profiler_lock:
        if _profiler["seen_on"] != on:
            _profiler["epoch"] += 1
        _profiler["seen_on"] = on
        return _profiler["epoch"]


def pool_budget(device: torch.device) -> Optional[int]:
    """Bytes the pools of ``device``'s caches may hold together
    (`POOL_BUDGET_SHARE` of its memory); None off the card."""
    if device.type != "cuda":
        return None
    return int(POOL_BUDGET_SHARE * torch.cuda.get_device_properties(device).total_memory)


def hold_budget(device: torch.device, keep: "GraphCache") -> None:
    """Empty the caches on ``device`` used least recently, never ``keep``,
    until their pools fit `pool_budget` (a pool whose size the allocator
    does not report counts as empty)."""
    budget = pool_budget(device)
    if budget is None:
        return
    with _budget_lock:
        caches = sorted((c for c in list(_CACHES) if c.device == device and len(c)), key=lambda c: c.last_used)
        held = {c: c.pool_bytes() or 0 for c in caches}
        total, emptied = sum(held.values()), False
        for c in caches:
            if total <= budget:
                break
            if c is not keep:
                c.clear()
                total, emptied = total - held[c], True
        if emptied and device.type == "cuda":
            torch.cuda.empty_cache()


class CudaBackend:
    """The card's capture and replay: `torch.cuda.CUDAGraph`s in one private
    pool, warmed and captured on a side stream, replayed on the device's
    default stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.default_stream(device)
        self._side = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def reset(self) -> None:
        """A new pool: the old one's memory goes back as its graphs die."""
        self.pool = torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def _on(self, stream):
        cur = torch.cuda.current_stream(self.device)
        if cur != stream:
            stream.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            yield
        if cur != stream:
            cur.wait_stream(stream)

    def warm(self, body, args):
        """``body(*args)`` run eagerly on the capture stream (lazy set-up,
        cuBLAS's workspace for that stream): its result."""
        with self._on(self._side):
            return body(*args)

    def capture(self, body, args, generators=()):
        """``(graph, outputs)`` of ``body(*args)`` captured, with the draws
        from ``generators`` registered; in ``thread_local`` mode, so other
        threads' searches go on. The cached free blocks of the other pools
        go back to the card first, as `torch.cuda.graph` does: a capture
        cannot free them when its pool needs room."""
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with self._on(self._side):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                outputs = body(*args)
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
        return graph, outputs

    def replaying(self):
        return self._on(self.stream)

    def replay(self, graph) -> None:
        graph.replay()

    def pool_bytes(self) -> Optional[int]:
        """Bytes the pool holds on the device (None where the allocator's
        snapshot does not name segments' pools)."""
        segments = torch.cuda.memory_snapshot()
        if segments and "segment_pool_id" not in segments[0]:
            return None
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in segments
                   if tuple(s["segment_pool_id"]) == pool and s.get("device", self.device.index) == self.device.index)


class Captured:
    """One captured search: its graph, static inputs and outputs, and the
    launches its capture recorded. It keeps no reference to the body: a
    body that closes over its index would make a cycle (index, cache,
    graph, body), and the cyclic collector could then destroy a graph at
    any moment, a capture's included. The tensors the graph reads live as
    long as the index holds them, and a new generation drops the graph
    first."""

    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs, self.launches = graph, inputs, outputs, launches


class GraphCache:
    """An index's captured searches, by key, within one generation.
    ``backend`` captures and replays (`CudaBackend` of ``device`` by
    default, made at the first capture)."""

    def __init__(self, device, backend=None, max_graphs: int = MAX_GRAPHS):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.max_graphs = max_graphs
        self._backend = backend
        self._graphs: "OrderedDict[tuple, Captured]" = OrderedDict()
        self._lock = threading.Lock()
        self.generation = None
        self.last_used = next(_ticks)
        #: captures made and replays run, over the cache's life
        self.captures = 0
        self.replays = 0
        _CACHES.add(self)

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> list:
        return list(self._graphs)

    @property
    def backend(self):
        if self._backend is None:
            self._backend = CudaBackend(self.device)
        return self._backend

    def pool_bytes(self) -> Optional[int]:
        return self.backend.pool_bytes() if self._graphs else 0

    def clear(self) -> None:
        """Drop every graph (and with them the pool's memory)."""
        with self._lock:
            self._drop()

    def _drop(self) -> None:
        if self._graphs:
            self._graphs.clear()
            self.backend.reset()

    def run(self, key: tuple, generation, body: Callable, args: Tuple[torch.Tensor, ...]):
        """``body(*args)``, a tuple of tensors, through the graph of ``key``:
        captured at the key's first call in ``generation`` (which returns
        the warm run's result), replayed after. ``args`` are copied into
        the graph's static inputs (host tensors should be pinned); the
        outputs are new tensors. The cache's lock is held from the copy in
        to the copy out."""
        with self._lock:
            self._enter(generation)
            entry = self._graphs.get(key)
            if entry is None:
                out = self._capture(key, body, args)
            else:
                self._graphs.move_to_end(key)
                out = self._replay(entry, args)
        if entry is None:
            hold_budget(self.device, self)
        return out

    def _enter(self, generation) -> None:
        """The cache used now (its lock held): a new ``generation``, or a
        new profiler epoch, drops its graphs."""
        generation = (generation, profiler_epoch())
        self.last_used = next(_ticks)
        if generation != self.generation:
            self._drop()
            self.generation = generation

    def _keep(self, key, entry: Captured) -> Captured:
        """A new graph kept under ``key``, the least recently used out past
        ``max_graphs``."""
        while len(self._graphs) >= self.max_graphs:
            self._graphs.popitem(last=False)
        self._graphs[key] = entry
        self.captures += 1
        return entry

    def _capture(self, key, body, args):
        backend = self.backend
        inputs = tuple(torch.empty(a.shape, dtype=a.dtype, device=self.device) for a in args)
        for buf, a in zip(inputs, args):
            buf.copy_(a, non_blocking=True)
        warm = backend.warm(body, inputs)
        with recording() as recorded:
            graph, outputs = backend.capture(body, inputs)
        self._keep(key, Captured(graph, inputs, tuple(outputs), recorded))
        return warm

    def repeat(self, key: tuple, generation, body: Callable, args: Tuple[torch.Tensor, ...], times: int = 1,
               writes: Tuple[torch.Tensor, ...] = (), generators: tuple = ()) -> None:
        """``body(*args)`` run ``times`` times through the graph of ``key``:
        a step that updates ``writes`` (some of ``args``) in place and
        returns an empty tuple. At the key's first call in ``generation``
        the first run is the warm run; the graph is then captured, with
        ``generators`` registered, and ``writes`` and ``generators`` are
        put back as the warm run left them (a capture runs nothing on the
        card, but a stand-in's may). Every other run is a replay. The graph
        reads ``args`` by address, so the caller keeps one set of them a
        key."""
        if times <= 0:
            return
        with self._lock:
            self._enter(generation)
            entry = self._graphs.get(key)
            captured = entry is None
            if captured:
                entry = self._capture_step(key, body, args, writes, generators)
                times -= 1
            else:
                self._graphs.move_to_end(key)
            if times:
                with self.backend.replaying():
                    for _ in range(times):
                        self.backend.replay(entry.graph)
                for _ in range(times):
                    add_launches(entry.launches)
                self.replays += times
        if captured:
            hold_budget(self.device, self)

    def _capture_step(self, key, body, args, writes, generators) -> Captured:
        backend = self.backend
        backend.warm(body, args)
        kept = [w.clone() for w in writes]
        drawn = [g.get_state() for g in generators]
        with recording() as recorded:
            graph, _ = backend.capture(body, args, generators)
        for w, k in zip(writes, kept):
            w.copy_(k)
        for g, state in zip(generators, drawn):
            g.set_state(state)
        return self._keep(key, Captured(graph, tuple(args), (), recorded))

    def _replay(self, entry: Captured, args):
        backend = self.backend
        with backend.replaying():
            for buf, a in zip(entry.inputs, args):
                buf.copy_(a, non_blocking=True)
            backend.replay(entry.graph)
            out = tuple(o.clone() for o in entry.outputs)
        add_launches(entry.launches)
        self.replays += 1
        return out
