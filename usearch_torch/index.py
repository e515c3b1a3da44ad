"""`Index`: the vector index on a device.

Counterpart of `usearch_tpu/index.py`. Rows live in a capacity-padded table
on the device, beside per-row stats and a validity mask; deleted rows are
masked inside the scan kernels, and their slots are reused by later adds.
Search pads queries to a power of two. Without an IVF it goes through
`exact.search_kernel`: approximate (one candidate per 128-row bin) from
131,072 rows on, exact below that or with ``exact=True``. After
`optimize`, non-exact searches probe the IVF partitions (ivf.py); rows added
later join its fresh list, scanned exactly, until the next `optimize`.

Every metric and storage pairing of the JAX package is served: the metric
tail (haversine, divergence, jaccard over int32 sets padded with -1) and
user-defined metrics (`enums.CompiledMetric`) through the plain scan and
probes, f64 rows as f32 on the device beside an exact host copy.
`cluster` (cluster.py) and `join` (join.py) run on the index's searches.

On the card each search of a kernel path (B1, B2, and the IVF's B3, B4 and
B5 flavours) runs as a CUDA graph, captured at the first search of its key
and replayed after (graphs.py, the counterpart of the JAX package's
``jax.jit``); on the CPU the same body runs eagerly.

`search_async` enqueues a search and returns a `PendingSearch`; its
``result()`` waits for that search alone. A streamed view (``view(path,
stream=True)``) keeps its rows in the file's memory map and searches them
exactly in tiles streamed through the device (stream.py).
"""

from __future__ import annotations

import functools
import math
import os
import struct
import threading
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .enums import (
    DEFAULT_CONNECTIVITY,
    DEFAULT_EXPANSION_ADD,
    DEFAULT_EXPANSION_SEARCH,
    CompiledMetric,
    ScalarKind,
    MetricKind,
    kind_of_dtype,
    normalize_dtype,
    normalize_metric,
    to_torch_dtype,
)
from .exact import (kernel_tiles, pad_queries, pad_rows, pick_tile_rows, prepare_rows, prepare_set_rows,
                    resolve_device, search_kernel, storage_width)
from .graphs import GraphCache
from .keymap import KeyMap
from .matches import BatchMatches, Clustering, Matches
from .ops import bitscan
from .ops.casts import as_tensor, cast_rows
from .ops.distances import pair_dists, row_stats
from .ops.packbits import unpack_bits_np

#: capacity quantum in rows
ROW_TILE = 1024
#: non-exact searches of tables with this many rows go approximate
APPROX_MIN_ROWS = 131072
#: host batches of at least two such chunks are cast and copied chunk by chunk
INGEST_CHUNK = 131072
#: the float kinds `get` gives from an f64 index's host copy by a numpy cast
_F64_OUT = {ScalarKind.F64: np.float64, ScalarKind.F32: np.float32, ScalarKind.F16: np.float16}
#: the array types `get` returns
_NUMPY_DTYPES = {ScalarKind.F64: np.float64, ScalarKind.F32: np.float32, ScalarKind.F16: np.float16,
                 ScalarKind.I8: np.int8}


class _RWLock:
    """Searches share, mutations are exclusive; a writer may re-enter and
    read its own state."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = None
        self._depth = 0

    def acquire_read(self) -> bool:
        """True when a reader slot was taken (hand it to `release_read`),
        False when the caller is the writer."""
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                return False
            while self._writer is not None:
                self._cond.wait()
            self._readers += 1
            return True

    def release_read(self, token: bool = True) -> None:
        if not token:
            return
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._depth += 1
                return
            while self._writer is not None or self._readers:
                self._cond.wait()
            self._writer = me
            self._depth = 1

    def release_write(self) -> None:
        with self._cond:
            self._depth -= 1
            if self._depth == 0:
                self._writer = None
                self._cond.notify_all()


def _reads(fn):
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        token = self._rwlock.acquire_read()
        try:
            return fn(self, *args, **kwargs)
        finally:
            self._rwlock.release_read(token)

    return wrapper


def _mutates(fn):
    """Exclusive access; bumps the version that keys the filter-mask cache."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        self._rwlock.acquire_write()
        try:
            self._version += 1
            return fn(self, *args, **kwargs)
        finally:
            self._rwlock.release_write()

    return wrapper


class PendingSearch:
    """A search in flight, from `Index.search_async`.

    It holds the index's read lock, taken at dispatch, until ``result()``
    has run (on any thread), as the reference's search result holds its
    thread checkout (index_dense.hpp:550-564). On the card the dispatch
    enqueued the search and the copies of its distances and slots into
    pinned host memory, and recorded an event after them: ``result()``
    waits on that event alone. ``result()`` is idempotent, and a failure
    stays the result."""

    __slots__ = ("_index", "_d", "_slots", "_ready", "_n_q", "_single", "_radius", "_scanned", "_progress",
                 "_out", "_error", "_lock_token")

    def __init__(self, index, d, slots, n_q, single, radius, scanned, lock_token=None, progress=None):
        self._index = index
        self._ready = None
        if d is not None:
            d, slots = d[:n_q], slots[:n_q]
            if d.device.type == "cuda":
                stream = torch.cuda.current_stream(d.device)
                d = torch.empty(d.shape, dtype=d.dtype, pin_memory=True).copy_(d, non_blocking=True)
                slots = torch.empty(slots.shape, dtype=slots.dtype, pin_memory=True).copy_(slots, non_blocking=True)
                self._ready = torch.cuda.Event()
                self._ready.record(stream)
        self._d, self._slots = d, slots
        self._n_q, self._single, self._radius, self._scanned = n_q, single, radius, scanned
        self._progress = progress
        self._out = None
        self._error = None
        self._lock_token = lock_token  # None: no read slot to give back

    def result(self) -> Union["Matches", "BatchMatches"]:
        if self._out is not None:
            return self._out
        if self._error is not None:
            raise self._error
        try:
            if self._ready is not None:
                self._ready.synchronize()
            if self._d is None:  # an empty index or count <= 0
                d, slots = np.zeros((self._n_q, 0), np.float32), np.zeros((self._n_q, 0), np.int64)
            else:
                d, slots = self._d.numpy(), self._slots.numpy()
            self._out = self._index._finish_search(d, slots, self._n_q, self._single, self._radius, self._scanned,
                                                   self._progress)
            self._d = self._slots = None
        except BaseException as e:
            self._error = e
            raise
        finally:
            self._release()
        return self._out

    def _release(self) -> None:
        token, self._lock_token = self._lock_token, None
        if token is not None:
            self._index._rwlock.release_read(token)

    def __del__(self):  # an abandoned handle gives its read slot back
        try:
            self._release()
        except Exception:
            pass


class IndexStats:
    """Counters of an index: its rows as nodes, no edges (there is no
    graph), and the bytes it holds (`Index.memory_usage`)."""

    def __init__(self, nodes: int, edges: int, max_edges: int, allocated_bytes: int):
        self.nodes = nodes
        self.edges = edges
        self.max_edges = max_edges
        self.allocated_bytes = allocated_bytes

    def __repr__(self) -> str:
        return (f"usearch_torch.IndexStats(nodes={self.nodes}, edges={self.edges}, "
                f"allocated_bytes={self.allocated_bytes})")


class Index:
    """Dense vector index on a CUDA card (or the CPU with ``device="cpu"``).

    ::

        index = Index(ndim=3)
        index.add(42, np.array([0.2, 0.6, 0.4]))
        matches = index.search(np.array([0.2, 0.6, 0.4]), 10)
    """

    def __init__(
        self,
        *,
        ndim: int = 0,
        metric=MetricKind.Cos,
        dtype=None,
        connectivity: int = DEFAULT_CONNECTIVITY,
        expansion_add: int = DEFAULT_EXPANSION_ADD,
        expansion_search: int = DEFAULT_EXPANSION_SEARCH,
        multi: bool = False,
        path=None,
        view: bool = False,
        device="cuda",
    ) -> None:
        self._set_metric(metric)
        if self._metric_kind == MetricKind.Haversine and ndim == 0:
            ndim = 2  # (lat, lon)
        self._dtype = normalize_dtype(dtype, ndim=ndim, metric=self._metric_kind)
        if ndim <= 0:
            raise ValueError("ndim must be positive")
        self._device = resolve_device(device)
        self._ndim = int(ndim)
        # jaccard indexes hold integer sets, padded with -1 to a multiple of
        # 8 columns, and report i8 as the JAX package does; f64 rows are f32
        # on the device beside an exact f64 copy on the host (`_host_f64`),
        # and search as f64 (the plain scan and probes: the kernels take
        # f32, as the JAX package's do). `_kind` is the kind searches score
        # in, `_cast_kind` the one rows are cast to for the table.
        self._is_set_index = self._metric_kind == MetricKind.Jaccard
        if self._is_set_index:
            self._dtype, self._kind = ScalarKind.I8, ScalarKind.F32
            self._width, self._torch_dtype = pad_rows(self._ndim, 8), torch.int32
        else:
            self._kind = self._dtype
            self._width = storage_width(self._kind, self._ndim)
            self._torch_dtype = torch.float32 if self._kind == ScalarKind.F64 else to_torch_dtype(self._kind)
        self._cast_kind = ScalarKind.F32 if self._kind == ScalarKind.F64 else self._kind
        self._connectivity = int(connectivity)
        self._expansion_add = int(expansion_add)
        self._expansion_search = int(expansion_search)
        self._multi = bool(multi)
        # `load` configures a live index anew from the file under its own
        # write lock: keep that lock
        if not hasattr(self, "_rwlock"):
            self._rwlock = _RWLock()
        self._version = 0
        self._filter_cache: dict = {}
        # captured searches (graphs.py), made at the first search on the
        # card; `_generation` counts the changes that replace the tensors
        # they read
        self._graphs = GraphCache(self._device) if self._device.type == "cuda" else None
        self._generation = 0
        self._reset_state()
        self._path = None
        if path is not None and os.path.exists(str(path)):
            if view:
                self.view(path)
            else:
                self.load(path)
        self._path = str(path) if path is not None else None

    def _set_metric(self, metric) -> None:
        """A metric kind, or a user-defined metric (`CompiledMetric`, or a
        bare callable of two rows, of kind Unknown)."""
        self._metric_fn = None
        if isinstance(metric, CompiledMetric):
            self._metric_fn, self._metric_kind = metric.fn, metric.kind
        elif callable(metric) and not isinstance(metric, (str, MetricKind)):
            self._metric_fn, self._metric_kind = metric, MetricKind.Unknown
        else:
            self._metric_kind = normalize_metric(metric)

    def _reset_state(self) -> None:
        self._generation += 1
        self._capacity = 0
        self._table: Optional[torch.Tensor] = None  # [capacity, width]
        self._stats: Optional[torch.Tensor] = None  # [capacity, 2] f32
        self._valid: Optional[torch.Tensor] = None  # [capacity] bool
        self._slot_keys = np.zeros(0, dtype=np.uint64)
        self._keymap = KeyMap(multi=self._multi)
        self._free_slots: List[int] = []
        self._next_slot = 0
        self._count = 0
        self._ivf = None  # ivf.IVFPartitions, built by `optimize`
        self._ivf_dirty = True
        self._viewed = False  # `view`: the index refuses changes
        self._streamed = False  # a streamed view: the rows stay in the file's map
        self._stream_rows = None  # [count, columns] stored rows of a streamed view (the map)
        self._host_f64: Optional[np.ndarray] = None  # [capacity, ndim] exact rows of an f64 index

    def _refuse_if_viewed(self, what: str) -> None:
        if self._viewed:
            raise RuntimeError(f"Can't {what} an immutable viewed index")

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return self._count

    @property
    def size(self) -> int:
        return self._count

    @property
    def ndim(self) -> int:
        return self._ndim

    @property
    def dtype(self) -> ScalarKind:
        return self._dtype

    @property
    def metric_kind(self) -> MetricKind:
        return self._metric_kind

    @property
    def metric(self) -> MetricKind:
        return self._metric_kind

    @metric.setter
    def metric(self, metric) -> None:
        """Swap the metric in place: a kind, a `CompiledMetric` or a bare
        callable. The row stats depend on the storage kind alone, so they
        stay; a built IVF keeps serving: its partitions rank by their fit's
        space, the candidates score by the new metric."""
        self._set_metric(metric)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def connectivity(self) -> int:
        return self._connectivity

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def multi(self) -> bool:
        return self._multi

    @property
    def expansion_add(self) -> int:
        return self._expansion_add

    @expansion_add.setter
    def expansion_add(self, v: int) -> None:
        self._expansion_add = int(v)

    @property
    def expansion_search(self) -> int:
        return self._expansion_search

    @expansion_search.setter
    def expansion_search(self, v: int) -> None:
        self._expansion_search = int(v)

    @property
    def numpy_dtype(self):
        """The numpy dtype of the stored rows (uint8 packed bytes for b1);
        None for bf16, which numpy lacks."""
        return _NUMPY_DTYPES.get(self._dtype, np.uint8 if self._dtype == ScalarKind.B1 else None)

    @property
    def jit(self) -> bool:
        """True on the card, where each search path is captured whole as a
        CUDA graph and replayed (graphs.py); the CPU runs it eagerly."""
        return self._device.type == "cuda"

    @property
    def hardware_acceleration(self) -> str:
        """The device the index lives on: the card's name, or "cpu"."""
        if self._device.type == "cuda":
            return torch.cuda.get_device_name(self._device)
        return "cpu"

    @property
    def max_level(self) -> int:
        return 0

    @property
    def nlevels(self) -> int:
        return 1

    @property
    def memory_usage(self) -> int:
        """Device bytes of the table, stats and mask, plus the host keys
        (a streamed view's rows are the file's)."""
        if self._table is None:
            return self._slot_keys.nbytes if self._streamed else 0
        row = self._width * self._table.element_size() + 8 + 1
        f64 = 0 if self._host_f64 is None else self._host_f64.nbytes
        return self._capacity * row + self._slot_keys.nbytes + f64

    @property
    def keys(self) -> "IndexedKeys":
        return IndexedKeys(self)

    @property
    def vectors(self) -> np.ndarray:
        """The live rows decoded to f32, in slot order."""
        keys = self._live_keys()
        if len(keys) == 0:
            return np.zeros((0, self._ndim), dtype=np.float32)
        got = self.get(keys)
        if isinstance(got, np.ndarray) and got.ndim == 2:
            return got
        return np.vstack([g for g in (got if isinstance(got, (list, tuple)) else [got])])

    @property
    def specs(self) -> Dict[str, Any]:
        return {
            "Class": "usearch_torch.Index",
            "Connectivity": self._connectivity,
            "Dimensions": self._ndim,
            "Expansion@Add": self._expansion_add,
            "Expansion@Search": self._expansion_search,
            "Loaded": self._path,
            "Size": self.size,
            "JIT": self.jit,
            "Hardware": self.hardware_acceleration,
            "DataType": self._dtype.value,
            "MetricKind": self._metric_kind.value,
            "Multi": self._multi,
        }

    def stats_object(self) -> IndexStats:
        return IndexStats(nodes=self._count, edges=0, max_edges=0, allocated_bytes=self.memory_usage)

    @property
    def stats(self) -> IndexStats:
        return self.stats_object()

    @property
    def levels_stats(self) -> List[IndexStats]:
        return [self.stats_object()]

    def level_stats(self, level: int) -> IndexStats:
        return self.stats_object() if level == 0 else IndexStats(0, 0, 0, 0)

    def _live_slots(self) -> np.ndarray:
        if self._streamed:
            return np.arange(self._count)
        if self._next_slot == 0:
            return np.zeros(0, dtype=np.int64)
        return np.nonzero(self._valid[: self._next_slot].cpu().numpy())[0]

    def _live_keys(self) -> np.ndarray:
        return self._slot_keys[self._live_slots()]

    def __repr__(self) -> str:
        return (
            f"usearch_torch.Index({self._dtype.value} x {self._ndim}, {self._metric_kind.value}, "
            f"multi: {self._multi}, device: {self._device})"
        )

    # ------------------------------------------------------------------
    # Capacity
    # ------------------------------------------------------------------

    def reserve(self, capacity: int) -> None:
        capacity = int(capacity)
        if capacity > 64 * ROW_TILE:
            # a power of two: every scan tile size divides it
            capacity = 1 << (capacity - 1).bit_length()
        else:
            capacity = pad_rows(max(capacity, 1), ROW_TILE)
        if capacity <= self._capacity:
            return
        extra = capacity - self._capacity
        dev = self._device
        table = torch.zeros((extra, self._width), dtype=self._torch_dtype, device=dev)
        stats = torch.zeros((extra, 2), dtype=torch.float32, device=dev)
        valid = torch.zeros((extra,), dtype=torch.bool, device=dev)
        self._generation += 1
        if self._table is None:
            self._table, self._stats, self._valid = table, stats, valid
        else:
            self._table = torch.cat([self._table, table])
            self._stats = torch.cat([self._stats, stats])
            self._valid = torch.cat([self._valid, valid])
        self._slot_keys = np.concatenate([self._slot_keys, np.zeros(extra, dtype=np.uint64)])
        if self._host_f64 is not None:
            self._host_f64 = np.concatenate([self._host_f64, np.zeros((extra, self._ndim), dtype=np.float64)])
        self._capacity = capacity

    def _ensure_capacity(self, extra_rows: int) -> None:
        needed = self._next_slot + extra_rows - len(self._free_slots)
        if needed > self._capacity:
            self.reserve(max(needed, self._capacity * 2))

    # ------------------------------------------------------------------
    # Ingestion
    # ------------------------------------------------------------------

    def _columns(self, kind: ScalarKind) -> int:
        """Input columns of one row: packed bytes for uint8 (b1) input."""
        return (self._ndim + 7) // 8 if kind == ScalarKind.B1 else self._ndim

    def _check_columns(self, cols: int, kind: ScalarKind, shape) -> None:
        """Rows of a set index may have any width up to the stored one;
        others have `_columns`."""
        ok = cols <= self._width if self._is_set_index else cols == self._columns(kind)
        if not ok:
            raise ValueError(f"Expected {self._columns(kind)} columns for {kind.value} input, got {tuple(shape)}")

    def _device_rows(self, vectors):
        """A tensor argument as ``([B, columns] rows on the index's device,
        their kind)``, or ``(None, None)`` for host (numpy) input."""
        if not isinstance(vectors, torch.Tensor):
            return None, None
        kind = kind_of_dtype(vectors.dtype)
        rows = vectors if vectors.dim() == 2 else vectors.reshape(1, -1)
        self._check_columns(rows.shape[1], kind, vectors.shape)
        return rows.to(self._device), kind

    def _host_rows(self, vectors: np.ndarray):
        """``(rows [B, columns], kind)`` of a host batch."""
        rows = np.atleast_2d(vectors)
        kind = kind_of_dtype(rows.dtype)
        if rows.ndim != 2:
            raise ValueError(f"Expected a [B, {self._columns(kind)}] batch, got {rows.shape}")
        self._check_columns(rows.shape[1], kind, rows.shape)
        return rows, kind

    def _cast_device(self, rows: torch.Tensor, kind: ScalarKind) -> torch.Tensor:
        """Device-side cast and pad to the stored width (sets with -1)."""
        if self._is_set_index:
            return torch.nn.functional.pad(rows.to(torch.int32), (0, self._width - rows.shape[1]), value=-1)
        rows = cast_rows(rows, kind, self._cast_kind, self._ndim)
        return torch.nn.functional.pad(rows, (0, self._width - rows.shape[1]))

    def _prepare_host(self, host: np.ndarray, kind: ScalarKind) -> torch.Tensor:
        """Host cast and pad of a batch to the stored layout (a CPU tensor)."""
        if self._is_set_index:
            return prepare_set_rows(host, self._width)
        return prepare_rows(host, kind, self._cast_kind, self._ndim)

    def _keep_f64(self, slots: np.ndarray, rows, kind: ScalarKind) -> None:
        """An f64 index's exact host copy of rows added at ``slots``: the
        input decoded to f64 (exact for f64 and f32 input)."""
        if self._host_f64 is None:
            self._host_f64 = np.zeros((self._capacity, self._ndim), dtype=np.float64)
        rows = rows if isinstance(rows, torch.Tensor) else as_tensor(rows)
        self._host_f64[slots] = cast_rows(rows, kind, ScalarKind.F64, self._ndim).cpu().numpy()[:, : self._ndim]

    def _scatter(self, slots: torch.Tensor, rows: torch.Tensor) -> None:
        """Write rows, their stats and validity at ``slots``. In place:
        ``index_copy_`` updates the existing table, so an add never copies
        the table."""
        self._table.index_copy_(0, slots, rows)
        self._stats.index_copy_(0, slots, row_stats(rows, self._kind))
        self._valid.index_fill_(0, slots, True)

    @_mutates
    def add(self, keys, vectors, *, copy: bool = True, threads: int = 0, log=False,
            progress: Optional[Callable[[int, int], bool]] = None):
        """Add rows under ``keys`` (None: consecutive keys after the largest).
        ``vectors`` is a numpy batch (cast on the host) or a tensor (moved to
        the index's device and cast there)."""
        self._refuse_if_viewed("add to")
        dev_rows, kind = self._device_rows(vectors)
        if dev_rows is None:
            single = np.ndim(vectors) == 1
            host, kind = self._host_rows(np.asarray(vectors))
            n = host.shape[0]
        else:
            single = vectors.dim() == 1
            n = dev_rows.shape[0]

        if keys is None:
            start = self._keymap.max_key() + 1 if len(self._keymap) else 0
            keys_np = np.arange(start, start + n, dtype=np.uint64)
        elif np.isscalar(keys):
            if n != 1 and not self._multi:
                raise ValueError("Many vectors per key require multi=True")
            keys_np = np.full(n, int(keys), dtype=np.uint64)
        else:
            keys_np = np.asarray(keys, dtype=np.uint64).reshape(-1)
            if len(keys_np) != n:
                raise ValueError(f"{len(keys_np)} keys for {n} vectors")
        if not self._multi:
            dups = self._keymap.contains_many(keys_np)
            if np.any(dups):
                raise KeyError(f"Duplicate keys (multi=False): {keys_np[dups][:5]}")
            uniq, counts = np.unique(keys_np, return_counts=True)
            if np.any(counts > 1):
                raise KeyError(f"Duplicate keys within batch: {uniq[counts > 1][:5]}")

        self._ensure_capacity(n)
        # the most recently freed slots first, then fresh ones
        n_reuse = min(len(self._free_slots), n)
        slots = np.empty(n, dtype=np.int64)
        if n_reuse:
            slots[:n_reuse] = self._free_slots[-n_reuse:]
            del self._free_slots[-n_reuse:]
        slots[n_reuse:] = np.arange(self._next_slot, self._next_slot + n - n_reuse)
        self._next_slot += n - n_reuse
        slots_dev = torch.as_tensor(slots, device=self._device)

        if self._dtype == ScalarKind.F64:
            self._keep_f64(slots, host if dev_rows is None else dev_rows, kind)
        if dev_rows is not None:
            self._scatter(slots_dev, self._cast_device(dev_rows, kind))
            if progress is not None:
                progress(n, n)
        else:
            chunk = INGEST_CHUNK if n >= 2 * INGEST_CHUNK else max(n, 1)
            for off in range(0, n, chunk):
                rows = self._prepare_host(host[off : off + chunk], kind)
                self._scatter(slots_dev[off : off + chunk], rows.to(self._device))
                if progress is not None:
                    progress(min(off + chunk, n), n)
        self._slot_keys[slots] = keys_np
        self._keymap.insert_many(keys_np, slots)
        self._count += n
        # new rows join the IVF's fresh list while it stays within 25% of
        # the built rows and _FRESH_MAX; past that the IVF waits for the
        # next `optimize` and searches scan
        if (
            self._ivf is not None
            and not self._ivf_dirty
            and (self._ivf.fresh_np.size + n) * 4 <= self._ivf.built_count
            and self._ivf.fresh_np.size + n <= self._FRESH_MAX
        ):
            self._ivf.add_fresh(slots)
        else:
            self._ivf_dirty = True
        return int(keys_np[0]) if single else keys_np

    #: fresh-list ceiling: bounds the fresh scan's [Q, F] tile
    _FRESH_MAX = 131072

    # ------------------------------------------------------------------
    # Lookup and mutation
    # ------------------------------------------------------------------

    def contains(self, keys) -> Union[bool, np.ndarray]:
        if np.isscalar(keys):
            return self._keymap.contains(int(keys))
        return self._keymap.contains_many(np.asarray(keys, dtype=np.uint64))

    def __contains__(self, keys):
        return self.contains(keys)

    def count(self, keys) -> Union[int, np.ndarray]:
        if np.isscalar(keys):
            return self._keymap.count(int(keys))
        return self._keymap.count_many(np.asarray(keys, dtype=np.uint64))

    @_reads
    def get(self, keys, dtype=None):
        """Stored vectors decoded to ``dtype`` (f32 by default): None for a
        missing key, a ``[n, ndim]`` matrix per key with ``multi``. A b1
        index gives its packed bytes for ``dtype="b1"`` and unpacks its bits
        to 0/1 values otherwise; an f64 index reads its exact host copy; a
        set index gives its int32 rows as stored."""
        out_kind = ScalarKind.F32 if dtype is None else normalize_dtype(dtype, metric=self._metric_kind)
        allowed = tuple(_NUMPY_DTYPES) + ((ScalarKind.B1,) if self._dtype == ScalarKind.B1 else ())
        if not self._is_set_index and out_kind not in allowed:
            raise ValueError(f"get() returns f64/f32/f16/i8 arrays, not {out_kind.value}")
        single = np.isscalar(keys)
        slot_lists = [self._keymap.slots_of(k) for k in np.atleast_1d(np.asarray(keys, dtype=np.uint64)).tolist()]
        flat = [s for sl in slot_lists for s in sl]
        results = []
        if flat:
            rows = self._fetch_slots(flat, out_kind)
            offs = np.cumsum([0] + [len(sl) for sl in slot_lists])
        for i, sl in enumerate(slot_lists):
            if not sl:
                results.append(None)
            else:
                r = rows[offs[i] : offs[i + 1]]
                results.append(r if self._multi else r[0])
        if single:
            return results[0]
        if not self._multi and all(r is not None for r in results):
            return np.stack(results) if results else np.zeros((0, self._ndim), np.float32)
        return tuple(results)

    def __getitem__(self, keys):
        return self.get(keys)

    def _fetch_slots(self, slots, out_kind: ScalarKind) -> np.ndarray:
        """The rows at ``slots`` decoded to ``out_kind``, ``[n, ndim]`` on
        the host (packed bytes for b1 out of a b1 index; a set index's
        int32 rows as they are)."""
        if self._host_f64 is not None:
            exact = self._host_f64[np.asarray(slots, dtype=np.int64)]
            if out_kind in _F64_OUT:
                return exact.astype(_F64_OUT[out_kind])
            return cast_rows(torch.from_numpy(exact), ScalarKind.F64, out_kind).numpy()
        stored = self._stored_rows(slots)
        if self._is_set_index:
            return stored[:, : self._ndim].cpu().numpy()
        if self._dtype == ScalarKind.B1:
            packed = stored[:, : self._columns(ScalarKind.B1)].cpu().numpy()
            if out_kind == ScalarKind.B1:
                return packed
            return unpack_bits_np(packed, self._ndim).astype(_NUMPY_DTYPES[out_kind])
        return cast_rows(stored[:, : self._ndim], self._dtype, out_kind).cpu().numpy()

    def _stored_rows(self, slots) -> torch.Tensor:
        """The stored rows at ``slots``, ``[n, width]`` on the index's
        device: gathered from the table, or read from a streamed view's map
        (so both decode on one device, with the same rounding)."""
        if self._streamed:
            rows = torch.from_numpy(np.ascontiguousarray(self._stream_rows[np.asarray(slots, dtype=np.int64)]))
            if self._dtype == ScalarKind.BF16:
                rows = rows.view(torch.bfloat16)  # a file holds bf16 as its bits
            pad = -1 if self._is_set_index else 0
            return torch.nn.functional.pad(rows, (0, self._width - rows.shape[1]), value=pad).to(self._device)
        return self._table[torch.as_tensor(slots, dtype=torch.long, device=self._device)]

    @_mutates
    def remove(self, keys, *, compact: bool = False, threads: int = 0):
        """Unlink keys; their slots are reused by later adds."""
        self._refuse_if_viewed("remove from")
        single = np.isscalar(keys)
        keys_np = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
        counts = np.zeros(len(keys_np), dtype=np.uint64)
        freed: List[int] = []
        for i, key in enumerate(keys_np.tolist()):
            slots = self._keymap.pop(key)
            counts[i] = len(slots)
            freed.extend(slots)
        if freed:
            self._valid[torch.as_tensor(freed, device=self._device)] = False
            self._free_slots.extend(freed)
            self._count -= len(freed)
            # deletions keep the IVF: its probes read the validity mask
            if self._ivf is not None and not self._ivf_dirty:
                self._ivf.remove_fresh(freed)
            if compact:
                self.compact()
        return int(counts[0]) if single else counts

    def __delitem__(self, keys):
        return self.remove(keys)

    @_mutates
    def rename(self, from_: int, to: int) -> bool:
        """Move a key's rows to another key (a host-side keymap move)."""
        self._refuse_if_viewed("rename in")
        slots = self._keymap.pop(int(from_))
        if not slots:
            return False
        if not self._multi and self._keymap.contains(int(to)):
            self._keymap.insert_many(np.full(len(slots), int(from_), dtype=np.uint64), np.asarray(slots))
            return False
        self._keymap.insert_many(np.full(len(slots), int(to), dtype=np.uint64), np.asarray(slots))
        self._slot_keys[np.asarray(slots)] = np.uint64(to)
        return True

    @_mutates
    def compact(self) -> int:
        """Pack live rows to the front of the table; returns the live count."""
        self._refuse_if_viewed("compact")
        live = self._live_slots()
        count = len(live)
        if count < self._next_slot:
            src = torch.as_tensor(live, device=self._device)
            self._table[:count] = self._table[src]
            self._stats[:count] = self._stats[src]
            self._valid.copy_(torch.arange(self._capacity, device=self._device) < count)
            keys = self._slot_keys[live].copy()
            self._slot_keys[:] = 0
            self._slot_keys[:count] = keys
            if self._host_f64 is not None:
                rows = self._host_f64[live].copy()
                self._host_f64[:] = 0
                self._host_f64[:count] = rows
            self._keymap = KeyMap(multi=self._multi)
            self._keymap.insert_many(keys, np.arange(count))
        self._free_slots = []
        self._next_slot = count
        self._ivf_dirty = True
        self._generation += 1
        return count

    @_mutates
    def clear(self) -> None:
        """Erase all rows; keep settings and capacity (a streamed view lets
        go of its map)."""
        if self._valid is not None:
            self._valid.zero_()
        if self._streamed:
            self._streamed, self._stream_rows, self._capacity = False, None, 0
        self._keymap = KeyMap(multi=self._multi)
        self._free_slots = []
        self._next_slot = 0
        self._count = 0
        self._ivf = None
        self._ivf_dirty = True
        self._generation += 1

    @_mutates
    def reset(self) -> None:
        """Erase all rows and free the device memory."""
        self._reset_state()

    def fork(self) -> "Index":
        """An empty index of the same configuration (its user-defined
        metric too)."""
        metric = self._metric_kind
        if self._metric_fn is not None:
            metric = CompiledMetric(self._metric_fn, self._metric_kind)
        return Index(
            ndim=self._ndim,
            metric=metric,
            dtype=None if self._is_set_index else self._dtype,
            connectivity=self._connectivity,
            expansion_add=self._expansion_add,
            expansion_search=self._expansion_search,
            multi=self._multi,
            device=self._device,
        )

    @_reads
    def copy(self) -> "Index":
        """An index of the same configuration and rows (a streamed view's
        rows loaded onto the device)."""
        other = self.fork()
        if self._streamed:
            from .persist import load_streamed_rows

            load_streamed_rows(self, other)
        elif self._capacity:
            other._install(
                self._table.clone(), self._stats.clone(), self._valid.clone(), self._slot_keys.copy(),
                self._count, self._next_slot, self._free_slots, keymap=self._keymap.copy(),
                host_f64=self._host_f64,
            )
        return other

    def _install(self, table, stats, valid, slot_keys, count, next_slot, free_slots, keymap=None,
                 host_f64=None) -> None:
        """Take over a whole state; the keymap is rebuilt from the live slots
        unless one is given. An f64 index takes ``host_f64 [capacity, ndim]``
        (a copy is kept), else its host copy is the table's f32 rows."""
        capacity, width = table.shape
        if width != self._width or stats.shape != (capacity, 2) or valid.shape != (capacity,):
            raise ValueError(f"state of shape {tuple(table.shape)} does not fit width {self._width}")
        self._table = table.to(self._device, self._torch_dtype)
        self._stats = stats.to(self._device, torch.float32)
        self._valid = valid.to(self._device, torch.bool)
        self._capacity = capacity
        self._slot_keys = np.asarray(slot_keys, dtype=np.uint64).copy()
        self._next_slot = int(next_slot)
        self._free_slots = [int(s) for s in free_slots]
        if keymap is None:
            keymap = KeyMap(multi=self._multi)
            live = self._live_slots()
            keymap.insert_many(self._slot_keys[live], live)
        self._keymap = keymap
        self._count = int(count)
        if len(self._keymap) != self._count:
            raise ValueError(f"count {self._count} disagrees with {len(self._keymap)} live rows")
        if self._dtype == ScalarKind.F64:
            exact = self._table[:, : self._ndim].double().cpu().numpy() if host_f64 is None else host_f64
            self._host_f64 = np.array(exact, dtype=np.float64)
            if self._host_f64.shape != (capacity, self._ndim):
                raise ValueError(f"host_f64 of shape {self._host_f64.shape} does not fit ({capacity}, {self._ndim})")
        self._ivf = None
        self._ivf_dirty = True
        self._generation += 1

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def _ivf_serveable(self) -> bool:
        """A built IVF that no later change outdated, of a (metric, dtype)
        the probes serve: b1 tables only the binary probe metrics; every
        other pairing probes (the metric tail and user-defined metrics
        score their gathered candidates)."""
        if self._ivf is None or self._ivf_dirty:
            return False
        from .ivf import BINARY_PROBE_METRICS

        return self._dtype != ScalarKind.B1 or self._metric_kind in BINARY_PROBE_METRICS

    @_reads
    def search(self, vectors, count: int = 10, radius: float = math.inf, *, threads: int = 0,
               exact: bool = False, log=False, progress: Optional[Callable[[int, int], bool]] = None,
               filter=None) -> Union[Matches, BatchMatches]:
        """k-NN search: through the IVF after `optimize`, else approximate
        from 131,072 rows on, unless ``exact``; a streamed view scans
        exactly. ``filter`` is a key predicate (vectorized over a key array,
        or per key) or an allow-list of keys."""
        return self._search_dispatch(vectors, count, radius, exact, filter, progress=progress).result()

    def search_async(self, vectors, count: int = 10, radius: float = math.inf, *, exact: bool = False,
                     filter=None) -> PendingSearch:
        """`search` without waiting for its result: the search is enqueued
        on the device and its `PendingSearch` returned, whose ``result()``
        gives what `search` would. Searches in flight overlap on the device
        with the host work of the next dispatch. The read lock is held
        until ``result()`` (mutations wait for it).

        Two kinds of dispatch wait on the device before they return. A
        streamed view's copies its rows tile by tile from the map on the
        host, each fill waiting for the upload two tiles back (stream.py),
        so it returns near the end of the search. A filter object's first
        dispatch per index version reads the validity mask to the host to
        map keys to slots (`_filter_mask`); later ones reuse the mask."""
        token = self._rwlock.acquire_read()
        try:
            return self._search_dispatch(vectors, count, radius, exact, filter, lock_token=token)
        except BaseException:
            self._rwlock.release_read(token)
            raise

    def _search_dispatch(self, vectors, count, radius, exact, filter, lock_token=None,
                         progress=None) -> PendingSearch:
        """Prepare the queries and enqueue the search; the caller holds the
        read lock (``lock_token`` hands it to the `PendingSearch`)."""
        dev_rows, kind = self._device_rows(vectors)
        if dev_rows is None:
            vectors = np.asarray(vectors)
            single = vectors.ndim == 1
            host, kind = self._host_rows(vectors)
            n_q = host.shape[0]
        else:
            single = vectors.dim() == 1
            n_q = dev_rows.shape[0]
        if self._count == 0 or count <= 0:
            return PendingSearch(self, None, None, n_q, single, radius, 0, lock_token, progress)
        if dev_rows is not None:
            q = self._cast_device(dev_rows, kind)
        else:
            q = self._prepare_host(host, kind)
        k = min(int(count), self._count)
        if self._streamed:
            d, slots = self._streamed_topk(q, k, filter)
            return PendingSearch(self, d, slots, n_q, single, radius, self._count, lock_token, progress)
        valid = self._valid if filter is None else self._filter_mask(filter)
        approx, use_ivf = self._route(exact)
        d, slots, scanned = self._search_prepared(q, k, valid, approx, use_ivf)
        return PendingSearch(self, d, slots, n_q, single, radius, scanned, lock_token, progress)

    def _route(self, exact: bool):
        """``(approx, use_ivf)`` of a search: through the IVF when one serves
        and not ``exact``, else approximate from `APPROX_MIN_ROWS` rows on."""
        use_ivf = not exact and self._ivf_serveable()
        approx = (not exact and not use_ivf and not self._is_set_index and self._metric_fn is None
                  and self._count >= APPROX_MIN_ROWS)
        return approx, use_ivf

    def _padded_queries(self, q: torch.Tensor, upload: bool = True) -> torch.Tensor:
        """Prepared queries padded to `pad_queries` rows, on the device; the
        pads are copies of the first query, as in the JAX package (they
        probe the same partitions). A host batch is uploaded from pinned
        memory without waiting (``upload=False``: left pinned on the host,
        for a graph's static input)."""
        n_q = q.shape[0]
        q_pad = pad_queries(n_q)
        if q_pad > n_q:
            q = torch.cat([q, q[:1].expand(q_pad - n_q, -1)])
        if q.device.type == "cpu" and self._device.type == "cuda":
            q = q.pin_memory()
            return q.to(self._device, non_blocking=True) if upload else q
        return q.to(self._device)

    def _search_plan(self, n_q: int, k: int, valid, approx: bool, use_ivf: bool):
        """The host's part of a search of ``n_q`` padded queries: ``(key,
        body, rows scanned per query)``, ``body(q, valid)`` its device part
        (``[Q, k]`` distances and slots), ``key`` every host decision the
        body takes, or None where it stays eager on the card
        (`graphs.EAGER`)."""
        if use_ivf:
            key, body = self._ivf.plan(self, n_q, valid, k, self._expansion_search)
            return key, body, self._ivf.scanned_rows(self._expansion_search, self._connectivity)
        metric, kind, table, stats, ndim, fn = (self._metric_kind, self._kind, self._table, self._stats, self._ndim,
                                                self._metric_fn)
        tile_rows = pick_tile_rows(self._capacity, self._width * table.element_size(), metric, ndim, n_q, fn)
        while self._capacity % tile_rows:
            tile_rows //= 2

        def body(q, valid):
            return search_kernel(metric, kind, q, table, stats, valid, ndim, k, tile_rows, approx, fn)

        key = None
        if kernel_tiles(metric, kind, n_q, self._capacity, k, approx, fn) is not None:
            key = ("flat", approx, tile_rows)
        elif bitscan.serves(metric, kind, k, fn):
            key = ("bitscan", approx, tile_rows)
        return key, body, self._count

    def _search_prepared(self, q: torch.Tensor, k: int, valid, approx: bool, use_ivf: bool = False):
        """``(distances, slots, rows scanned per query)`` of prepared queries:
        on the card through the captured graph of the search's key where
        its path is captured (graphs.py), else eagerly."""
        n_q = pad_queries(q.shape[0])
        key, body, scanned = self._search_plan(n_q, k, valid, approx, use_ivf)
        if key is None or self._graphs is None:  # no cache off the card
            d, slots = body(self._padded_queries(q), valid)
            return d, slots, scanned
        own = valid is self._valid
        key = key + (self._metric_kind, self._kind, n_q, k, not own)
        if own:
            run, args = (lambda qq: body(qq, valid)), (self._padded_queries(q, upload=False),)
        else:  # a filter's mask: copied into the graph's static mask
            run, args = body, (self._padded_queries(q, upload=False), valid)
        iv = self._ivf
        generation = (self._generation, None if iv is None else (iv.serial, iv.generation))
        d, slots = self._graphs.run(key, generation, run, args)
        return d, slots, scanned

    def _finish_search(self, d, slots, n_q, single, radius, scanned, progress):
        """Slots to keys, radius cut, and the result containers."""
        d, slots = d[:n_q], slots[:n_q]
        found = slots >= 0
        if radius is not None and radius != math.inf:
            found &= d <= radius
        keys = np.where(found, self._slot_keys[np.clip(slots, 0, None)], 0).astype(np.uint64)
        counts = found.sum(axis=1).astype(np.uint64)
        if progress is not None:
            progress(n_q, n_q)
        if single:
            c = int(counts[0])
            return Matches(keys=keys[0, :c], distances=d[0, :c].astype(np.float32),
                           visited_members=int(scanned), computed_distances=int(scanned))
        return BatchMatches(keys=keys, distances=d.astype(np.float32), counts=counts,
                            visited_members=int(scanned) * n_q, computed_distances=int(scanned) * n_q)

    def _streamed_topk(self, q: torch.Tensor, k: int, filter):
        """Exact top-k of prepared queries against a streamed view's rows."""
        from .stream import streamed_search

        keys = self._slot_keys[: self._count]
        host_valid = None if filter is None else _admitted(filter, keys)
        return streamed_search(self._metric_kind, self._kind, self._padded_queries(q), self._stream_rows,
                               self._ndim, k, host_valid, self._metric_fn, -1 if self._is_set_index else 0)

    def _filter_mask(self, filter) -> torch.Tensor:
        """A key filter as a slot mask composed with deletions, cached on
        (filter object, index version)."""
        hit = self._filter_cache.get(id(filter))
        if hit is not None and hit[0] == self._version and hit[1] is filter:
            return hit[2]
        live = self._live_slots()
        allowed = np.zeros(self._capacity, dtype=bool)
        allowed[live] = _admitted(filter, self._slot_keys[live])
        mask = self._valid & torch.as_tensor(allowed, device=self._device)
        if len(self._filter_cache) >= 8:
            self._filter_cache.pop(next(iter(self._filter_cache)))
        self._filter_cache[id(filter)] = (self._version, filter, mask)
        return mask

    def _bulk_install_streamed(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """A streamed view's state: the key map over slots ``0..count``,
        and ``rows`` (the file's map) in place of a device table."""
        count = len(keys)
        self._streamed = True
        self._stream_rows = rows
        self._capacity = count
        self._slot_keys = np.asarray(keys, dtype=np.uint64).copy()
        self._keymap.insert_many(self._slot_keys, np.arange(count, dtype=np.int64))
        self._next_slot = count
        self._count = count

    # ------------------------------------------------------------------
    # IVF
    # ------------------------------------------------------------------

    @_mutates
    def optimize(self, n_partitions: Optional[int] = None, reorder: bool = False, spill: float = 0.0) -> None:
        """Build the IVF: k-means partitions of the live rows, probed by
        later non-exact searches (``expansion_search`` sets how many).

        ``reorder=True`` permutes the table itself into cluster-major order
        (slots change, keys do not) and costs no second copy of the rows;
        the default keeps a partition-contiguous copy. ``spill`` (0..1):
        that share of the rows, those nearest a second centroid, is also
        stored in that centroid's partition (SOAR)."""
        from .ivf import IVFPartitions

        if self._streamed:
            raise RuntimeError("Can't optimize a streamed view: its rows stay in the file")
        if self._count == 0:
            return
        build = IVFPartitions.build_inplace if reorder else IVFPartitions.build
        self._ivf = build(self, n_partitions, spill=spill)
        self._ivf_dirty = False
        self._generation += 1

    @_reads
    def pairwise_distance(self, left, right) -> Union[np.ndarray, float]:
        """Distances between the rows of keys ``left[i]`` and ``right[i]``
        (each key's first row under ``multi``)."""
        single = np.isscalar(left)
        left_np = np.atleast_1d(np.asarray(left, dtype=np.uint64))
        right_np = np.atleast_1d(np.asarray(right, dtype=np.uint64))
        slots = [[self._keymap.slots_of(k)[0] for k in side.tolist()] for side in (left_np, right_np)]
        rows_l, rows_r = (self._stored_rows(sl) for sl in slots)
        if self._metric_fn is not None:
            d = torch.func.vmap(self._metric_fn)(rows_l.float(), rows_r.float()).float().cpu().numpy()
        else:
            d = pair_dists(self._metric_kind, self._kind, rows_l, rows_r, self._ndim).cpu().numpy()
        return float(d[0]) if single else d

    def distance_between(self, left, right):
        return self.pairwise_distance(left, right)

    # ------------------------------------------------------------------
    # Persistence (persist.py)
    # ------------------------------------------------------------------

    @property
    def serialized_length(self) -> int:
        """The exact byte length of `save`'s buffer."""
        from .persist import serialized_length

        return serialized_length(self)

    def _logical_row_bytes(self) -> int:
        if self._dtype == ScalarKind.B1:
            return (self._ndim + 7) // 8
        if self._dtype == ScalarKind.F64:
            return self._ndim * 8
        return self._ndim * self._torch_dtype.itemsize

    @_reads
    def save(self, path_or_buffer=None, progress=None, format: str = "native"):
        """Write the index: ``format="native"`` in the JAX package's file
        format (both packages read it), ``"reference"`` as an upstream
        `.usearch` file (rows, keys and a flat graph). Without a path (and
        no path of its own) it returns the bytes."""
        from .persist import save_index, save_index_to_buffer, save_reference_index

        if format == "reference":
            return save_reference_index(self, path_or_buffer)
        if format != "native":
            raise ValueError(f"unknown save format {format!r}")
        if path_or_buffer is None:
            path_or_buffer = self._path
        if path_or_buffer is None:
            return save_index_to_buffer(self)
        if isinstance(path_or_buffer, (bytes, bytearray, memoryview)):
            raise ValueError("save to an existing buffer isn't supported; pass a path or None")
        save_index(self, str(path_or_buffer))
        self._path = str(path_or_buffer)

    @_mutates
    def load(self, path_or_buffer=None, progress=None):
        """Replace the index by a file's or buffer's (native or upstream
        format), with its built IVF where the file holds one."""
        from .persist import load_index_from_buffer, load_index_into

        if path_or_buffer is None:
            path_or_buffer = self._path
        if isinstance(path_or_buffer, (bytes, bytearray, memoryview)):
            load_index_from_buffer(self, path_or_buffer)
        else:
            load_index_into(self, str(path_or_buffer), view=False)
            self._path = str(path_or_buffer)

    @_mutates
    def view(self, path_or_buffer=None, progress=None, stream: Optional[bool] = None):
        """`load` from a memory map of the file, and refuse changes after.
        The rows go to the device whole, unless ``stream=True``, or
        ``stream=None`` with rows above `persist.STREAM_SHARE` of the
        device's memory: then they stay in the map, and searches stream
        them through the device (stream.py)."""
        from .persist import load_index_from_buffer, load_index_into

        if path_or_buffer is None:
            path_or_buffer = self._path
        if isinstance(path_or_buffer, (bytes, bytearray, memoryview)):
            if stream:
                raise ValueError("streamed view needs a file path (mmap), not a buffer")
            load_index_from_buffer(self, path_or_buffer)
        else:
            load_index_into(self, str(path_or_buffer), view=True, stream=stream)
            self._path = str(path_or_buffer)
        self._viewed = True

    @staticmethod
    def metadata(path_or_buffer) -> Optional[dict]:
        """A file's or buffer's configuration, read without its rows; None
        when it is not an index."""
        from .persist import index_metadata

        try:
            return index_metadata(path_or_buffer)
        except (OSError, ValueError, KeyError, TypeError, struct.error):  # not an index, or cut short
            return None

    @staticmethod
    def restore(path_or_buffer, view: bool = False, stream: Optional[bool] = None, **kwargs) -> Optional["Index"]:
        """A new index from a file or buffer (``kwargs`` go to `Index`,
        ``device`` among them); None when it is not an index."""
        meta = Index.metadata(path_or_buffer)
        if not meta:
            return None
        index = Index(ndim=meta["dimensions"], metric=meta["metric"], dtype=meta["dtype"], multi=meta["multi"],
                      **kwargs)
        if view:
            index.view(path_or_buffer, stream=stream)
        else:
            index.load(path_or_buffer)
        return index

    # ------------------------------------------------------------------
    # Clustering and joins (cluster.py, join.py)
    # ------------------------------------------------------------------

    def cluster(self, *, vectors=None, keys=None, min_count: Optional[int] = None, max_count: Optional[int] = None,
                threads: int = 0, log=False, progress=None) -> Clustering:
        """k-means over the live rows, the cluster count within
        ``[min_count, max_count]``; each cluster is named by its nearest
        member's key. Queries are ``vectors``, the members ``keys``, or all
        members."""
        from .cluster import cluster_index

        return cluster_index(self, vectors=vectors, keys=keys, min_count=min_count, max_count=max_count)

    def join(self, other: "Index", max_proposals: int = 0, exact: bool = False, progress=None) -> Dict[int, int]:
        """A one-to-one stable matching of this index's keys to ``other``'s
        (the smaller index proposes)."""
        from .join import join

        return join(self, other, max_proposals=max_proposals, exact=exact)


def _admitted(filter, keys: np.ndarray) -> np.ndarray:
    """Which of ``keys`` a filter admits: a key predicate, vectorized over
    the key array or called per key, or an allow-list of keys."""
    if not callable(filter):
        return np.isin(keys, np.asarray(filter, dtype=np.uint64))
    if len(keys) == 0:
        return np.zeros(0, dtype=bool)
    try:  # vectorized contract: a bool array over the key array
        out = np.asarray(filter(keys))
        if out.shape == keys.shape and out.dtype != object:
            return out.astype(bool)
    except Exception:  # a per-key predicate; the loop below
        pass
    return np.fromiter((bool(filter(int(k))) for k in keys), dtype=bool, count=len(keys))


class IndexedKeys:
    """Lazy view of the live keys."""

    def __init__(self, index: Index) -> None:
        self.index = index

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i):
        return self.index._live_keys()[i]

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        keys = self.index._live_keys()
        return keys if dtype is None else keys.astype(dtype)

    def __iter__(self):
        return iter(self.index._live_keys())
