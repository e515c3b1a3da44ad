"""`Index`: the vector index on a device.

Counterpart of `usearch_tpu/index.py`. Rows live in a capacity-padded table
on the device, beside per-row stats and a validity mask; deleted rows are
masked inside the scan kernels, and their slots are reused by later adds.
Search pads queries to a power of two. Without an IVF it goes through
`exact.search_kernel`: approximate (one candidate per 128-row bin) from
131,072 rows on, exact below that or with ``exact=True``. After
`optimize`, non-exact searches probe the IVF partitions (ivf.py); rows added
later join its fresh list, scanned exactly, until the next `optimize`.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from .enums import (
    DEFAULT_CONNECTIVITY,
    DEFAULT_EXPANSION_ADD,
    DEFAULT_EXPANSION_SEARCH,
    ScalarKind,
    MetricKind,
    is_ported,
    kind_of_dtype,
    normalize_dtype,
    normalize_metric,
    to_torch_dtype,
)
from .exact import pad_queries, pad_rows, pick_tile_rows, prepare_rows, resolve_device, search_kernel, storage_width
from .keymap import KeyMap
from .matches import BatchMatches, Matches
from .ops.casts import cast_rows
from .ops.distances import row_stats
from .ops.packbits import unpack_bits_np

#: capacity quantum in rows
ROW_TILE = 1024
#: non-exact searches of tables with this many rows go approximate
APPROX_MIN_ROWS = 131072
#: host batches of at least two such chunks are cast and copied chunk by chunk
INGEST_CHUNK = 131072
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


def _todo(item: str):
    """A name of the JAX package not ported yet: calling it raises naming
    its ROADMAP item (kept on it as ``roadmap``)."""

    def method(*args, **kwargs):
        raise NotImplementedError(f"not ported yet (ROADMAP queue {item})")

    method.roadmap = item
    return method


def _todo_class(name: str, item: str) -> type:
    """A class of the JAX package not ported yet: constructing it raises."""
    return type(name, (), {"__init__": _todo(item), "roadmap": item,
                           "__doc__": f"Not ported yet (ROADMAP queue {item})."})


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
        if callable(metric) and not isinstance(metric, (str, MetricKind)):
            raise NotImplementedError("user-defined metrics are not ported yet (ROADMAP queue A.7b)")
        self._metric_kind = normalize_metric(metric)
        self._dtype = normalize_dtype(dtype, ndim=ndim, metric=self._metric_kind)
        if self._dtype == ScalarKind.F64 or not is_ported(self._metric_kind, self._dtype):
            raise NotImplementedError(
                f"{self._metric_kind.value}/{self._dtype.value} is not ported yet (ROADMAP queue A.7b)"
            )
        if path is not None or view:
            raise NotImplementedError("persistence is not ported yet (ROADMAP queue A.6)")
        if ndim <= 0:
            raise ValueError("ndim must be positive")
        self._device = resolve_device(device)
        self._ndim = int(ndim)
        self._width = storage_width(self._dtype, self._ndim)
        self._torch_dtype = to_torch_dtype(self._dtype)
        self._connectivity = int(connectivity)
        self._expansion_add = int(expansion_add)
        self._expansion_search = int(expansion_search)
        self._multi = bool(multi)
        self._rwlock = _RWLock()
        self._version = 0
        self._filter_cache: dict = {}
        self._reset_state()

    def _reset_state(self) -> None:
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

    metric = metric_kind

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
    def memory_usage(self) -> int:
        """Device bytes of the table, stats and mask, plus the host keys."""
        if self._capacity == 0:
            return 0
        row = self._width * self._table.element_size() + 8 + 1
        return self._capacity * row + self._slot_keys.nbytes

    @property
    def keys(self) -> "IndexedKeys":
        return IndexedKeys(self)

    def _live_slots(self) -> np.ndarray:
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
        if self._table is None:
            self._table, self._stats, self._valid = table, stats, valid
        else:
            self._table = torch.cat([self._table, table])
            self._stats = torch.cat([self._stats, stats])
            self._valid = torch.cat([self._valid, valid])
        self._slot_keys = np.concatenate([self._slot_keys, np.zeros(extra, dtype=np.uint64)])
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

    def _device_rows(self, vectors):
        """A tensor argument as ``([B, columns] rows on the index's device,
        their kind)``, or ``(None, None)`` for host (numpy) input."""
        if not isinstance(vectors, torch.Tensor):
            return None, None
        kind = kind_of_dtype(vectors.dtype)
        rows = vectors if vectors.dim() == 2 else vectors.reshape(1, -1)
        if rows.dim() != 2 or rows.shape[1] != self._columns(kind):
            raise ValueError(f"Expected {self._columns(kind)} columns for {kind.value} input, "
                             f"got {tuple(vectors.shape)}")
        return rows.to(self._device), kind

    def _host_rows(self, vectors: np.ndarray):
        """``(rows [B, columns], kind)`` of a host batch."""
        rows = np.atleast_2d(vectors)
        kind = kind_of_dtype(rows.dtype)
        if rows.ndim != 2 or rows.shape[1] != self._columns(kind):
            raise ValueError(f"Expected {self._columns(kind)} columns for {kind.value} input, got {rows.shape}")
        return rows, kind

    def _cast_device(self, rows: torch.Tensor, kind: ScalarKind) -> torch.Tensor:
        """Device-side cast and zero-pad to the stored width."""
        rows = cast_rows(rows, kind, self._dtype, self._ndim)
        return torch.nn.functional.pad(rows, (0, self._width - rows.shape[1]))

    def _scatter(self, slots: torch.Tensor, rows: torch.Tensor) -> None:
        """Write rows, their stats and validity at ``slots``. In place:
        ``index_copy_`` updates the existing table, so an add never copies
        the table."""
        self._table.index_copy_(0, slots, rows)
        self._stats.index_copy_(0, slots, row_stats(rows, self._dtype))
        self._valid.index_fill_(0, slots, True)

    @_mutates
    def add(self, keys, vectors, *, copy: bool = True, threads: int = 0, log=False,
            progress: Optional[Callable[[int, int], bool]] = None):
        """Add rows under ``keys`` (None: consecutive keys after the largest).
        ``vectors`` is a numpy batch (cast on the host) or a tensor (moved to
        the index's device and cast there)."""
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

        if dev_rows is not None:
            self._scatter(slots_dev, self._cast_device(dev_rows, kind))
            if progress is not None:
                progress(n, n)
        else:
            chunk = INGEST_CHUNK if n >= 2 * INGEST_CHUNK else max(n, 1)
            for off in range(0, n, chunk):
                rows = prepare_rows(host[off : off + chunk], kind, self._dtype, self._ndim)
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
        to 0/1 values otherwise."""
        out_kind = ScalarKind.F32 if dtype is None else normalize_dtype(dtype, metric=self._metric_kind)
        if out_kind not in tuple(_NUMPY_DTYPES) + ((ScalarKind.B1,) if self._dtype == ScalarKind.B1 else ()):
            raise ValueError(f"get() returns f64/f32/f16/i8 arrays, not {out_kind.value}")
        single = np.isscalar(keys)
        slot_lists = [self._keymap.slots_of(k) for k in np.atleast_1d(np.asarray(keys, dtype=np.uint64)).tolist()]
        flat = [s for sl in slot_lists for s in sl]
        results = []
        if flat:
            idx = torch.as_tensor(flat, device=self._device)
            if self._dtype == ScalarKind.B1:
                packed = self._table[idx, : self._columns(ScalarKind.B1)].cpu().numpy()
                rows = packed if out_kind == ScalarKind.B1 else (
                    unpack_bits_np(packed, self._ndim).astype(_NUMPY_DTYPES[out_kind]))
            else:
                rows = cast_rows(self._table[idx, : self._ndim], self._dtype, out_kind).cpu().numpy()
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

    @_mutates
    def remove(self, keys, *, compact: bool = False, threads: int = 0):
        """Unlink keys; their slots are reused by later adds."""
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
            self._keymap = KeyMap(multi=self._multi)
            self._keymap.insert_many(keys, np.arange(count))
        self._free_slots = []
        self._next_slot = count
        self._ivf_dirty = True
        return count

    @_mutates
    def clear(self) -> None:
        """Erase all rows; keep settings and capacity."""
        if self._capacity:
            self._valid.zero_()
        self._keymap = KeyMap(multi=self._multi)
        self._free_slots = []
        self._next_slot = 0
        self._count = 0
        self._ivf = None
        self._ivf_dirty = True

    @_mutates
    def reset(self) -> None:
        """Erase all rows and free the device memory."""
        self._reset_state()

    def fork(self) -> "Index":
        """An empty index of the same configuration."""
        return Index(
            ndim=self._ndim,
            metric=self._metric_kind,
            dtype=self._dtype,
            connectivity=self._connectivity,
            expansion_add=self._expansion_add,
            expansion_search=self._expansion_search,
            multi=self._multi,
            device=self._device,
        )

    @_reads
    def copy(self) -> "Index":
        other = self.fork()
        if self._capacity:
            other._install(
                self._table.clone(), self._stats.clone(), self._valid.clone(), self._slot_keys.copy(),
                self._count, self._next_slot, self._free_slots, keymap=self._keymap.copy(),
            )
        return other

    def _install(self, table, stats, valid, slot_keys, count, next_slot, free_slots, keymap=None) -> None:
        """Take over a whole state; the keymap is rebuilt from the live slots
        unless one is given."""
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
        self._ivf = None
        self._ivf_dirty = True

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def _ivf_serveable(self) -> bool:
        """A built IVF that no later change outdated, of a (metric, dtype)
        the probes serve: b1 tables only the binary probe metrics."""
        if self._ivf is None or self._ivf_dirty:
            return False
        from .ivf import BINARY_PROBE_METRICS

        return self._dtype != ScalarKind.B1 or self._metric_kind in BINARY_PROBE_METRICS

    @_reads
    def search(self, vectors, count: int = 10, radius: float = math.inf, *, threads: int = 0,
               exact: bool = False, log=False, progress: Optional[Callable[[int, int], bool]] = None,
               filter=None) -> Union[Matches, BatchMatches]:
        """k-NN search: through the IVF after `optimize`, else approximate
        from 131,072 rows on, unless ``exact``. ``filter`` is a key predicate
        (vectorized over a key array, or per key) or an allow-list of keys."""
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
            return self._finish_search(
                np.zeros((n_q, 0), np.float32), np.zeros((n_q, 0), np.int64), n_q, single, radius, 0, progress
            )
        if dev_rows is not None:
            q = self._cast_device(dev_rows, kind)
        else:
            q = prepare_rows(host, kind, self._dtype, self._ndim)
        k = min(int(count), self._count)
        valid = self._valid if filter is None else self._filter_mask(filter)
        use_ivf = not exact and self._ivf_serveable()
        approx = not exact and not use_ivf and self._count >= APPROX_MIN_ROWS
        d, slots, scanned = self._search_prepared(q, k, valid, approx, use_ivf)
        return self._finish_search(d.cpu().numpy(), slots.cpu().numpy(), n_q, single, radius, scanned, progress)

    def _search_prepared(self, q: torch.Tensor, k: int, valid, approx: bool, use_ivf: bool = False):
        """``(distances, slots, rows scanned per query)`` of prepared queries."""
        n_q = q.shape[0]
        q_pad = pad_queries(n_q)
        if q_pad > n_q:
            # pads are copies of the first query, as in the JAX package: they
            # probe the same partitions
            q = torch.cat([q, q[:1].expand(q_pad - n_q, -1)])
        q = q.to(self._device)
        if use_ivf:
            d, slots = self._ivf.search(self, q, valid, k, self._expansion_search)
            return d, slots, self._ivf.scanned_rows(self._expansion_search, self._connectivity)
        tile_rows = pick_tile_rows(self._capacity, self._width * self._table.element_size())
        while self._capacity % tile_rows:
            tile_rows //= 2
        d, slots = search_kernel(
            self._metric_kind, self._dtype, q, self._table, self._stats, valid, self._ndim, k, tile_rows, approx
        )
        return d, slots, self._count

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

    def _filter_mask(self, filter) -> torch.Tensor:
        """A key filter as a slot mask composed with deletions, cached on
        (filter object, index version)."""
        hit = self._filter_cache.get(id(filter))
        if hit is not None and hit[0] == self._version and hit[1] is filter:
            return hit[2]
        live = self._live_slots()
        keys_live = self._slot_keys[live]
        allowed = np.zeros(self._capacity, dtype=bool)
        if callable(filter):
            res = None
            if len(live):
                try:  # vectorized contract: a bool array over the key array
                    out = np.asarray(filter(keys_live))
                    if out.shape == keys_live.shape and out.dtype != object:
                        res = out.astype(bool)
                except Exception:  # a per-key predicate; fall back to the loop below
                    res = None
                if res is None:
                    res = np.fromiter((bool(filter(int(k))) for k in keys_live), dtype=bool, count=len(live))
                allowed[live] = res
        else:
            allowed[live] = np.isin(keys_live, np.asarray(filter, dtype=np.uint64))
        mask = self._valid & torch.as_tensor(allowed, device=self._device)
        if len(self._filter_cache) >= 8:
            self._filter_cache.pop(next(iter(self._filter_cache)))
        self._filter_cache[id(filter)] = (self._version, filter, mask)
        return mask

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

        if self._count == 0:
            return
        build = IVFPartitions.build_inplace if reorder else IVFPartitions.build
        self._ivf = build(self, n_partitions, spill=spill)
        self._ivf_dirty = False

    # ------------------------------------------------------------------
    # Later slices
    # ------------------------------------------------------------------

    search_async = _todo("A.8")
    cluster = _todo("A.9")
    join = _todo("A.9")
    save = _todo("A.6")
    load = _todo("A.6")
    view = _todo("A.6")
    restore = staticmethod(_todo("A.6"))
    metadata = staticmethod(_todo("A.6"))
    serialized_length = property(_todo("A.6"))
    pairwise_distance = _todo("A.3c")
    distance_between = _todo("A.3c")
    stats_object = _todo("A.3c")
    level_stats = _todo("A.3c")
    levels_stats = property(_todo("A.3c"))
    specs = property(_todo("A.3c"))
    stats = property(_todo("A.3c"))
    vectors = property(_todo("A.3c"))
    max_level = property(_todo("A.3c"))
    nlevels = property(_todo("A.3c"))
    hardware_acceleration = property(_todo("A.3c"))
    jit = property(_todo("A.3c"))
    numpy_dtype = property(_todo("A.3c"))


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
