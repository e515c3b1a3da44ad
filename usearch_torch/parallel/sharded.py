"""Multi-device sharded search: a row-sharded table, replicated queries,
a top-k on every shard and one merge of their candidates.

Counterpart of `usearch_tpu/parallel/sharded.py`, in its layout: each shard
holds ``per_shard`` rows (a multiple of 8, a power of two past 65,536), a
slot's global id is ``shard * per_shard + row``, and the host keeps every
slot's key, a key map and a free list per shard, so both packages put a row
in the same slot and a JAX index's state or directory carries across.

- Each shard's table, stats and mask are tensors on its mesh device.
- An exact search runs `exact.search_steps` on every shard: kernel B2
  (`ops/scan.search_exact`) where `exact.kernel_tiles` admits the shard, the
  plain tiled scan elsewhere.
- After `optimize`, a probed search ranks each shard's own partition chunks
  and probes its ``nprobe`` best through `ivf.dense_probe`, the
  single-device index's gates: kernel B3, else, and whenever
  ``ivf.PROBE_MODE == "xla"``, the plain block-gather core
  (`ivf._dense_probe_core`), the JAX sharded path's own.
- Every shard is launched before any result is read; the exact searches'
  query chunks are launched a shard at a time in turn, so each device
  starts at once. The ``[Q, k]`` candidates, offset to global rows, come to
  the mesh's first device in shard order (and, across processes, through
  one `torch.distributed` all-gather, rank-major), and one stable top-k
  merges them, ties to the lower shard, as ``lax.top_k`` gives them.

Where the JAX package differs: its probe core keeps every window row, where
B3 keeps ``ivf.probe_bin_m`` per 128-row bin; its coarse selection is
``lax.top_k`` (here the stable top-k, the same order); it runs one program
over one device per shard, where a mesh here may put several shards on one
device; `reserve` keeps an IVF's shards a multiple of its gather block
(the JAX gather fails otherwise); `save` maps an IVF's windows to the
compacted rows it writes (the JAX package writes them as they were, so
rows removed after `optimize` shift the windows of a loaded index).
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import ivf
from ..enums import MetricKind, ScalarKind, kind_of_dtype, normalize_dtype, normalize_metric, to_torch_dtype
from ..exact import (kernel_tiles, pad_queries, pad_rows, pick_tile_rows, prepare_rows, run_steps, search_steps,
                     storage_width)
from ..graphs import MAX_GRAPHS, GraphCache
from ..index import Index
from ..keymap import KeyMap
from ..kmeans import kmeans_fit, kmeans_hierarchical
from ..matches import BatchMatches
from ..ops.casts import cast_rows
from ..ops.distances import MASKED, row_stats
from ..ops.topk import stable_topk
from ..persist import _load_arrays
from .mesh import SHARD_AXIS, Mesh, make_mesh

#: the metrics a sharded IVF serves
IVF_METRICS = (MetricKind.Cos, MetricKind.IP, MetricKind.L2sq)


def _as_rows(vectors, kind: ScalarKind, ndim: int) -> torch.Tensor:
    """A batch cast and zero-padded to the stored width: a tensor on its
    own device, a numpy batch on the host (a CPU tensor)."""
    if isinstance(vectors, torch.Tensor):
        rows = cast_rows(vectors, kind_of_dtype(vectors.dtype), kind, ndim)
        return torch.nn.functional.pad(rows, (0, storage_width(kind, ndim) - rows.shape[1]))
    return prepare_rows(vectors, kind_of_dtype(vectors.dtype), kind, ndim)


def _batch(vectors):
    """A 2-D batch: a tensor as it is, anything else as a numpy array."""
    if isinstance(vectors, torch.Tensor):
        return vectors.reshape(1, -1) if vectors.dim() == 1 else vectors
    return np.atleast_2d(np.asarray(vectors))


def _file_rows(rows: np.ndarray, kind: ScalarKind) -> torch.Tensor:
    """A file's rows (bf16 as its bits) as a CPU tensor of the stored dtype."""
    out = torch.from_numpy(np.array(rows))
    return out.view(torch.bfloat16) if kind == ScalarKind.BF16 else out


def _gather_objects(obj, mesh: Mesh) -> list:
    """``obj`` of every process of the mesh's group, in rank order."""
    if mesh.group is None:
        return [obj]
    out = [None] * mesh.world_size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


# ----------------------------------------------------------------------
# The searches and the merge
# ----------------------------------------------------------------------


def _replicate(q: torch.Tensor, devices) -> List[torch.Tensor]:
    """The queries on each shard's device, copied once a device."""
    copies = {}
    for dev in devices:
        if dev not in copies:
            copies[dev] = q.to(dev, non_blocking=True)
    return [copies[dev] for dev in devices]


def _interleave(steps: list) -> list:
    """Step generators (`exact.search_steps`) advanced a step each in turn
    until all are done: their results, in order."""
    out, live = [None] * len(steps), list(range(len(steps)))
    while live:
        for j in list(live):
            try:
                next(steps[j])
            except StopIteration as done:
                out[j] = done.value
                live.remove(j)
    return out


def _global_rows(i: torch.Tensor, offset: int) -> torch.Tensor:
    return torch.where(i >= 0, i + offset, -1).to(torch.int32)


def _all_gather_columns(d: torch.Tensor, i: torch.Tensor, mesh: Mesh):
    """Every process's ``[Q, c]`` candidates side by side, rank-major: one
    all-gather of distances and ids together (the ids' bits as f32). gloo
    takes the list form."""
    c = d.shape[1]
    both = torch.cat([d, i.view(torch.float32)], dim=1)
    if dist.get_backend(mesh.group) == "nccl":
        out = torch.empty((mesh.world_size * both.shape[0], 2 * c), dtype=both.dtype, device=both.device)
        dist.all_gather_into_tensor(out, both, group=mesh.group)
        parts = out.chunk(mesh.world_size)
    else:
        parts = [torch.empty_like(both) for _ in range(mesh.world_size)]
        dist.all_gather(parts, both, group=mesh.group)
    d = torch.cat([p[:, :c] for p in parts], dim=1)
    i = torch.cat([p[:, c:] for p in parts], dim=1).view(torch.int32)
    return d, i


def merge_candidates(cands, k: int, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """This process's per-shard ``[Q, k]`` candidates (distances, global
    rows), in shard order, merged over the mesh into the global top-k:
    ``[Q, S k]`` in shard order on the first device, a stable top-k (ties
    to the lower shard), id -1 where the distance is at least ``MASKED /
    2``. No host sync."""
    dev0 = mesh.devices[0]
    d = torch.cat([c[0].to(dev0, non_blocking=True) for c in cands], dim=1)
    i = torch.cat([c[1].to(dev0, non_blocking=True) for c in cands], dim=1)
    if mesh.group is not None:
        d, i = _all_gather_columns(d, i, mesh)
    out_d, sel = stable_topk(d, k)
    return out_d, torch.where(out_d >= MASKED / 2, -1, i.gather(1, sel))


def eager_candidates(plans: list, queries: list) -> list:
    """Each shard's search of `ShardedIndex._shard_plans` run eagerly on its
    device's queries: every shard launched before any is read, B2 and its
    rescore a shard at a time in turn (`_interleave`)."""
    return _interleave([steps(q) for (_, steps), q in zip(plans, queries)])


# ----------------------------------------------------------------------
# The index
# ----------------------------------------------------------------------


class ShardedIndex:
    """An index whose rows are sharded across a device mesh.

    Build it from rows (`build`, numpy or a tensor), from an `Index`
    (`from_index`), or from saved index files (`mount`, `load`).
    `optimize()` builds an IVF inside every shard (the dense cluster-major
    layout), so searches probe partitions instead of scanning. Adds land in
    free slots, round-robin over the shards, and drop the IVF until the
    next `optimize`; removals keep it."""

    def __init__(self, mesh: Mesh, metric, kind, ndim: int, tables, stats, valids, keys: np.ndarray,
                 live: np.ndarray):
        self.mesh = mesh
        self.metric = metric
        self.kind = kind
        self.ndim = ndim
        self._tables = list(tables)  # per local shard, [per_shard, W] on its device
        self._stats = list(stats)    # [per_shard, 2] f32
        self._valids = list(valids)  # [per_shard] bool
        self._keys = keys            # host u64 [S * per_shard], every shard's
        self._live = live            # host bool [S * per_shard], the masks' mirror
        self._count = int(live.sum())
        # per local shard cents/starts/lens, and the statics p_win, block,
        # c_max, avg_rows
        self._ivf = None
        self._rebuild_host_maps()
        # each local shard's searches captured on its card (graphs.py), one
        # cache a card; `_generation` counts the changes that replace the
        # shards' tensors
        self._graphs = {dev: GraphCache(dev, max_graphs=MAX_GRAPHS * mesh.devices.count(dev))
                        for dev in mesh.devices if dev.type == "cuda"}
        self._generation = 0

    @staticmethod
    def _assemble(mesh, metric, kind, ndim, tables, keys, live, stats=None) -> "ShardedIndex":
        """An index of this process's shard ``tables``; their masks from
        ``live``, their stats computed unless given."""
        per = tables[0].shape[0]
        valids = [torch.as_tensor(live[s * per : (s + 1) * per], device=t.device)
                  for s, t in zip(mesh.shard_ids, tables)]
        stats = stats or [row_stats(t, kind) for t in tables]
        return ShardedIndex(mesh, metric, kind, ndim, tables, stats, valids, keys, live)

    @property
    def _per(self) -> int:
        return self._tables[0].shape[0]

    @property
    def _n_shards(self) -> int:
        return self.mesh.shape[SHARD_AXIS]

    def _rebuild_host_maps(self) -> None:
        self._keymap = KeyMap(multi=False)
        live = np.nonzero(self._live)[0]
        if live.size:
            self._keymap.insert_many(self._keys[live], live.astype(np.uint64))
        per = self._per
        self._free = [(s * per + np.nonzero(~self._live[s * per : (s + 1) * per])[0]).tolist()
                      for s in range(self._n_shards)]

    # -- constructors ---------------------------------------------------

    @staticmethod
    def build(vectors, keys=None, *, metric=MetricKind.Cos, dtype=None, mesh: Optional[Mesh] = None) -> "ShardedIndex":
        """Rows (numpy, or a tensor cast where it lies) spread evenly over
        the mesh; keys default to the row numbers. Every process of a
        group passes the same rows and keeps its own shards."""
        mesh = mesh or make_mesh()
        metric = normalize_metric(metric)
        vectors = _batch(vectors)
        in_kind = kind_of_dtype(vectors.dtype)
        kind = normalize_dtype(dtype, metric=metric) if dtype is not None else in_kind
        if in_kind == ScalarKind.B1:
            ndim, kind = vectors.shape[1] * 8, ScalarKind.B1
        else:
            ndim = vectors.shape[1]
        if kind == ScalarKind.F64:
            kind = ScalarKind.F32  # f32 rows on the device, as an f64 `Index` holds them

        n, n_shards = vectors.shape[0], mesh.shape[SHARD_AXIS]
        per = pad_rows(max((n + n_shards - 1) // n_shards, 1), 8)
        if per > 64 * 1024:
            per = 1 << (per - 1).bit_length()  # a power of two: scan tiles divide it
        keys_full = np.zeros(n_shards * per, dtype=np.uint64)
        keys_full[:n] = np.arange(n, dtype=np.uint64) if keys is None else np.asarray(keys, dtype=np.uint64)
        tables = []
        for s, dev in zip(mesh.shard_ids, mesh.devices):
            table = torch.zeros((per, storage_width(kind, ndim)), dtype=to_torch_dtype(kind), device=dev)
            lo, hi = s * per, min((s + 1) * per, n)
            if hi > lo:
                table[: hi - lo] = _as_rows(vectors[lo:hi], kind, ndim).to(dev)
            tables.append(table)
        return ShardedIndex._assemble(mesh, metric, kind, ndim, tables, keys_full, np.arange(n_shards * per) < n)

    @staticmethod
    def from_index(index: Index, mesh: Optional[Mesh] = None) -> "ShardedIndex":
        """An `Index`'s live rows spread across the mesh in their stored
        (already quantized) form, under their keys."""
        live = index._live_slots()
        rows = index._table[torch.as_tensor(live, device=index.device)]
        cols = (index.ndim + 7) // 8 if index.dtype == ScalarKind.B1 else index.ndim
        return ShardedIndex.build(rows[:, :cols], index._slot_keys[live], metric=index.metric_kind, mesh=mesh)

    # -- mutation ---------------------------------------------------------

    def reserve(self, capacity: int) -> None:
        """Grow every shard to ``ceil(capacity / S)`` rows (a multiple of 8,
        and of the IVF's gather block while there is one), padding at each
        shard's tail: an IVF's chunk starts and lens stay valid, every slot
        id past the first shard moves."""
        n_shards, per = self._n_shards, self._per
        want = pad_rows(max((int(capacity) + n_shards - 1) // n_shards, 1), 8)
        if self._ivf is not None:
            want = pad_rows(want, self._ivf["block"])
        if want <= per:
            return
        extra = want - per
        self._generation += 1
        for j, t in enumerate(self._tables):
            grown = t.new_zeros((extra, t.shape[1]))
            self._tables[j] = torch.cat([t, grown])
            self._stats[j] = torch.cat([self._stats[j], row_stats(grown, self.kind)])
            self._valids[j] = torch.cat([self._valids[j], self._valids[j].new_zeros(extra)])
        keys = np.zeros((n_shards, want), dtype=np.uint64)
        live = np.zeros((n_shards, want), dtype=bool)
        keys[:, :per] = self._keys.reshape(n_shards, per)
        live[:, :per] = self._live.reshape(n_shards, per)
        self._keys, self._live = keys.reshape(-1), live.reshape(-1)
        self._rebuild_host_maps()

    def _write(self, slots: np.ndarray, rows: torch.Tensor) -> None:
        """Rows, their stats and validity at global ``slots``: an
        ``index_copy_`` on each local shard they fall in."""
        per = self._per
        for j, (s, dev) in enumerate(zip(self.mesh.shard_ids, self.mesh.devices)):
            sel = np.nonzero(slots // per == s)[0]
            if not sel.size:
                continue
            local = torch.as_tensor(slots[sel] - s * per, device=dev)
            part = rows[torch.as_tensor(sel, device=rows.device)].to(dev)
            self._tables[j].index_copy_(0, local, part)
            self._stats[j].index_copy_(0, local, row_stats(part, self.kind))
            self._valids[j].index_fill_(0, local, True)

    def add(self, keys, vectors) -> None:
        """Append rows (numpy, or a tensor cast where it lies): one slot per
        shard per round, the shard with the most free slots first, then
        one scatter per shard. Drops the IVF (exact searches serve until
        the next `optimize`)."""
        vectors = _batch(vectors)
        m = vectors.shape[0]
        if m == 0:
            return
        rows = _as_rows(vectors, self.kind, self.ndim)
        if keys is None:
            base = int(self._keymap.max_key()) + 1  # -1 when empty
            keys = np.arange(base, base + m, dtype=np.uint64)
        keys = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
        if keys.shape[0] != m:
            raise ValueError(f"{keys.shape[0]} keys for {m} rows")

        if sum(len(f) for f in self._free) < m:
            n_shards, per = self._n_shards, self._per
            self.reserve(max(2 * per, per + (m + n_shards - 1) // n_shards) * n_shards)
        free = self._free
        order = sorted(range(len(free)), key=lambda s: -len(free[s]))
        slots = np.empty(m, np.int64)
        taken = 0
        idx = [0] * len(free)
        while taken < m:
            for s in order:
                if taken == m:
                    break
                if idx[s] < len(free[s]):
                    slots[taken] = free[s][idx[s]]
                    idx[s] += 1
                    taken += 1
        for s in order:
            if idx[s]:
                del free[s][: idx[s]]

        self._write(slots, rows)
        self._keys[slots] = keys
        self._live[slots] = True
        self._keymap.insert_many(keys, slots.astype(np.uint64))
        self._count += m
        self._ivf = None

    def remove(self, keys) -> int:
        """Mark rows deleted by key; returns how many. The IVF stays."""
        keys = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
        per = self._per
        slots = []
        for key in keys.tolist():
            got = self._keymap.pop(key)
            slots.extend(got)
            for s in got:
                self._free[int(s) // per].append(int(s))
        if not slots:
            return 0
        slots = np.asarray(slots, dtype=np.int64)
        self._live[slots] = False
        for j, (s, dev) in enumerate(zip(self.mesh.shard_ids, self.mesh.devices)):
            mine = slots[slots // per == s]
            if mine.size:
                self._valids[j].index_fill_(0, torch.as_tensor(mine - s * per, device=dev), False)
        self._count -= len(slots)
        return len(slots)

    def contains(self, key) -> bool:
        return self._keymap.contains(int(key))

    # -- persistence --------------------------------------------------------

    def save(self, directory) -> None:
        """``manifest.json``, one standalone `Index` file per shard (its live
        rows in slot order: `Index.restore` opens any shard alone) and, with
        an IVF, ``ivf.npz`` of every shard's chunks, mapped to the rows
        written. Each process writes its own shards' files; the first
        writes the manifest and the IVF."""
        os.makedirs(directory, exist_ok=True)
        per = self._per
        cols = (self.ndim + 7) // 8 if self.kind == ScalarKind.B1 else self.ndim
        files = [f"shard-{s:05d}.usearch" for s in range(self._n_shards)]
        chunks = []
        for j, (s, dev) in enumerate(zip(self.mesh.shard_ids, self.mesh.devices)):
            live_mask = self._live[s * per : (s + 1) * per]
            live = np.nonzero(live_mask)[0]
            shard = Index(ndim=self.ndim, metric=self.metric, dtype=self.kind, device="cpu")
            if live.size:
                rows = self._tables[j][torch.as_tensor(live, device=dev)][:, :cols].cpu()
                shard.add(self._keys[s * per + live], rows)
            shard.save(os.path.join(directory, files[s]))
            if self._ivf is not None:
                # a chunk's rows keep their order among the live rows written
                before = np.concatenate([[0], np.cumsum(live_mask)]).astype(np.int32)
                st = self._ivf["starts"][j].cpu().numpy()
                end = np.minimum(st + self._ivf["lens"][j].cpu().numpy(), per)
                chunks.append((self._ivf["cents"][j].cpu().numpy(), before[st], before[end] - before[st]))
        chunks = [c for part in _gather_objects(chunks, self.mesh) for c in part]
        if self.mesh.rank == 0:
            manifest = {"format": "usearch_tpu.sharded", "version": 1, "metric": self.metric.value,
                        "dtype": self.kind.value, "ndim": self.ndim, "count": self._count, "shards": files}
            if self._ivf is not None:
                np.savez(os.path.join(directory, "ivf.npz"), cents=np.concatenate([c[0] for c in chunks]),
                         starts=np.concatenate([c[1] for c in chunks]), lens=np.concatenate([c[2] for c in chunks]))
                manifest["ivf"] = {name: self._ivf[name] for name in ("p_win", "block", "c_max", "avg_rows")}
            with open(os.path.join(directory, "manifest.json"), "w") as f:
                json.dump(manifest, f)
        if self.mesh.group is not None:
            dist.barrier(group=self.mesh.group)

    @staticmethod
    def load(directory, *, mesh: Optional[Mesh] = None) -> "ShardedIndex":
        """Open a directory written by `save` (of either package). With an
        IVF and as many shards as the mesh, each shard's rows and chunks
        come back as saved and searches probe at once; otherwise the rows
        are re-sharded evenly (`mount`), with no IVF."""
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        paths = [os.path.join(directory, s) for s in manifest["shards"]]
        mesh = mesh or make_mesh()
        info = manifest.get("ivf")
        if info is None or mesh.shape[SHARD_AXIS] != len(paths):
            return ShardedIndex.mount(paths, mesh=mesh)

        block = int(info["block"])
        metric = normalize_metric(manifest["metric"])
        kind = normalize_dtype(manifest["dtype"])
        ndim = int(manifest["ndim"])
        shard_data = [_load_arrays(p, view=True) for p in paths]
        per = pad_rows(max(max(len(k) for _, k, _ in shard_data), 1), block)
        keys = np.zeros(len(paths) * per, dtype=np.uint64)
        live = np.zeros(len(paths) * per, dtype=bool)
        for s, (_, shard_keys, _) in enumerate(shard_data):
            keys[s * per : s * per + len(shard_keys)] = shard_keys
            live[s * per : s * per + len(shard_keys)] = True
        tables = []
        for s, dev in zip(mesh.shard_ids, mesh.devices):
            rows = shard_data[s][2]
            table = torch.zeros((per, storage_width(kind, ndim)), dtype=to_torch_dtype(kind), device=dev)
            if len(rows):
                table[: len(rows), : rows.shape[1]] = _file_rows(rows, kind).to(dev)
            tables.append(table)
        out = ShardedIndex._assemble(mesh, metric, kind, ndim, tables, keys, live)
        z = np.load(os.path.join(directory, "ivf.npz"))
        out._ivf = _local_ivf(mesh, z["cents"], z["starts"], z["lens"], int(info["p_win"]), block,
                              int(info["c_max"]), float(info["avg_rows"]))
        return out

    @staticmethod
    def mount(paths, *, mesh: Optional[Mesh] = None) -> "ShardedIndex":
        """Saved index files (of either package) as one index over the mesh."""
        all_rows, all_keys, meta0 = [], [], None
        for p in paths:
            meta, keys, rows = _load_arrays(p, view=True)
            if meta.get("set_index"):
                raise ValueError("set indexes (sparse jaccard) can't be mounted into a ShardedIndex: their int32 "
                                 "set rows would be re-quantized as numeric vectors")
            meta0 = meta0 or meta
            if (meta["ndim"], meta["metric"], meta["dtype"]) != (meta0["ndim"], meta0["metric"], meta0["dtype"]):
                raise ValueError("All mounted shards must share ndim/metric/dtype")
            all_rows.append(rows)
            all_keys.append(keys)
        rows = _file_rows(np.concatenate(all_rows), normalize_dtype(meta0["dtype"]))
        return ShardedIndex.build(rows, np.concatenate(all_keys), metric=meta0["metric"], dtype=meta0["dtype"],
                                  mesh=mesh)

    # -- IVF ---------------------------------------------------------------

    def optimize(self, n_partitions: Optional[int] = None) -> None:
        """An IVF inside every shard: a k-means fit of the shard's live rows
        where they lie (``n_partitions`` per shard, default the square root
        of its rows; the two-level fit past `ivf.MAX_PARTITIONS`), the rows
        permuted into the dense cluster-major layout, clusters cut into
        chunks of at most 1.5 times the average, chunk counts padded to the
        most of any shard with empty chunks."""
        if self.kind == ScalarKind.B1 or self.metric not in IVF_METRICS:
            raise ValueError("sharded IVF supports cos/ip/l2sq over non-binary dtypes")
        block = ivf.DENSE_BLOCK
        n_shards, per = self._n_shards, self._per
        width = self._tables[0].shape[1]
        local = []  # (shard, member slots in layout order, chunk starts, lens, centroids)
        for j, (s, dev) in enumerate(zip(self.mesh.shard_ids, self.mesh.devices)):
            live = np.nonzero(self._live[s * per : (s + 1) * per])[0]
            if live.size == 0:
                local.append((s, live, [], [], np.zeros((0, width), np.float32)))
                continue
            c_want = min(n_partitions or max(1, int(math.sqrt(live.size))), live.size)
            rows = self._tables[j][torch.as_tensor(live, device=dev)]
            if c_want > ivf.MAX_PARTITIONS:
                assigns, _, cents = kmeans_hierarchical(rows, c_want, metric=self.metric, max_iterations=25, seed=0,
                                                        return_dists=False)
            else:
                assigns, _, cents = kmeans_fit(rows, c_want, metric=self.metric, max_iterations=25, seed=0)
            c = cents.shape[0]
            avg = max(int(np.ceil(live.size / max(c, 1))), 1)
            p_cap = ((int(1.5 * avg) + 7) // 8) * 8
            order = np.argsort(assigns, kind="stable")
            bounds = np.searchsorted(assigns[order], np.arange(c + 1))
            starts, lens, chunk_cents = [], [], []
            for ci in range(c):
                size = int(bounds[ci + 1] - bounds[ci])
                for off in range(0, size, p_cap):
                    starts.append(int(bounds[ci]) + off)
                    lens.append(min(size - off, p_cap))
                    chunk_cents.append(cents[ci])
            local.append((s, live[order], starts, lens,
                          np.stack(chunk_cents) if chunk_cents else np.zeros((0, width), np.float32)))

        layouts = {s: (slots, lens) for part in _gather_objects([l[:2] + l[3:4] for l in local], self.mesh)
                   for s, slots, lens in part}
        c_max = max(max(len(lens) for _, lens in layouts.values()), 1)
        p_win = max(((max(max(lens, default=1) for _, lens in layouts.values()) + 7) // 8) * 8, 8)
        per2 = pad_rows(per, block)
        keys = np.zeros(n_shards * per2, dtype=np.uint64)
        live = np.zeros(n_shards * per2, dtype=bool)
        for s, (slots, _) in layouts.items():
            keys[s * per2 : s * per2 + slots.size] = self._keys[s * per + slots]
            live[s * per2 : s * per2 + slots.size] = True
        cents_l, starts_l, lens_l = [], [], []
        for j, (s, slots, starts, lens, cents) in enumerate(local):
            dev = self.mesh.devices[j]
            table = self._tables[j].new_zeros((per2, width))
            table[: slots.size] = self._tables[j][torch.as_tensor(slots, device=dev)]
            self._tables[j] = table
            self._stats[j] = row_stats(table, self.kind)
            self._valids[j] = torch.as_tensor(live[s * per2 : (s + 1) * per2], device=dev)
            pad = c_max - len(starts)
            cents_l.append(torch.as_tensor(np.concatenate([cents, np.zeros((pad, width), np.float32)]), device=dev))
            starts_l.append(torch.as_tensor(np.asarray(starts + [0] * pad, dtype=np.int32), device=dev))
            lens_l.append(torch.as_tensor(np.asarray(lens + [0] * pad, dtype=np.int32), device=dev))
        self._keys, self._live = keys, live
        self._rebuild_host_maps()  # the permutation moved every slot
        n_chunks = sum(len(lens) for _, lens in layouts.values())
        # avg_rows over the real chunks (padding chunks would inflate nprobe)
        self._ivf = dict(cents=cents_l, starts=starts_l, lens=lens_l, p_win=int(p_win), block=block,
                         c_max=int(c_max), avg_rows=float(max(self._count / max(n_chunks, 1), 1.0)))
        self._generation += 1

    def nprobe_for(self, expansion_search: int = 64, connectivity: int = 16) -> int:
        """Chunks probed per shard, from the reference's ef semantics."""
        if self._ivf is None:
            raise ValueError("no IVF: call optimize() first")
        budget = max(expansion_search, 1) * max(connectivity, 1)
        return int(np.clip(math.ceil(budget / self._ivf["avg_rows"]), 1, self._ivf["c_max"]))

    # -- search ---------------------------------------------------------

    def __len__(self) -> int:
        return self._count

    def _queries(self, vectors) -> Tuple[torch.Tensor, int]:
        """Queries cast to the stored layout and padded to a power of two,
        on their own device (host queries on the CPU); their count."""
        vectors = _batch(vectors)
        n_q = vectors.shape[0]
        q = _as_rows(vectors, self.kind, self.ndim)
        return torch.nn.functional.pad(q, (0, 0, 0, pad_queries(n_q) - n_q)), n_q

    def _tile_rows(self, n_q: int) -> int:
        per = self._per
        tile_rows = pick_tile_rows(per, self._tables[0].shape[1] * self._tables[0].element_size(), self.metric,
                                   self.ndim, n_q)
        while per % tile_rows:
            tile_rows //= 2
        return tile_rows

    def _shard_plans(self, n_q: int, k: int, exact: bool, expansion_search: int) -> list:
        """Each local shard's search of ``n_q`` padded queries as ``(key,
        steps)``: ``steps(q)`` a step generator (`_interleave`) that returns
        its ``[Q, k]`` distances and global rows on its device, ``key`` its
        host decisions, or None where it stays eager on the card (the plain
        scan and probes, `graphs.EAGER`)."""
        per, plans = self._per, []
        probed = self._ivf is not None and not exact
        if probed:
            iv = self._ivf
            nprobe = self.nprobe_for(expansion_search)
            route = ivf.dense_route(self.metric, self.kind, min(n_q, ivf.PROBE_QCHUNK), per, k, nprobe, iv["p_win"],
                                    shard=True)
            key = ("probe", nprobe, n_q, k) if route == "group" else None
        else:
            tile_rows = self._tile_rows(n_q)
            b2 = kernel_tiles(self.metric, self.kind, n_q, per, k, False) is not None
            key = ("exact", tile_rows, n_q, k) if b2 else None
        for j, s in enumerate(self.mesh.shard_ids):
            t, st, v, off = self._tables[j], self._stats[j], self._valids[j], s * per
            if probed:
                c, sta, ln = iv["cents"][j], iv["starts"][j], iv["lens"][j]

                def steps(q, t=t, st=st, v=v, off=off, c=c, sta=sta, ln=ln):
                    d, i = ivf.dense_probe(self.metric, self.kind, q, v, c, t, st, sta, ln, self.ndim, k, nprobe,
                                           iv["p_win"], shard=True, block=iv["block"], binned=False)
                    yield  # launched whole, as one step
                    return d, _global_rows(i, off)
            else:
                def steps(q, t=t, st=st, v=v, off=off):
                    d, i = yield from search_steps(self.metric, self.kind, q, t, st, v, self.ndim, k, tile_rows)
                    return d, _global_rows(i, off)
            plans.append((None if key is None else key + (j,), steps))
        return plans

    def _search_prepared(self, q: torch.Tensor, k: int, exact: bool, expansion_search: int):
        """``[Q, k]`` distances and global rows on the mesh's first device:
        each local shard's search (`_shard_plans`), then `merge_candidates`,
        eagerly. On the cards each shard's search replays its graph
        (graphs.py), the shards in turn from this thread; elsewhere, and
        where the path stays eager, `eager_candidates` runs them."""
        plans = self._shard_plans(q.shape[0], k, exact, expansion_search)
        queries = _replicate(q, self.mesh.devices)
        if self._graphs and plans[0][0] is not None:
            generation = (self._generation, id(self._ivf))
            cands = [self._graphs[dev].run(key, generation, lambda x, steps=steps: run_steps(steps(x)), (qs,))
                     for (key, steps), dev, qs in zip(plans, self.mesh.devices, queries)]
        else:
            cands = eager_candidates(plans, queries)
        return merge_candidates(cands, k, self.mesh)

    def search(self, vectors, count: int = 10, *, exact: bool = False, expansion_search: int = 64,
               **kwargs) -> BatchMatches:
        """The ``count`` nearest rows of each query (numpy, or a tensor
        cast where it lies): probed after `optimize` unless ``exact``, else
        exact. Always a `BatchMatches`."""
        q, n_q = self._queries(vectors)
        # each shard's top-k runs over its own rows
        k = min(count, max(self._count, 1), self._per)
        d, i = self._search_prepared(q, k, exact, expansion_search)
        d, i = d[:n_q].cpu().numpy(), i[:n_q].cpu().numpy()
        found = i >= 0
        keys = np.where(found, self._keys[np.clip(i, 0, None)], 0).astype(np.uint64)
        return BatchMatches(keys=keys, distances=d.astype(np.float32), counts=found.sum(axis=1).astype(np.uint64))


def _local_ivf(mesh: Mesh, cents, starts, lens, p_win: int, block: int, c_max: int, avg_rows: float) -> dict:
    """An IVF dict of this process's shards from every shard's ``[S c_max]``
    chunk arrays."""
    def part(a, s, dev, dtype):
        return torch.as_tensor(np.array(a[s * c_max : (s + 1) * c_max], dtype=dtype), device=dev)

    return dict(cents=[part(cents, s, d, np.float32) for s, d in zip(mesh.shard_ids, mesh.devices)],
                starts=[part(starts, s, d, np.int32) for s, d in zip(mesh.shard_ids, mesh.devices)],
                lens=[part(lens, s, d, np.int32) for s, d in zip(mesh.shard_ids, mesh.devices)],
                p_win=int(p_win), block=int(block), c_max=int(c_max), avg_rows=float(avg_rows))
