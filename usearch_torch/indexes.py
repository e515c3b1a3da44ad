"""`Indexes`: one search over several independent indexes.

Counterpart of `usearch_tpu/indexes.py`, after the reference's sharded
lookup (reference: python/lib.cpp:74-106, 330-520; python/usearch/
index.py:1473-1515): N indexes (in memory, or loaded or viewed from paths,
streamed views among them) searched shard by shard, and their results
merged on the host by distance, invalid places last.
"""

from __future__ import annotations

import os
from typing import Iterable, List

import numpy as np

from .index import Index
from .matches import BatchMatches, Matches


class Indexes:
    def __init__(
        self,
        indexes: Iterable[Index] = (),
        paths: Iterable[os.PathLike] = (),
        view: bool = False,
        threads: int = 0,
        device="cuda",
    ) -> None:
        """``device`` is where indexes restored from ``paths`` live.
        ``threads`` is not read: it is kept for the JAX package's
        signature, as `search`'s ``progress`` is."""
        self._device = device
        self._shards: List[Index] = list(indexes)
        for path in paths:
            self.merge_path(path, view=view)

    def merge(self, index: Index) -> None:
        self._shards.append(index)

    def merge_path(self, path: os.PathLike, view: bool = False) -> None:
        index = Index.restore(os.fspath(path), view=view, device=self._device)
        if index is None:
            raise ValueError(f"Can't restore index from {path}")
        self._shards.append(index)

    def __len__(self) -> int:
        return sum(len(shard) for shard in self._shards)

    def search(
        self,
        vectors,
        count: int = 10,
        *,
        threads: int = 0,
        exact: bool = False,
        progress=None,
    ):
        vectors = np.asarray(vectors)
        single = vectors.ndim == 1
        queries = np.atleast_2d(vectors)
        n_q = queries.shape[0]

        best_d = np.full((n_q, count), np.inf, dtype=np.float32)
        best_k = np.zeros((n_q, count), dtype=np.uint64)
        best_valid = np.zeros((n_q, count), dtype=bool)

        # fan out across shards through `search_async` (every shard's
        # search enqueued before the first result is read), merge after:
        # the role of the reference's executor fan-out over `Indexes`
        # (python/lib.cpp:330-520), without threads
        live_shards = [s for s in self._shards if len(s)]
        if threads != 1 and len(live_shards) > 1:
            pend = [
                s.search_async(queries, count, exact=exact) for s in live_shards
            ]
            results = [p.result() for p in pend]
        else:
            results = [s.search(queries, count, exact=exact) for s in live_shards]

        for m in results:
            k_here = m.keys.shape[1]
            v = np.arange(k_here) < m.counts[:, None].astype(np.int64)
            d = np.where(v, m.distances, np.inf).astype(np.float32)
            cat_d = np.concatenate([best_d, d], axis=1)
            cat_k = np.concatenate([best_k, m.keys.astype(np.uint64)], axis=1)
            cat_v = np.concatenate([best_valid, v], axis=1)
            # invalid placeholders last even against valid inf/NaN
            # distances (a plain stable sort on distance alone dropped a
            # valid d=inf match behind earlier placeholder columns)
            order = np.lexsort((cat_d, ~cat_v))[:, :count]
            best_d = np.take_along_axis(cat_d, order, axis=1)
            best_k = np.take_along_axis(cat_k, order, axis=1)
            best_valid = np.take_along_axis(cat_v, order, axis=1)

        counts = best_valid.sum(axis=1).astype(np.uint64)
        if single:
            c = int(counts[0])
            return Matches(keys=best_k[0, :c], distances=best_d[0, :c])
        return BatchMatches(keys=best_k, distances=best_d, counts=counts)
