"""`Index.cluster`: k-means over an index's members, the cluster count held
within bounds.

Counterpart of `usearch_tpu/cluster.py`. The fit (`kmeans.kmeans_fit`) runs
on the index's device over its live rows as f32 (the stored values; b1 rows
as their unpacked bits, so l2 clustering follows hamming), under the
index's metric where it is ip, cos or l2sq and l2sq otherwise. k is
``sqrt(n)`` clamped into ``[min_count, max_count]``; where k-means leaves
clusters empty below ``min_count``, the largest cluster is split at its
farthest member until the floor holds. Each centroid is named by its
nearest member's key. k-means++ seeds from a `torch.Generator`, so the
clusters are not the JAX package's for the same seed; the contract (the
count within its bounds, centroids named by member keys) is the same.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .enums import MetricKind, ScalarKind
from .kmeans import kmeans_fit
from .matches import BatchMatches, Clustering
from .ops.packbits import unpack_bits


def _member_rows(index, live: np.ndarray) -> torch.Tensor:
    """The live rows as f32 on the index's device: the stored values at
    the stored width, or the unpacked bits (``ndim`` of them) of b1 rows."""
    rows = index._stored_rows(live)
    if index._dtype == ScalarKind.B1:
        return unpack_bits(rows)[:, : index._ndim].float()
    return rows.float()


def cluster_index(index, *, vectors=None, keys=None, min_count: Optional[int] = None,
                  max_count: Optional[int] = None) -> Clustering:
    member_keys = index._live_keys()
    n = len(member_keys)
    if n == 0:
        empty = BatchMatches(keys=np.zeros((0, 1), np.uint64), distances=np.zeros((0, 1), np.float32),
                             counts=np.zeros(0, np.uint64))
        return Clustering(index, empty, np.zeros(0, np.uint64))
    if index._is_set_index:
        raise ValueError("cluster() is undefined for set indexes (rows are id lists, not points in a vector space)")
    member_rows_dev = _member_rows(index, index._live_slots())
    member_rows = None  # the host copy, made only where it is needed below

    lo = int(min_count) if min_count else 2
    hi = int(max_count) if max_count else max(lo, int(math.sqrt(n)))
    k = min(int(np.clip(int(math.sqrt(n)), lo, hi)), n)
    metric = index._metric_kind
    if metric not in (MetricKind.Cos, MetricKind.IP, MetricKind.L2sq):
        metric = MetricKind.L2sq
    assigns, dists, centroids = kmeans_fit(member_rows_dev, k, metric=metric, seed=0)
    assigns, dists, centroids = np.array(assigns), np.array(dists), np.asarray(centroids)

    # k-means may leave clusters empty: split the largest populated one at
    # its farthest member until the floor holds (or only singletons are
    # left). k <= hi, so the ceiling holds by construction.
    populated = len(np.unique(assigns))
    while populated < min(lo, n):
        big = int(np.argmax(np.bincount(assigns, minlength=centroids.shape[0])))
        members = np.nonzero(assigns == big)[0]
        if len(members) < 2:
            break
        if member_rows is None:
            member_rows = member_rows_dev.cpu().numpy()
        rows_b = member_rows[members].astype(np.float32)
        new_c = rows_b[int(np.argmax(np.sum((rows_b - centroids[big]) ** 2, axis=1)))]
        a2, d2 = _assign_to_centroids(rows_b, np.stack([centroids[big], new_c]), metric)
        moved = a2 == 1
        if not moved.any() or moved.all():
            # equal points: halve, the count is the contract
            moved = np.zeros(len(members), dtype=bool)
            moved[len(members) // 2 :] = True
        new_id = centroids.shape[0]
        centroids = np.vstack([centroids, new_c[None]])
        assigns[members[moved]] = new_id
        dists[members] = np.where(moved, d2, dists[members])
        populated += 1

    # each centroid is named by its nearest member's key (an empty one by
    # the member nearest to it)
    kc = centroids.shape[0]
    centroid_keys = np.empty(kc, dtype=np.uint64)
    order = np.argsort(dists, kind="stable")
    uniq, first_pos = np.unique(assigns[order], return_index=True)
    centroid_keys[uniq] = member_keys[order[first_pos]]
    empty = np.setdiff1d(np.arange(kc), uniq, assume_unique=True)
    if empty.size:
        if member_rows is None:
            member_rows = member_rows_dev.cpu().numpy()
        ce = centroids[empty]
        d2 = np.sum(member_rows ** 2, axis=1)[:, None] + np.sum(ce ** 2, axis=1)[None, :] - 2.0 * member_rows @ ce.T
        centroid_keys[empty] = member_keys[np.argmin(d2, axis=0)]

    if vectors is not None:
        q_rows = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        q_assigns, q_dists = _assign_to_centroids(q_rows, centroids, metric)
        query_ids = np.arange(len(q_rows), dtype=np.uint64)
    elif keys is not None:
        sel = np.isin(member_keys, np.asarray(keys, dtype=np.uint64))
        q_assigns, q_dists, query_ids = assigns[sel], dists[sel], member_keys[sel]
    else:
        q_assigns, q_dists, query_ids = assigns, dists, member_keys
    matches = BatchMatches(keys=centroid_keys[q_assigns][:, None], distances=q_dists[:, None].astype(np.float32),
                           counts=np.ones(len(q_assigns), dtype=np.uint64))
    return Clustering(index, matches, query_ids)


def _assign_to_centroids(rows: np.ndarray, centroids: np.ndarray, metric: MetricKind):
    """Nearest centroid of each row and its distance, on the host (rows
    zero-padded to the centroids' width)."""
    width = centroids.shape[1]
    if rows.shape[1] < width:
        rows = np.concatenate([rows, np.zeros((rows.shape[0], width - rows.shape[1]), np.float32)], axis=1)
    if metric in (MetricKind.Cos, MetricKind.IP):
        qn = np.linalg.norm(rows, axis=1, keepdims=True)
        cn = np.linalg.norm(centroids, axis=1, keepdims=True)
        qn[qn == 0] = 1.0
        cn[cn == 0] = 1.0
        d = 1.0 - (rows / qn) @ (centroids / cn).T
    else:
        d = (np.sum(rows * rows, axis=1, keepdims=True) + np.sum(centroids * centroids, axis=1)[None, :]
             - 2.0 * rows @ centroids.T)
    a = np.argmin(d, axis=1)
    return a, d[np.arange(len(a)), a]
