"""Evaluation and benchmarking helpers: synthetic rows, self-recall,
ranking metrics, and the dataset, add and search tasks of an evaluation.

Counterpart of `usearch_tpu/eval.py`, after the reference's
python/usearch/eval.py. `random_vectors` draws from a `torch.Generator`
(seeded with ``seed``, else from fresh entropy), so it gives other rows
than the JAX package's numpy draw. Ground truth comes from the port's
`exact_search`, on ``device`` (the card by default).
"""

from __future__ import annotations

from dataclasses import dataclass
from math import ceil
from time import time_ns
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from .enums import MetricKind, MetricKindBitwise, ScalarKind, normalize_dtype, normalize_metric
from .matches import BatchMatches

#: the numpy dtype of `random_vectors`' rows by storage kind (numpy has no
#: bf16: bf16 rows come as f32)
_ROW_DTYPES = {ScalarKind.F64: np.float64, ScalarKind.F32: np.float32, ScalarKind.F16: np.float16,
               ScalarKind.BF16: np.float32, ScalarKind.I8: np.int8}


def random_vectors(
    count: int,
    metric: MetricKind = MetricKind.IP,
    dtype: ScalarKind = ScalarKind.F32,
    ndim: Optional[int] = None,
    index=None,
    seed: Optional[int] = None,
) -> np.ndarray:
    """Draw `count` synthetic rows laid out for the target index geometry:
    bit-packed uint8 words when the metric or storage is binary, [0,100)
    int8 for i8 storage, unit-normalized floats for IP, raw uniforms for
    everything else. Pass `index=` to pull the geometry off a live index."""
    if index is not None:
        metric, dtype, ndim = index.metric, index.dtype, index.ndim
    else:
        metric = normalize_metric(metric)
        dtype = normalize_dtype(dtype, ndim=ndim or 0, metric=metric)
    if not ndim:
        raise ValueError("ndim must be known: pass ndim= or index=")

    gen = torch.Generator()
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(int(seed))
    rows = torch.rand((count, ndim), generator=gen, dtype=torch.float64).numpy()
    if dtype == ScalarKind.B1 or metric in MetricKindBitwise:
        # a fair coin per bit, packed MSB-first; padding bits stay zero
        return np.packbits(rows < 0.5, axis=1)
    target = _ROW_DTYPES[dtype]
    if target == np.int8:
        return (rows * 100.0).astype(np.int8)
    rows = rows.astype(target)
    if metric == MetricKind.IP:
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows


@dataclass
class SearchStats:
    """Aggregate quality counters over a batch of probed searches.

    ``mean_recall`` is the fraction of queries whose expected member
    surfaced. ``mean_efficiency`` measures how much of the corpus the
    engine skipped: 1.0 means no distances were evaluated at all, 0.0
    means every query brute-forced every member."""

    index_size: int
    count_queries: int
    count_matches: int
    visited_members: int
    computed_distances: int

    @property
    def mean_recall(self) -> float:
        return self.count_matches / float(self.count_queries)

    @property
    def mean_efficiency(self) -> float:
        exhaustive = float(self.count_queries) * float(self.index_size)
        return 1.0 - self.computed_distances / exhaustive


def self_recall(index, sample: Union[float, int] = 1.0, **kwargs) -> SearchStats:
    """Queries every existing member; approximate search must find itself."""
    if len(index) == 0:
        return 0
    if "count" not in kwargs:
        kwargs["count"] = 1
    if "keys" in kwargs:
        keys = kwargs.pop("keys")
    else:
        keys = np.array(index.keys)
    # ints are absolute counts (so sample=1 means ONE key); only the float
    # 1.0 means "all" (reference eval.py semantics)
    if not (isinstance(sample, float) and sample == 1.0):
        if isinstance(sample, float):
            sample = int(ceil(len(keys) * sample))
        keys = np.random.choice(keys, sample)
    if "vectors" in kwargs:
        vectors = kwargs.pop("vectors")
    else:
        vectors = index.get(keys)

    matches = index.search(vectors, **kwargs)
    count_matches: int = (
        matches.count_matches(keys)
        if isinstance(matches, BatchMatches)
        else int(matches.keys[0] == keys[0])
    )
    return SearchStats(
        index_size=len(index),
        count_queries=len(keys),
        count_matches=count_matches,
        visited_members=matches.visited_members,
        computed_distances=matches.computed_distances,
    )


def measure_seconds(f: Callable) -> Tuple[float, Any]:
    a = time_ns()
    result = f()
    b = time_ns()
    return (b - a) / 1e9, result


def dcg(relevances: np.ndarray, k: Optional[int] = None) -> float:
    if k:
        relevances = np.asarray(relevances)[:k]
    n = len(relevances)
    if n == 0:
        return 0.0
    discounts = np.log2(np.arange(n) + 2)
    return float(np.sum(relevances / discounts))


def ndcg(relevances: np.ndarray, k: Optional[int] = None) -> float:
    best = dcg(sorted(relevances, reverse=True), k)
    if best == 0:
        return 0.0
    return dcg(relevances, k) / best


def relevance(expected: np.ndarray, predicted: np.ndarray, k: Optional[int] = None) -> List[int]:
    expected = expected[:k]
    predicted = predicted[:k]
    return [1 if i in expected else 0 for i in predicted]


def recall_at_k(matches: BatchMatches, neighbors: np.ndarray, k: int) -> float:
    """recall@k: fraction of true top-k neighbors recovered per query."""
    found = 0
    total = 0
    for i in range(len(matches)):
        truth = set(int(x) for x in neighbors[i, :k])
        # honor counts: slots past counts[i] hold the 0 sentinel, which
        # would spuriously match a true neighbor with key 0
        kk = min(k, int(matches.counts[i]))
        got = set(int(x) for x in matches.keys[i, :kk])
        found += len(truth & got)
        total += len(truth)
    return found / max(total, 1)


@dataclass
class Dataset:
    keys: np.ndarray
    vectors: np.ndarray
    queries: np.ndarray
    neighbors: np.ndarray

    def crop_neighbors(self, k: int):
        self.neighbors = self.neighbors[:, :k]

    @property
    def ndim(self):
        return self.vectors.shape[1]

    @staticmethod
    def build(
        vectors: Optional[str] = None,
        queries: Optional[str] = None,
        neighbors: Optional[str] = None,
        count: Optional[int] = None,
        ndim: Optional[int] = None,
        k: Optional[int] = None,
        metric="cos",
        device="cuda",
    ) -> "Dataset":
        """Load a dataset from .fbin/.ibin files, or synthesize a random one;
        missing neighbors are the exact answer on ``device``."""
        from .io import load_matrix

        if vectors is not None:
            vecs = load_matrix(vectors, count_rows=count)
            qs = load_matrix(queries) if queries else vecs
            ns = load_matrix(neighbors) if neighbors else None
            keys = np.arange(len(vecs), dtype=np.uint64)
            if ns is None:
                from .exact import exact_search

                m = exact_search(vecs, qs, k or 10, metric=metric, device=device)
                ns = m.keys.astype(np.int64)
            return Dataset(keys=keys, vectors=vecs, queries=qs, neighbors=ns)
        assert count and ndim, "Either files or (count, ndim) must be provided"
        vecs = np.random.rand(count, ndim).astype(np.float32)
        qs = np.random.rand(max(count // 10, 1), ndim).astype(np.float32)
        from .exact import exact_search

        m = exact_search(vecs, qs, k or 10, metric=metric, device=device)
        return Dataset(
            keys=np.arange(count, dtype=np.uint64),
            vectors=vecs,
            queries=qs,
            neighbors=m.keys.astype(np.int64),
        )


def _combine_rates(
    n_a: Optional[int], rate_a: Optional[float],
    n_b: Optional[int], rate_b: Optional[float],
) -> Tuple[Optional[int], Optional[float]]:
    """Merge two (operation-count, ops-per-second) measurements into the
    (count, rate) an uninterrupted run over both workloads would report:
    total operations over total elapsed seconds. Empty measurements pass
    the other side through unchanged."""
    if not n_a:
        return n_b, rate_b
    if not n_b:
        return n_a, rate_a
    elapsed = n_a / rate_a + n_b / rate_b
    return n_a + n_b, (n_a + n_b) / elapsed


@dataclass
class TaskResult:
    """One task's throughput/recall measurement. Addition accumulates:
    summing the per-batch results of sliced tasks yields the figures of the
    whole run (rates combine over total elapsed time, recall averages
    weighted by query count)."""

    add_operations: Optional[int] = None
    add_per_second: Optional[float] = None
    search_operations: Optional[int] = None
    search_per_second: Optional[float] = None
    recall_at_one: Optional[float] = None

    @property
    def add_seconds(self) -> float:
        return self.add_operations / self.add_per_second

    @property
    def search_seconds(self) -> float:
        return self.search_operations / self.search_per_second

    def __add__(self, other: "TaskResult") -> "TaskResult":
        adds, add_rate = _combine_rates(
            self.add_operations, self.add_per_second,
            other.add_operations, other.add_per_second,
        )
        searches, search_rate = _combine_rates(
            self.search_operations, self.search_per_second,
            other.search_operations, other.search_per_second,
        )
        hits = [
            (r.recall_at_one, r.search_operations)
            for r in (self, other)
            if r.search_operations and r.recall_at_one is not None
        ]
        recall = (
            sum(rc * nq for rc, nq in hits) / sum(nq for _, nq in hits)
            if hits
            else (self.recall_at_one if self.search_operations else other.recall_at_one)
        )
        return TaskResult(
            add_operations=adds,
            add_per_second=add_rate,
            search_operations=searches,
            search_per_second=search_rate,
            recall_at_one=recall,
        )


@dataclass
class AddTask:
    keys: np.ndarray
    vectors: np.ndarray

    def __call__(self, index) -> TaskResult:
        dt, _ = measure_seconds(lambda: index.add(self.keys, self.vectors))
        return TaskResult(add_operations=len(self.keys), add_per_second=len(self.keys) / dt)

    @property
    def ndim(self):
        return self.vectors.shape[1]

    @property
    def count(self):
        return self.vectors.shape[0]

    def inplace_shuffle(self):
        order = np.arange(self.count)
        np.random.shuffle(order)
        self.keys = self.keys[order]
        self.vectors = self.vectors[order]

    def slices(self, batch_size: int) -> List["AddTask"]:
        return [
            AddTask(keys=self.keys[s : s + batch_size], vectors=self.vectors[s : s + batch_size])
            for s in range(0, self.count, batch_size)
        ]

    def clusters(self, number_of_clusters: int, device="cuda") -> List["AddTask"]:
        from .kmeans import kmeans

        assigns, _, _ = kmeans(self.vectors.astype(np.float32), number_of_clusters, device=device)
        return [
            AddTask(keys=self.keys[assigns == c], vectors=self.vectors[assigns == c])
            for c in range(number_of_clusters)
        ]


@dataclass
class SearchTask:
    queries: np.ndarray
    neighbors: np.ndarray

    def __call__(self, index) -> TaskResult:
        dt, results = measure_seconds(lambda: index.search(self.queries, self.neighbors.shape[1]))
        return TaskResult(
            search_operations=len(self.queries),
            search_per_second=len(self.queries) / dt,
            recall_at_one=results.mean_recall(self.neighbors[:, 0], count=1),
        )

    def slices(self, batch_size: int) -> List["SearchTask"]:
        return [
            SearchTask(
                queries=self.queries[s : s + batch_size],
                neighbors=self.neighbors[s : s + batch_size],
            )
            for s in range(0, len(self.queries), batch_size)
        ]


@dataclass
class Evaluation:
    tasks: List[Any]
    count: int
    ndim: int

    @staticmethod
    def for_dataset(dataset: Dataset, batch_size: int = 0, clusters: int = 1, device="cuda") -> "Evaluation":
        tasks = []
        add = AddTask(keys=dataset.keys, vectors=dataset.vectors)
        search = SearchTask(queries=dataset.queries, neighbors=dataset.neighbors)
        if clusters > 1:
            adds = add.clusters(clusters, device)
        elif batch_size:
            adds = add.slices(batch_size)
        else:
            adds = [add]
        tasks.extend(adds)
        if batch_size:
            tasks.extend(search.slices(batch_size))
        else:
            tasks.append(search)
        return Evaluation(tasks=tasks, count=add.count, ndim=add.ndim)

    def __call__(self, index, post_clean: bool = True) -> dict:
        task_result = TaskResult()
        for task in self.tasks:
            task_result = task_result + task(index)
        if post_clean:
            index.clear()
        return task_result.__dict__


def probe_curve(
    index,
    queries: np.ndarray,
    k: int = 10,
    expansions: Optional[List[int]] = None,
) -> List[dict]:
    """Recall@k / QPS curve over the probe budget (`expansion_search`) — the
    IVF analog of the reference's ef-sweep tables (BENCHMARKS.md: recall vs
    expansion_search sweeps). Ground truth is the exact scan on the same
    index. Requires a built IVF (`Index.optimize`); restores the index's
    expansion_search afterwards.

    Returns one dict per budget: {expansion_search, nprobe, rows_scanned,
    qps, recall}.
    """
    import time

    if index._ivf is None or index._ivf_dirty:
        raise ValueError("probe_curve needs a built IVF: call Index.optimize() first")
    queries = np.atleast_2d(np.asarray(queries))
    expansions = expansions or [16, 32, 64, 128, 256, 512]

    exact = index.search(queries, k, exact=True)
    want = [set(row[: int(c)].tolist()) for row, c in zip(exact.keys, exact.counts)]

    saved = index._expansion_search
    out = []
    try:
        seen_nprobe = set()
        for ef in expansions:
            index._expansion_search = int(ef)
            nprobe = index._ivf.nprobe_for(int(ef), index._connectivity)
            if nprobe in seen_nprobe:
                continue  # same probe count -> identical measurement
            seen_nprobe.add(nprobe)
            index.search(queries, k)  # warm/compile
            # best-of-n timing: single-shot is noisy at small Q (dispatch
            # jitter through the transport dwarfs device time there)
            reps = 3 if len(queries) <= 4096 else 1
            dt = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                got = index.search(queries, k)
                dt = min(dt, max(time.perf_counter() - t0, 1e-9))
            hits = sum(
                len(set(row[: int(c)].tolist()) & w)
                for row, c, w in zip(got.keys, got.counts, want)
            )
            denom = max(sum(len(w) for w in want), 1)
            out.append(
                {
                    "expansion_search": int(ef),
                    "nprobe": int(nprobe),
                    "rows_scanned": int(index._ivf.scanned_rows(int(ef), index._connectivity)),
                    "qps": len(queries) / dt,
                    "recall": hits / denom,
                }
            )
    finally:
        index._expansion_search = saved
    return out
