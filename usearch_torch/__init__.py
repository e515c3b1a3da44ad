"""usearch_torch: the flat vector index on PyTorch and CUDA (Hopper).

The port of `usearch_tpu` to an NVIDIA H100: the same `Index` surface, with
the scan kernels written in CUDA C++ (csrc/). Entry points run on the card
unless given ``device="cpu"``; with no card they raise. Every public name of
the JAX package is here, `ShardedIndex` (parallel/) included.
"""

import numpy as np

from .enums import (
    DEFAULT_CONNECTIVITY,
    DEFAULT_EXPANSION_ADD,
    DEFAULT_EXPANSION_SEARCH,
    USES_FP16LIB,
    USES_OPENMP,
    USES_SIMSIMD,
    CompiledMetric,
    MetricKind,
    MetricKindBitwise,
    MetricSignature,
    ScalarKind,
)
from .exact import exact_search
from .index import Index, IndexStats
from .indexes import Indexes
# the one-call clustering function; bound after its module is imported, so
# it hides the module `usearch_torch.kmeans` here, as in the JAX package
from .kmeans import kmeans
from .matches import BatchMatches, Clustering, Key, Match, Matches
from .parallel.sharded import ShardedIndex


def search(dataset, query, count: int = 10, metric=MetricKind.Cos, *, exact: bool = False, threads: int = 0,
           log=False, progress=None, device="cuda"):
    """Search the rows of ``dataset`` for ``query`` (one row or a batch);
    keys are row numbers. It scans exactly either way: an IVF built for
    one call would cost more than it saves. Runs on ``device`` (the card by
    default)."""
    matches = exact_search(dataset, query, count=count, metric=metric, device=device)
    return matches[0] if np.asarray(query).ndim == 1 else matches


__all__ = [
    "CompiledMetric",
    "Index",
    "Indexes",
    "IndexStats",
    "Match",
    "Matches",
    "BatchMatches",
    "Clustering",
    "Key",
    "MetricKind",
    "MetricKindBitwise",
    "MetricSignature",
    "ScalarKind",
    "search",
    "exact_search",
    "ShardedIndex",
    "kmeans",
    "DEFAULT_CONNECTIVITY",
    "DEFAULT_EXPANSION_ADD",
    "DEFAULT_EXPANSION_SEARCH",
    "USES_OPENMP",
    "USES_SIMSIMD",
    "USES_FP16LIB",
]
