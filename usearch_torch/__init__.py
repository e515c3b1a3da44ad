"""usearch_torch: the flat vector index on PyTorch and CUDA (Hopper).

The port of `usearch_tpu` to an NVIDIA H100: the same `Index` surface, with
the scan kernels written in CUDA C++ (csrc/). Entry points run on the card
unless given ``device="cpu"``; with no card they raise. Every public name of
the JAX package is here; those not ported yet raise `NotImplementedError`
naming their ROADMAP item.
"""

from .enums import (
    DEFAULT_CONNECTIVITY,
    DEFAULT_EXPANSION_ADD,
    DEFAULT_EXPANSION_SEARCH,
    USES_FP16LIB,
    USES_OPENMP,
    USES_SIMSIMD,
    MetricKind,
    MetricKindBitwise,
    ScalarKind,
)
from .exact import exact_search
from .index import Index, _todo, _todo_class
from .matches import BatchMatches, Key, Match, Matches

search = _todo("A.3c")
# the JAX package's one-call clustering function; it hides the fit's module
# `usearch_torch.kmeans` here, as in the JAX package
kmeans = _todo("A.3c")
IndexStats = _todo_class("IndexStats", "A.3c")
Indexes = _todo_class("Indexes", "A.9")
Clustering = _todo_class("Clustering", "A.9")
CompiledMetric = _todo_class("CompiledMetric", "A.7b")
MetricSignature = _todo_class("MetricSignature", "A.7b")
ShardedIndex = _todo_class("ShardedIndex", "A.11")

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
