"""usearch_torch: the flat vector index on PyTorch and CUDA (Hopper).

The port of `usearch_tpu` to an NVIDIA H100: the same `Index` surface, with
the scan kernels written in CUDA C++ (csrc/). Entry points run on the card
unless given ``device="cpu"``; with no card they raise.
"""

from .enums import MetricKind, ScalarKind
from .exact import exact_search
from .index import Index
from .matches import BatchMatches, Match, Matches

__all__ = ["Index", "exact_search", "MetricKind", "ScalarKind", "Match", "Matches", "BatchMatches"]
