"""Search results: one query's `Matches`, a batch's `BatchMatches`, and
`Index.cluster`'s `Clustering`."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

#: the type of a key
Key = np.uint64


@dataclass(frozen=True)
class Match:
    key: int
    distance: float

    def to_tuple(self) -> tuple:
        return self.key, self.distance


@dataclass
class Matches:
    """Keys and distances of one query, best first."""

    keys: np.ndarray
    distances: np.ndarray
    visited_members: int = 0
    computed_distances: int = 0

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, i: int) -> Match:
        if not isinstance(i, (int, np.integer)) or not -len(self) <= i < len(self):
            raise IndexError(f"match index must be an integer below {len(self)}")
        return Match(int(self.keys[i]), float(self.distances[i]))

    def to_list(self) -> List[tuple]:
        return [(int(k), float(d)) for k, d in zip(self.keys, self.distances)]


@dataclass
class BatchMatches:
    """``[Q, k]`` keys and distances; row ``i`` holds ``counts[i]`` results
    and padding after them."""

    keys: np.ndarray
    distances: np.ndarray
    counts: np.ndarray
    visited_members: int = 0
    computed_distances: int = 0

    def __len__(self) -> int:
        return len(self.counts)

    def __getitem__(self, i: int) -> Matches:
        if not isinstance(i, (int, np.integer)) or not -len(self) <= i < len(self):
            raise IndexError(f"query index must be an integer below {len(self)}")
        n, c = len(self), int(self.counts[i])
        return Matches(
            keys=self.keys[i, :c],
            distances=self.distances[i, :c],
            visited_members=self.visited_members // n,
            computed_distances=self.computed_distances // n,
        )

    def to_list(self) -> List[tuple]:
        return [pair for i in range(len(self)) for pair in self[i].to_list()]

    def count_matches(self, expected: np.ndarray, count: Optional[int] = None) -> int:
        """Queries whose ``expected`` key is among their first ``count``
        results (padding never matches)."""
        expected = np.asarray(expected, dtype=np.uint64)
        assert len(expected) == len(self)
        count = self.keys.shape[1] if count is None else count
        filled = np.arange(self.keys.shape[1])[None, :count] < self.counts[:, None].astype(np.int64)
        hit = (self.keys[:, :count] == expected[:, None]) & filled
        return int(hit.any(axis=1).sum())

    def mean_recall(self, expected: np.ndarray, count: Optional[int] = None) -> float:
        return self.count_matches(expected, count) / len(expected)


class Clustering:
    """The result of `Index.cluster`: for each query (a member key, or a
    row of the given vectors) the key of its cluster's centroid, in
    ``matches.keys[:, 0]``, and the distance to the centroid."""

    def __init__(self, index, matches: BatchMatches, queries: Optional[np.ndarray] = None):
        if queries is None:
            queries = np.array(index.keys)
        self.index = index
        self.queries = queries
        self.matches = matches

    def __repr__(self) -> str:
        return f"usearch_torch.Clustering(for {len(self.queries)} queries)"

    @property
    def centroids_popularity(self) -> Tuple[np.ndarray, np.ndarray]:
        """The centroids' keys and their member counts."""
        return np.unique(self.matches.keys, return_counts=True)

    def members_of(self, centroid) -> np.ndarray:
        return self.queries[self.matches.keys.flatten() == centroid]

    def subcluster(self, centroid, **clustering_kwargs) -> "Clustering":
        return self.index.cluster(keys=self.members_of(centroid), **clustering_kwargs)

    def plot_centroids_popularity(self):  # pragma: no cover - plotting
        from matplotlib import pyplot as plt

        _, sizes = self.centroids_popularity
        plt.yscale("log")
        plt.plot(sorted(sizes), np.arange(len(sizes)))
        plt.show()

    @property
    def network(self):  # pragma: no cover - optional dependency
        import networkx as nx

        keys, sizes = self.centroids_popularity
        g = nx.Graph()
        for key, size in zip(keys, sizes):
            g.add_node(key, size=size)
        for i, i_key in enumerate(keys):
            for j_key in keys[:i]:
                g.add_edge(i_key, j_key, distance=self.index.pairwise_distance(i_key, j_key))
        return g
