"""Search results: one query's `Matches`, a batch's `BatchMatches`."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


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
