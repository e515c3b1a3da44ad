"""Key -> slot multimap, in plain Python.

Counterpart of `usearch_tpu/keymap.py` without its native C++ store: u64
keys map to one table slot, or to several when ``multi``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class KeyMap:
    def __init__(self, multi: bool = False):
        self.multi = multi
        self._map: Dict[int, List[int]] = {}
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def insert_many(self, keys: np.ndarray, slots: np.ndarray) -> None:
        m = self._map
        for k, s in zip(np.asarray(keys).tolist(), np.asarray(slots).tolist()):
            cur = m.get(k)
            if cur is None:
                m[k] = [s]
                self._size += 1
            elif self.multi:
                cur.append(s)
                self._size += 1
            else:
                cur[0] = s  # overwrite: the size is unchanged

    def slots_of(self, key: int) -> List[int]:
        return list(self._map.get(int(key), ()))

    def pop(self, key: int) -> List[int]:
        slots = self._map.pop(int(key), [])
        self._size -= len(slots)
        return slots

    def contains(self, key: int) -> bool:
        return int(key) in self._map

    def count(self, key: int) -> int:
        return len(self._map.get(int(key), ()))

    def contains_many(self, keys: np.ndarray) -> np.ndarray:
        m = self._map
        return np.fromiter((k in m for k in np.asarray(keys).tolist()), dtype=bool, count=len(keys))

    def count_many(self, keys: np.ndarray) -> np.ndarray:
        m = self._map
        return np.fromiter(
            (len(m.get(k, ())) for k in np.asarray(keys).tolist()), dtype=np.uint64, count=len(keys)
        )

    def max_key(self) -> int:
        return max(self._map) if self._map else -1

    def copy(self) -> "KeyMap":
        other = KeyMap(self.multi)
        other._map = {k: list(v) for k, v in self._map.items()}
        other._size = self._size
        return other
