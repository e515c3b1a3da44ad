"""Key -> slot multimap.

Counterpart of `usearch_tpu/keymap.py`: u64 keys map to one table slot, or
to several when ``multi``. `KeyMap` gives the C++ map of native/keymap.cc,
built with g++ at first use; where it cannot be built or loaded, the plain
Python map `_PyKeyMap`, which the tests also hold the native one against.
``keymap.NATIVE`` says which route loaded (reading it builds the library).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class _PyKeyMap:
    """The plain map: a dict of slot lists."""

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

    def keys_array(self) -> np.ndarray:
        """The live keys, each once, in insertion order."""
        return np.fromiter(self._map, dtype=np.uint64, count=len(self._map))

    def copy(self) -> "_PyKeyMap":
        other = _PyKeyMap(self.multi)
        other._map = {k: list(v) for k, v in self._map.items()}
        other._size = self._size
        return other


def _native():
    """The native map's class, or None when its library does not build or
    load (no g++): the Python map serves then, as in the JAX package."""
    from .native import BuildError, keymap_native

    try:
        keymap_native.lib()
    except BuildError:
        return None
    return keymap_native.NativeKeyMap


def KeyMap(multi: bool = False):
    """A new key map: the native one where it loads, else the Python one."""
    native = _native()
    return native(multi) if native is not None else _PyKeyMap(multi)


def __getattr__(name: str):
    if name == "NATIVE":
        return _native() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
