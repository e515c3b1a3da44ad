"""ctypes binding of the C++ key -> slot multimap (keymap.cc).

The same interface as `usearch_torch.keymap._PyKeyMap`. Counterpart of
`usearch_tpu/native/keymap_native.py`, with the library built by
`usearch_torch.native.library` at first use instead of at import.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import library

_u64 = ctypes.c_uint64
_u64p = ctypes.POINTER(ctypes.c_uint64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_voidp = ctypes.c_void_p
_SIGNATURES = {
    "km_create": ([ctypes.c_int], _voidp),
    "km_destroy": ([_voidp], None),
    "km_size": ([_voidp], _u64),
    "km_insert_many": ([_voidp, _u64p, _u64p, _u64], None),
    "km_slots_of": ([_voidp, _u64, _u64p, _u64], _u64),
    "km_pop": ([_voidp, _u64, _u64p, _u64], _u64),
    "km_contains": ([_voidp, _u64], ctypes.c_int),
    "km_count": ([_voidp, _u64], _u64),
    "km_contains_many": ([_voidp, _u64p, _u64, _u8p], None),
    "km_count_many": ([_voidp, _u64p, _u64, _u64p], None),
    "km_max_key": ([_voidp, _u64p], ctypes.c_int),
    "km_keys_all": ([_voidp, _u64p, _u64], _u64),
    "km_copy": ([_voidp], _voidp),
}


def lib() -> ctypes.CDLL:
    """The key map's library, built and typed at the first call."""
    return library("keymap", _SIGNATURES)


def _as_u64p(arr: np.ndarray):
    return arr.ctypes.data_as(_u64p)


class NativeKeyMap:
    """u64 keys to one slot each, or to several with ``multi``. A key
    inserted again adds an entry, as in ``multi``: callers insert only keys
    the map lacks unless ``multi``."""

    __slots__ = ("_h", "_lib", "multi")

    def __init__(self, multi: bool = False, _handle=None):
        self._lib = lib()
        self.multi = multi
        self._h = _handle if _handle is not None else self._lib.km_create(1 if multi else 0)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.km_destroy(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.km_size(self._h))

    def insert_many(self, keys: np.ndarray, slots: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        slots = np.ascontiguousarray(slots, dtype=np.uint64)
        self._lib.km_insert_many(self._h, _as_u64p(keys), _as_u64p(slots), len(keys))

    def slots_of(self, key: int) -> list:
        buf = np.empty(16, dtype=np.uint64)
        n = int(self._lib.km_slots_of(self._h, _u64(key), _as_u64p(buf), 16))
        if n > 16:
            buf = np.empty(n, dtype=np.uint64)
            n = int(self._lib.km_slots_of(self._h, _u64(key), _as_u64p(buf), n))
        return [int(x) for x in buf[:n]]

    def pop(self, key: int) -> list:
        n_expected = int(self._lib.km_count(self._h, _u64(key)))
        if n_expected == 0:
            return []
        buf = np.empty(n_expected, dtype=np.uint64)
        n = int(self._lib.km_pop(self._h, _u64(key), _as_u64p(buf), n_expected))
        return [int(x) for x in buf[:n]]

    def contains(self, key: int) -> bool:
        return bool(self._lib.km_contains(self._h, _u64(key)))

    def count(self, key: int) -> int:
        return int(self._lib.km_count(self._h, _u64(key)))

    def contains_many(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty(len(keys), dtype=np.uint8)
        self._lib.km_contains_many(self._h, _as_u64p(keys), len(keys), out.ctypes.data_as(_u8p))
        return out.astype(bool)

    def count_many(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty(len(keys), dtype=np.uint64)
        self._lib.km_count_many(self._h, _as_u64p(keys), len(keys), _as_u64p(out))
        return out

    def max_key(self) -> int:
        out = _u64(0)
        has = int(self._lib.km_max_key(self._h, ctypes.byref(out)))
        return int(out.value) if has else -1

    def keys_array(self) -> np.ndarray:
        """The live keys, each once, in no particular order."""
        buf = np.empty(max(len(self), 1), dtype=np.uint64)
        got = int(self._lib.km_keys_all(self._h, _as_u64p(buf), len(buf)))
        return np.unique(buf[:got]) if self.multi else buf[:got]

    def copy(self) -> "NativeKeyMap":
        return NativeKeyMap(self.multi, _handle=self._lib.km_copy(self._h))
