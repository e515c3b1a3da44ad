"""SQLite integration: scalar distance functions over JSON/BLOB vectors.

Functional equivalent of the reference's C++ SQLite extension
(reference: sqlite/lib.cpp:277-331 — distance_cosine_f32(...) etc. over both
JSON arguments and packed BLOBs, plus string distances :255-283). Instead of
a loadable .so, we register Python UDFs on a connection via
`sqlite3.Connection.create_function` — same SQL surface:

    SELECT distance_cosine_f32(v1, v2) FROM vectors;
    SELECT distance_levenshtein_unicode(a, b) FROM strings;

The port's own copy of `usearch_tpu/sqlite.py` (it imports nothing of the
JAX package): the same SQL functions with the same values. They run on the
host, one pair of rows per call, as SQLite calls them.
"""

from __future__ import annotations

import json
import sqlite3
from typing import Union

import numpy as np


def _to_vector(value: Union[bytes, str, float], dtype) -> np.ndarray:
    if isinstance(value, (bytes, memoryview)):
        return np.frombuffer(value, dtype=dtype)
    if isinstance(value, str):
        return np.asarray(json.loads(value), dtype=dtype)
    raise TypeError(f"Can't interpret {type(value)} as a vector")


def _cos(a, b):
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 0.0
    if na == 0 or nb == 0:
        return 1.0
    return float(1.0 - np.dot(a, b) / (na * nb))


def _l2sq(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(np.dot(d, d))


def _ip(a, b):
    return float(1.0 - np.dot(a.astype(np.float64), b.astype(np.float64)))


def _hamming_bits(a, b):
    return float(np.unpackbits(np.bitwise_xor(a, b)).sum())


def _jaccard_bits(a, b):
    inter = np.unpackbits(np.bitwise_and(a, b)).sum()
    union = np.unpackbits(np.bitwise_or(a, b)).sum()
    return float(1.0 - inter / union) if union else 0.0


def levenshtein(a: Union[str, bytes], b: Union[str, bytes]) -> int:
    """Classic DP edit distance (the reference vendors StringZilla for this;
    host-side Python is adequate for SQL scalar calls)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _hamming_str(a, b):
    n = min(len(a), len(b))
    return sum(x != y for x, y in zip(a[:n], b[:n])) + abs(len(a) - len(b))


_SCALAR_FNS = {
    "f32": np.float32,
    "f64": np.float64,
    "f16": np.float16,
    "i8": np.int8,
}

_METRIC_FNS = {
    "cosine": _cos,
    "sqeuclidean": _l2sq,
    "inner": _ip,
}


def _null_safe(f):
    """SQL convention: any NULL argument yields NULL (str(None) would
    otherwise silently compute a distance against the literal 'None')."""
    def wrapped(x, y):
        if x is None or y is None:
            return None
        return f(x, y)
    return wrapped


def register(conn: sqlite3.Connection) -> sqlite3.Connection:
    """Install all usearch distance functions on a connection."""
    for skind, dt in _SCALAR_FNS.items():
        for mname, mfn in _METRIC_FNS.items():
            name = f"distance_{mname}_{skind}"

            def fn(x, y, _dt=dt, _m=mfn):
                return _m(_to_vector(x, _dt), _to_vector(y, _dt))

            conn.create_function(name, 2, _null_safe(fn), deterministic=True)

    conn.create_function(
        "distance_hamming_binary",
        2,
        _null_safe(lambda x, y: _hamming_bits(_to_vector(x, np.uint8), _to_vector(y, np.uint8))),
        deterministic=True,
    )
    conn.create_function(
        "distance_jaccard_binary",
        2,
        _null_safe(lambda x, y: _jaccard_bits(_to_vector(x, np.uint8), _to_vector(y, np.uint8))),
        deterministic=True,
    )
    conn.create_function(
        "distance_levenshtein_bytes",
        2,
        _null_safe(lambda x, y: levenshtein(
            x if isinstance(x, bytes) else str(x).encode(),
            y if isinstance(y, bytes) else str(y).encode(),
        )),
        deterministic=True,
    )
    conn.create_function(
        "distance_levenshtein_unicode", 2,
        _null_safe(lambda x, y: levenshtein(str(x), str(y))), deterministic=True
    )
    conn.create_function(
        "distance_hamming_bytes",
        2,
        _null_safe(lambda x, y: _hamming_str(
            x if isinstance(x, bytes) else str(x).encode(),
            y if isinstance(y, bytes) else str(y).encode(),
        )),
        deterministic=True,
    )
    conn.create_function(
        "distance_hamming_unicode", 2,
        _null_safe(lambda x, y: _hamming_str(str(x), str(y))), deterministic=True
    )
    return conn
