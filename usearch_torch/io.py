"""Matrix IO for the standard ANN-benchmark binary formats.

The on-disk contract is fixed by the ecosystem (big-ann-benchmarks et al.,
the same family the reference's python/usearch/io.py speaks): a little-endian
header of two int32 values — row count then column count — followed
immediately by the row-major element data. The element type is carried by the
file extension (``.fbin`` → f32, ``.ibin`` → i32, ``.hbin`` → f16, ``.dbin``
→ f64, ``.bbin`` → u8, ``.i8bin`` → i8, plus the ``.f32bin``/``.i32bin``
spellings). This module is an independent implementation of that contract.

The port's own copy of `usearch_tpu/io.py` (it imports nothing of the JAX
package): the same files, byte for byte, in both directions.
"""

from __future__ import annotations

import os
import struct
import typing

import numpy as np

_HEADER = struct.Struct("<ii")  # little-endian (rows, cols)

_EXT_DTYPES = {
    ".fbin": np.float32,
    ".f32bin": np.float32,
    ".dbin": np.float64,
    ".hbin": np.float16,
    ".ibin": np.int32,
    ".i32bin": np.int32,
    ".bbin": np.uint8,
    ".i8bin": np.int8,
}


def numpy_scalar_size(dtype) -> int:
    """Bytes per element of ``dtype``."""
    return np.dtype(dtype).itemsize


def guess_numpy_dtype_from_filename(filename) -> typing.Optional[type]:
    """Map a matrix file's extension to its element dtype (None if unknown)."""
    suffix = os.path.splitext(str(filename))[1]
    return _EXT_DTYPES.get(suffix)


def load_matrix(
    filename: str,
    start_row: int = 0,
    count_rows: typing.Optional[int] = None,
    view: bool = False,
    dtype: typing.Optional[type] = None,
) -> typing.Optional[np.ndarray]:
    """Load (or memory-map, with ``view=True``) a matrix file.

    ``start_row``/``count_rows`` select a row range without reading the rest
    of the file. Returns None when the file does not exist; raises on a
    malformed file whose payload size disagrees with its header.
    """
    if dtype is None:
        dtype = guess_numpy_dtype_from_filename(filename)
        if dtype is None:
            raise Exception("Unknown file type")
    if not os.path.exists(filename):
        return None

    item = numpy_scalar_size(dtype)
    actual = os.path.getsize(filename)
    with open(filename, "rb") as f:
        n_rows, n_cols = _HEADER.unpack(f.read(_HEADER.size))
        declared = _HEADER.size + n_rows * n_cols * item
        if actual != declared:
            kind = "short" if actual < declared else "long"
            raise ValueError(
                f"Matrix file {filename!r} is {kind}: header declares "
                f"{n_rows}x{n_cols} {np.dtype(dtype).name} "
                f"({declared} bytes), file holds {actual} bytes"
            )
        take = n_rows - start_row if count_rows is None else count_rows
        begin = _HEADER.size + start_row * n_cols * item
        if view:
            return np.memmap(
                f, dtype=dtype, mode="r", offset=begin, shape=(take, n_cols)
            )
        f.seek(begin)
        flat = np.fromfile(f, dtype=dtype, count=take * n_cols)
    return flat.reshape(take, n_cols)


def save_matrix(vectors: np.ndarray, filename: str) -> None:
    """Write a 2-D array as a matrix file (header + row-major data).

    The element type follows the filename extension when recognized,
    otherwise the array's own dtype is kept.
    """
    if vectors.ndim != 2:
        raise ValueError(f"save_matrix needs a 2-D array, got {vectors.ndim}-D")
    dtype = guess_numpy_dtype_from_filename(filename) or vectors.dtype
    n_rows, n_cols = vectors.shape
    with open(filename, "wb") as f:
        f.write(_HEADER.pack(n_rows, n_cols))
        np.ascontiguousarray(vectors, dtype=dtype).tofile(f)
