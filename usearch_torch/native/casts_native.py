"""ctypes binding of the C++ ingestion casts (casts.cc).

Counterpart of `usearch_tpu/native/casts_native.py`, with the library built
by `usearch_torch.native.library` at first use. ``-ffp-contract=off`` keeps
the scaled values unfused, as the JAX package builds them, so both packages
truncate at the same boundaries.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from . import library

_THREADS = min(os.cpu_count() or 1, 8)
_i64 = ctypes.c_int64
_f32p = ctypes.POINTER(ctypes.c_float)
_i8p = ctypes.POINTER(ctypes.c_int8)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "ut_cast_f32_to_i8": ([_f32p, _i8p, _i64, _i64, ctypes.c_int], None),
    "ut_cast_i8_to_f32": ([_i8p, _f32p, _i64, ctypes.c_int], None),
    "ut_pack_bits_f32": ([_f32p, _u8p, _i64, _i64, _i64, ctypes.c_int], None),
}


def lib() -> ctypes.CDLL:
    """The casts' library, built and typed at the first call."""
    return library("casts", _SIGNATURES, flags=["-ffp-contract=off"], libs=["-lpthread"])


def cast_f32_to_i8(values: np.ndarray) -> np.ndarray:
    """``[.., cols]`` f32 to i8: each row scaled to unit L2 norm, then to
    +-127, clamped and truncated toward zero."""
    x = np.ascontiguousarray(values, dtype=np.float32)
    rows = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
    out = np.empty(x.shape, dtype=np.int8)
    lib().ut_cast_f32_to_i8(x.ctypes.data_as(_f32p), out.ctypes.data_as(_i8p), rows, x.shape[-1], _THREADS)
    return out


def cast_i8_to_f32(values: np.ndarray) -> np.ndarray:
    """i8 to f32, divided by 127."""
    x = np.ascontiguousarray(values, dtype=np.int8)
    out = np.empty(x.shape, dtype=np.float32)
    lib().ut_cast_i8_to_f32(x.ctypes.data_as(_i8p), out.ctypes.data_as(_f32p), x.size, _THREADS)
    return out


def pack_bits_f32(values: np.ndarray, row_bytes: int) -> np.ndarray:
    """``[rows, nbits]`` f32 to ``[rows, row_bytes]`` u8: bit = value > 0,
    most significant bit first, zero-padded."""
    x = np.ascontiguousarray(values, dtype=np.float32)
    rows, nbits = x.shape
    out = np.empty((rows, row_bytes), dtype=np.uint8)
    lib().ut_pack_bits_f32(x.ctypes.data_as(_f32p), out.ctypes.data_as(_u8p), rows, nbits, row_bytes, _THREADS)
    return out
