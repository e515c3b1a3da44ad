"""Exact engine: row layout, the kernel gate, and brute-force search.

Counterpart of `usearch_tpu/exact.py`. `search_kernel` sends a search to the
scan kernels (ops/scan.py) under the same gates as the JAX package, so the
same calls take the kernel path in both; packed b1 rows under the binary
metrics take the bit scan (ops/bitscan.py), where the JAX package runs its
XLA scan; everything else takes the plain tiled scan of ops/topk.py.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .enums import MetricKind, ScalarKind, kind_of_dtype, normalize_dtype, normalize_metric
from .matches import BatchMatches
from .ops import bitscan
from .ops.casts import cast_vectors
from .ops.distances import row_stats, tile_dists
from .ops.scan import exact_steps, run_steps, search_binned, supports
from .ops.topk import masked_topk, scan_topk

#: row-tile target in bytes of the plain scan
_TILE_BYTES = 32 * 1024 * 1024
#: elements of the ``[Q, T, D]`` intermediate of a broadcast metric's tile
#: (divergence, user-defined metrics)
_BROADCAST_TILE_ELEMS = 16 * 1024 * 1024


def resolve_device(device) -> torch.device:
    """The device of an entry point; a CUDA device that is absent raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def pad_rows(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_queries(n: int) -> int:
    """Query counts bucketed to powers of two (at least 8)."""
    return max(8, 1 << (n - 1).bit_length())


def storage_width(kind: ScalarKind, ndim: int) -> int:
    """Stored row width: dims padded to a multiple of 128; for b1 the
    packed bytes, ``ceil(ndim / 8)``, padded to a multiple of 128."""
    if kind == ScalarKind.B1:
        return pad_rows((ndim + 7) // 8, 128)
    return pad_rows(ndim, 128)


def pick_tile_rows(n_rows: int, row_bytes: int, metric=None, ndim: int = 0, n_queries: int = 0,
                   metric_fn=None) -> int:
    """Rows per tile of the plain scan: a power of two near 32 MB, and for
    the metrics scored through a ``[Q, T, D]`` intermediate (divergence, a
    user-defined metric) at most `_BROADCAST_TILE_ELEMS` of it."""
    tile = _TILE_BYTES // max(row_bytes, 1)
    if metric == MetricKind.Divergence or metric_fn is not None:
        tile = min(tile, max(_BROADCAST_TILE_ELEMS // max(n_queries * max(ndim, 1), 1), 8))
    tile = 1 << max(int(math.floor(math.log2(max(tile, 8)))), 3)
    return min(tile, n_rows)


def prepare_set_rows(vectors, width: int) -> torch.Tensor:
    """Integer-set rows (-1 padding) as an int32 CPU tensor padded with -1
    to ``width`` columns."""
    rows = torch.as_tensor(np.atleast_2d(np.asarray(vectors, dtype=np.int32)))
    return torch.nn.functional.pad(rows, (0, width - rows.shape[-1]), value=-1)


def prepare_rows(vectors, input_kind: ScalarKind, kind: ScalarKind, ndim: int) -> torch.Tensor:
    """Host cast and zero-pad of a ``[B, ndim]`` batch (packed bytes for b1
    input) to ``[B, width]`` (a CPU tensor of the storage dtype)."""
    rows = cast_vectors(np.atleast_2d(vectors), input_kind, kind, ndim)
    width = storage_width(kind, ndim)
    return torch.nn.functional.pad(rows, (0, width - rows.shape[-1]))


def kernel_tiles(metric, kind, n_q: int, n_rows: int, k: int, approx: bool,
                 metric_fn=None) -> Optional[Tuple[int, int]]:
    """(q_tile, t_tile) when the scan kernels serve this search, else None.

    The gates of the JAX package's `_pallas_tiles`, unchanged: k <= 128
    approximate and k <= 32 exact, a supported (metric, dtype), t_tile from
    8192 halved down to 512 until it divides the rows with at least two
    tiles, q_tile = min(512, Q) dividing Q. The CUDA kernels take any
    multiple of 128 rows; the tiles only keep both packages on one path.
    A user-defined metric never takes them."""
    if metric_fn is not None or k > (128 if approx else 32) or not supports(metric, kind):
        return None
    t_tile = 8192
    while t_tile > 512 and n_rows % t_tile:
        t_tile //= 2
    if n_rows % t_tile or n_rows < 2 * t_tile:
        return None
    q_tile = min(512, n_q)
    if n_q % q_tile:
        return None
    return q_tile, t_tile


def search_steps(metric, kind, q, table, stats, valid, ndim: int, k: int, tile_rows: int,
                 approx: bool = False, metric_fn=None):
    """`search_kernel` as a step generator: B2's exact search yields after
    each launch group (`ops.scan.exact_steps`), every other route runs
    whole at the first step; returns what `search_kernel` does. Packed b1
    rows under hamming, tanimoto or sorensen take `bitscan.bit_scan`,
    ranked in bf16 exactly where the JAX scan is (`bitscan.rounds`)."""
    if kernel_tiles(metric, kind, q.shape[0], table.shape[0], k, approx, metric_fn) is not None:
        if approx:
            # f32 storage ranks bins on bf16-rounded dots and rescores
            # scan.OVERSAMPLE * k candidates exactly (compact mode)
            compact = kind in (ScalarKind.F32, ScalarKind.F16)
            return search_binned(metric, q, table, stats, valid, k, compact=compact)
        return (yield from exact_steps(metric, q, table, stats, valid, k))
    if bitscan.serves(metric, kind, k, metric_fn):
        return bitscan.search(metric, q, table, stats, valid, k, bitscan.rounds(approx, table.shape[0], k, tile_rows))
    q_stats = row_stats(q, kind)
    if table.shape[0] <= tile_rows:
        return masked_topk(tile_dists(metric, kind, q, q_stats, table, stats, ndim, metric_fn), valid, k)
    return scan_topk(metric, kind, q, q_stats, table, stats, valid, k, tile_rows, ndim, approx, metric_fn)


def search_kernel(metric, kind, q, table, stats, valid, ndim: int, k: int, tile_rows: int,
                  approx: bool = False, metric_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of prepared queries against a prepared table: ``[Q, k]`` f32
    distances and i32 rows (-1 where none). ``metric_fn`` is a
    user-defined metric."""
    return run_steps(search_steps(metric, kind, q, table, stats, valid, ndim, k, tile_rows, approx, metric_fn))


def exact_search(dataset, queries, count: int = 10, metric=MetricKind.IP, dtype=None, *,
                 device="cuda", threads: int = 0, log: bool = False, progress=None) -> BatchMatches:
    """Brute-force search of ``queries`` against the rows of ``dataset``;
    keys are dataset row numbers. Runs on ``device`` (the card by default).
    A uint8 dataset is packed bits (b1), ``8 x`` its columns wide; with
    ``metric="jaccard"`` rows are integer sets padded with -1."""
    dev = resolve_device(device)
    metric = normalize_metric(metric)
    dataset = np.atleast_2d(dataset)
    queries = np.atleast_2d(queries)
    n_rows, ndim = dataset.shape
    n_q = queries.shape[0]
    count = min(count, n_rows)
    in_kind = kind_of_dtype(dataset.dtype)
    kind = normalize_dtype(dtype, metric=metric) if dtype is not None else in_kind
    if in_kind == ScalarKind.B1:
        ndim, kind = ndim * 8, ScalarKind.B1
    # f64 rows are f32 on the device and search as f64: the plain scan, as
    # in the JAX package (the kernels take f32)
    cast_kind = ScalarKind.F32 if kind == ScalarKind.F64 else kind

    if n_rows > 64 * 1024:
        n_pad = 1 << (n_rows - 1).bit_length()
    elif n_rows >= 1024:
        n_pad = pad_rows(n_rows, 512)  # t_tile = 512 always divides
    else:
        n_pad = pad_rows(n_rows, 8)
    pad_value = 0
    if metric == MetricKind.Jaccard:
        kind, pad_value = ScalarKind.F32, -1  # int32 sets; the kind only names the stats
        width = pad_rows(max(dataset.shape[1], queries.shape[1]), 8)
        table, q = prepare_set_rows(dataset, width), prepare_set_rows(queries, width)
    else:
        table = prepare_rows(dataset, in_kind, cast_kind, ndim)
        q = prepare_rows(queries, kind_of_dtype(queries.dtype), cast_kind, ndim)
    q_pad = pad_queries(n_q)
    table = torch.nn.functional.pad(table, (0, 0, 0, n_pad - n_rows), value=pad_value).to(dev)
    q = torch.nn.functional.pad(q, (0, 0, 0, q_pad - n_q), value=pad_value).to(dev)
    stats = row_stats(table, kind)
    valid = torch.arange(n_pad, device=dev) < n_rows

    tile_rows = pick_tile_rows(n_pad, table.shape[1] * table.element_size(), metric, ndim, q_pad)
    while n_pad % tile_rows:
        tile_rows //= 2
    d, i = search_kernel(metric, kind, q, table, stats, valid, ndim, count, tile_rows)
    d = d[:n_q].cpu().numpy()
    i = i[:n_q].cpu().numpy()
    return BatchMatches(
        keys=np.where(i >= 0, i, 0).astype(np.uint64),
        distances=d.astype(np.float32),
        counts=np.sum(i >= 0, axis=1).astype(np.uint64),
        computed_distances=int(n_rows) * n_q,
    )
