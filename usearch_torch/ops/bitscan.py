"""The exact scan over packed b1 rows: kernel `usearch_bit_scan`, its plain
version, and the gate of the route.

Counterpart of the JAX package's XLA scan for b1 storage: no Pallas scan
kernel takes b1 rows, so `usearch_tpu/exact._search_kernel_xla` runs
`ops/topk.scan_topk` with `packbits.bit_dot` as the product. Both functions
here return, for every query, the ``k`` smallest (distance, row) pairs over
the live rows, ascending, the lower row first among equal distances (what
``lax.top_k`` keeps over rows met in ascending order), as ``[Q, k]`` f32
distances and int32 rows; past the live rows ``(MASKED, -1)``. Dead rows
are left out (their distance is replaced by ``MASKED``, never added to).
With ``round_bf16`` every distance is rounded to bf16 (to nearest even)
before it is ranked and returned, where the JAX scan ranks its tiles in
bf16: an approximate search over more than ``tile_rows`` rows whose tile
holds at least ``4 * k * 128`` rows.

`bit_scan` runs the kernel (csrc/bitscan.cu) for CUDA tensors and the plain
version for CPU tensors; there is no fallback between them. Its
``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..enums import MetricKind, ScalarKind
from ..graphs import count_launch
from .distances import MASKED, binary_dists, row_stats
from .packbits import unpack_bits
from .scan import KPAD, LANES, _launch, _ptr
from .topk import finish, first_topk, merge_topk

#: the kernel's metric codes (csrc/bitscan.cu; hamming is scan_common.cuh's)
METRIC_CODES = {MetricKind.Hamming: 3, MetricKind.Tanimoto: 4, MetricKind.Sorensen: 5}
#: widest packed row the kernel takes, in bytes (popcounts below 2^21)
MAX_WIDTH = 1 << 17
#: elements of the plain version's unpacked tile and of its distances
_PLAIN_ELEMS = 1 << 26
#: fewest 128-row tiles a split of the kernel scans
_MIN_SPLIT_TILES = 16
#: blocks of the kernel an SM holds at once (csrc/bitscan.cu kBlocksPerSM)
BLOCKS_PER_SM = 2


def serves(metric, kind, k: int, metric_fn=None) -> bool:
    """Whether a search takes `bit_scan`: packed b1 rows, hamming, tanimoto
    or sorensen, no user-defined metric, ``1 <= k <= KPAD``."""
    return metric_fn is None and kind == ScalarKind.B1 and metric in METRIC_CODES and 1 <= k <= KPAD


def rounds(approx: bool, n_rows: int, k: int, tile_rows: int) -> bool:
    """Where the JAX scan ranks in bf16 (usearch_tpu/ops/topk.py:131): an
    approximate search of more rows than one tile, tiles of at least
    ``4 * k * 128`` rows. A table of one tile takes its exact top-k."""
    return approx and n_rows > tile_rows and tile_rows >= 4 * k * 128


def _check(metric, q, table, q_pop, t_pop, valid, k: int) -> None:
    if metric not in METRIC_CODES:
        raise ValueError(f"the bit scan takes hamming/tanimoto/sorensen, got {metric}")
    if q.dtype != torch.uint8 or table.dtype != torch.uint8:
        raise TypeError(f"q and table must be packed uint8 rows: {q.dtype}, {table.dtype}")
    if q.dim() != 2 or table.dim() != 2 or q.shape[1] != table.shape[1]:
        raise ValueError(f"q [Q, W] and table [N, W] expected: {tuple(q.shape)}, {tuple(table.shape)}")
    width = table.shape[1]
    if width % LANES or not LANES <= width <= MAX_WIDTH:
        raise ValueError(f"rows must be a multiple of {LANES} bytes, at most {MAX_WIDTH}: {width}")
    if not 1 <= k <= KPAD:
        raise ValueError(f"k must be in [1, {KPAD}], got {k}")
    for x, length in ((q_pop, q.shape[0]), (t_pop, table.shape[0])):
        if x.dtype != torch.float32 or x.shape != (length,):
            raise ValueError(f"popcounts must be f32 of length {length}")
    if valid.dtype != torch.bool or valid.shape != (table.shape[0],):
        raise ValueError(f"valid must be a bool mask of length {table.shape[0]}")
    for x in (q, table, valid):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError("q, table and valid must be contiguous and on one device")
    if q_pop.device != q.device or t_pop.device != q.device:
        raise ValueError("the popcounts must lie on the rows' device")


def bit_scan_plain(metric, q, table, q_pop, t_pop, valid, k: int, round_bf16: bool = False):
    """What `bit_scan` computes, in plain torch: the and-counts of the
    unpacked 0/1 bits in f32 (exact: integers below 2^24),
    `distances.binary_dists`, and a running selection on (distance, row)
    over row tiles small enough for the card at the main path's shape."""
    n_q, (n, width) = q.shape[0], table.shape
    bits_q = unpack_bits(q).float()
    qp = q_pop.float()[:, None]
    tile = max(LANES, min(n, _PLAIN_ELEMS // (8 * width), _PLAIN_ELEMS // max(n_q, 1)) // LANES * LANES)
    best_d = torch.full((n_q, k), MASKED, dtype=torch.float32, device=q.device)
    best_i = torch.full((n_q, k), -1, dtype=torch.int64, device=q.device)
    for lo in range(0, n, tile):
        hi = min(n, lo + tile)
        dots = bits_q @ unpack_bits(table[lo:hi]).float().T
        d = binary_dists(metric, dots, qp, t_pop[None, lo:hi].float())
        if round_bf16:
            d = d.to(torch.bfloat16).float()
        d = torch.where(valid[None, lo:hi], d, MASKED)
        d, rows = first_topk(d, min(k, hi - lo))
        best_d, best_i = merge_topk(best_d, best_i, d, rows + lo, k)
    return finish(best_d, best_i)


#: the card's streaming multiprocessors, by device index
_SMS: dict = {}


def splits_for(device: torch.device, n_q: int, n_rows: int) -> Tuple[int, int]:
    """``(split_rows, splits)``: the table's rows cut so that the kernel's
    blocks (128 queries by a split, `BLOCKS_PER_SM` an SM) about fill the
    card, each split at least `_MIN_SPLIT_TILES` tiles of 128 rows."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    tiles = -(-n_rows // LANES)
    q_tiles = -(-n_q // (2 * 64))
    want = max(1, min(BLOCKS_PER_SM * sms // q_tiles, tiles // _MIN_SPLIT_TILES))
    split_tiles = -(-tiles // want)
    return split_tiles * LANES, -(-tiles // split_tiles)


def bit_scan(metric, q, table, q_pop, t_pop, valid, k: int, round_bf16: bool = False):
    """The exact b1 scan (csrc/bitscan.cu `usearch_bit_scan`), or its plain
    version for CPU tensors: ``[Q, k]`` f32 distances and int32 rows of the
    k smallest (distance, row) pairs over the live rows (module docstring).
    ``q_pop``/``t_pop`` are the rows' popcounts as f32, any stride (the
    stats' first column); ``valid`` a contiguous bool mask."""
    _check(metric, q, table, q_pop, t_pop, valid, k)
    if q.device.type == "cpu":
        return bit_scan_plain(metric, q, table, q_pop, t_pop, valid, k, round_bf16)
    from .. import build

    n_q, (n, width) = q.shape[0], table.shape
    if n_q == 0 or n == 0:
        return (torch.full((n_q, k), MASKED, dtype=torch.float32, device=q.device),
                torch.full((n_q, k), -1, dtype=torch.int32, device=q.device))
    out_d = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    if q.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("the bit scan reads rows through TMA: q and table must be 16-byte aligned")
    split_rows, splits = splits_for(q.device, n_q, n)
    part_d = part_i = None
    if splits > 1:
        part_d = torch.empty((splits, n_q, k), dtype=torch.float32, device=q.device)
        part_i = torch.empty((splits, n_q, k), dtype=torch.int32, device=q.device)
    lib = build.load("bitscan")
    with torch.cuda.device(q.device):
        _launch(
            lib.usearch_bit_scan, _ptr(q), _ptr(table), _ptr(q_pop), _ptr(t_pop), _ptr(valid), _ptr(out_d),
            _ptr(out_i), _ptr(part_d), _ptr(part_i), n_q, n, width, q_pop.stride(0), t_pop.stride(0),
            METRIC_CODES[metric], k, int(bool(round_bf16)), split_rows, splits,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    count_launch(bit_scan)
    return out_d, out_i


bit_scan.launches = 0


def search(metric, q, table, stats, valid, k: int, round_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """`bit_scan` of prepared packed queries against a prepared table and
    its stats (popcounts in the first column)."""
    return bit_scan(metric, q, table, row_stats(q, ScalarKind.B1)[:, 0], stats[:, 0], valid, k, round_bf16)
