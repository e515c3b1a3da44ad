"""Masked top-k and the plain streaming scan.

Counterpart of `usearch_tpu/ops/topk.py`. `scan_topk` is the path that
serves when the scan kernels' gate says no (f16 storage, pearson, large k),
as the XLA scan does in the JAX package. ``torch.topk`` is exact, but its
choice among equal values is unspecified, so the scans select on (distance,
row): a tile's top-k keeps the earlier row among equal distances, at the
k-th place too (`first_topk`), and merges sort by (distance, id), as
``lax.top_k``'s position order gives it over rows met in ascending order.
The IVF probe merges by position instead (`stable_topk`, `staged_topk`), as
its JAX counterpart does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .distances import MASKED, tile_dists


def topk_min(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row, ascending."""
    return torch.topk(d, k, dim=-1, largest=False, sorted=True)


def sort_pairs(d: torch.Tensor, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each row by (distance, id)."""
    order = torch.argsort(ids, dim=-1, stable=True)
    d, ids = d.gather(-1, order), ids.gather(-1, order)
    order = torch.argsort(d, dim=-1, stable=True)
    return d.gather(-1, order), ids.gather(-1, order)


def first_topk(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of ``d`` ``[Q, n]`` and their
    positions, ascending, the earlier position first among equal values
    (`stable_topk`'s answer) without sorting the row: ``torch.topk`` finds
    the k-th value, a second one over int32 keys takes the positions below
    it and then the first positions at it."""
    n = d.shape[-1]
    kth = torch.topk(d, k, dim=-1, largest=False, sorted=True).values[..., -1:]
    pos = torch.arange(n, dtype=torch.int32, device=d.device)
    key = torch.where(d < kth, pos, torch.where(d == kth, pos + n, 2 * n))
    sel = torch.topk(key, k, dim=-1, largest=False, sorted=True).values.long() % n
    return sort_pairs(d.gather(-1, sel), sel)


#: widest row that `ordered_topk` sorts whole: on the card a stable sort is
#: the faster form on rows of a few thousand entries, `first_topk` on the
#: exact search's surfaces of 8,192 bins
SORT_WIDTH = 4096


def ordered_topk(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`first_topk`'s answer, by whichever of its two forms is faster at the
    row's width: a stable sort (`stable_topk`) up to `SORT_WIDTH` entries,
    `first_topk`'s two selections past it."""
    if d.shape[-1] > SORT_WIDTH:
        return first_topk(d, k)
    v, sel = stable_topk(d, k)
    return v, sel.contiguous()


def finish(d: torch.Tensor, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort by (distance, id) and give masked results the id -1."""
    d, ids = sort_pairs(d, ids.to(torch.int32))
    return d, torch.where(d >= MASKED / 2, -1, ids)


def masked_topk(dists, valid, k: int, index_offset: int = 0):
    """Ascending top-k of a full ``[Q, N]`` matrix; rows where ``valid`` is
    False surface as ``MASKED`` with id -1."""
    if valid is not None:
        dists = torch.where(valid[None, :], dists, MASKED)
    d, idx = first_topk(dists, k)
    return finish(d, idx + index_offset)


def merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Best ``k`` of two ``[Q, k']`` candidate sets by (distance, id),
    ascending."""
    d, i = sort_pairs(torch.cat([d_a, d_b], dim=1), torch.cat([i_a, i_b], dim=1))
    return d[:, :k], i[:, :k]


def position_order(d: torch.Tensor) -> torch.Tensor:
    """Indices that sort the last dimension of f32 ``d`` ascending, the
    earlier position first among equal values (a stable sort). Adding 0.0
    turns -0.0 into 0.0, so a radix sort ties them as comparisons do."""
    return torch.sort(d.float() + 0.0, dim=-1, stable=True)[1]


def stable_topk(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row, ascending, the earlier
    position first among equal values (``lax.top_k``'s order)."""
    sel = position_order(d)[..., :k]
    return d.gather(-1, sel), sel


def staged_topk(dist: torch.Tensor, cand: torch.Tensor, kk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``kk`` of ``[Q, W]`` distances with their ``cand`` ids. The JAX
    package's `staged_topk` keeps 4 candidates per 128-lane column first and
    is exact only while no column holds more of the true top-kk; this one is
    exact always, with ``lax.top_k``'s tie order."""
    d, sel = stable_topk(dist, kk)
    return d, cand.gather(-1, sel)


def scan_topk(metric, kind, q, q_stats, table, stats, valid, k: int, tile_rows: int,
              ndim: int, approx: bool = False, metric_fn=None):
    """Tile-by-tile search of ``[Q, W]`` against ``[N, W]``, ``N`` a multiple
    of ``tile_rows``; only the running ``[Q, k]`` best stays between tiles.
    ``metric_fn`` is a user-defined metric (`distances.tile_dists`).

    ``approx`` ranks each tile on bf16-rounded distances, as the JAX scan
    does; exact searches never set it."""
    n_rows = table.shape[0]
    assert n_rows % tile_rows == 0, (n_rows, tile_rows)
    n_q = q.shape[0]
    best_d = torch.full((n_q, k), MASKED, dtype=torch.float32, device=q.device)
    best_i = torch.full((n_q, k), -1, dtype=torch.int64, device=q.device)
    for off in range(0, n_rows, tile_rows):
        sl = slice(off, off + tile_rows)
        d = tile_dists(metric, kind, q, q_stats, table[sl], stats[sl], ndim, metric_fn)
        d = torch.where(valid[None, sl], d, MASKED)
        if approx and tile_rows >= 4 * k * 128:
            d = d.to(torch.bfloat16).float()
        d, ids = first_topk(d, min(k, tile_rows))
        best_d, best_i = merge_topk(best_d, best_i, d, ids + off, k)
    return finish(best_d, best_i)
