"""Distances of the dot-product metrics: one product plus a float epilogue.

Counterpart of `usearch_tpu/ops/distances.py` for ip, cos, l2sq, pearson
and, over packed b1 rows, hamming, tanimoto and sorensen. Per-row stats
(squared norm and sum; popcount and 0 for b1) are kept beside the table, so
a scan reads each stored byte once and the epilogue needs only the product
(for b1 the and-count). Formulas and
zero-denominator rules are those of the reference, term for term, so that
where the product is exact (i8) the distances agree bit for bit.
"""

from __future__ import annotations

import torch

from ..enums import MetricKind, MetricKindBitwise, ScalarKind, is_ported
from .packbits import bit_dot, popcount_bytes

#: Large-but-finite f32 sentinel added to deleted rows; ``MASKED + d`` stays
#: finite in f32 and in bf16 (3e38 rounds to ~3.004e38 < bf16's maximum).
MASKED = 3.0e38

#: i8 products summed in f32 are exact while ``width * 128**2 <= 2**24``
#: (stored i8 may hold -128 when rows arrive as int8 tensors).
I8_F32_EXACT_WIDTH = (1 << 24) // (128 * 128)


def row_stats(rows: torch.Tensor, kind: ScalarKind) -> torch.Tensor:
    """Per-row ``(squared L2 norm, sum)`` as f32 ``[N, 2]``, ``(popcount,
    0)`` for packed b1 rows; zero padding leaves both unchanged."""
    if kind == ScalarKind.B1:
        pop = popcount_bytes(rows).float()
        return torch.stack([pop, torch.zeros_like(pop)], dim=-1)
    if kind == ScalarKind.I8:
        x = rows.to(torch.int32)
        sq = (x * x).sum(dim=-1).float()
        sm = x.sum(dim=-1).float()
    else:
        x = rows.float()
        sq = (x * x).sum(dim=-1)
        sm = x.sum(dim=-1)
    return torch.stack([sq, sm], dim=-1)


def dot(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``[Q, W] x [T, W] -> [Q, T]`` f32. i8 operands are multiplied in a
    float type that holds their sums exactly (no int matmul on the card)."""
    if q.dtype == torch.int8:
        acc = torch.float32 if q.shape[-1] <= I8_F32_EXACT_WIDTH else torch.float64
        return (q.to(acc) @ t.to(acc).T).float()
    return q.float() @ t.float().T


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root. torch's vectorized CPU sqrt may be
    off by an ulp; the root of an f32 taken in f64 and rounded back is exact,
    as the kernels' and XLA's are."""
    return torch.sqrt(x.double()).float()


def _cos(dots, q_sq, t_sq, off: float):
    # zero-norm rules of the reference's cos: both zero -> off - 1,
    # one zero -> off, else off - dot / (|q| |t|)
    denom = _sqrt(q_sq) * _sqrt(t_sq)
    safe = torch.where(denom == 0.0, 1.0, denom)
    base = off - dots / safe
    one_zero = (q_sq == 0.0) ^ (t_sq == 0.0)
    both_zero = (q_sq == 0.0) & (t_sq == 0.0)
    return torch.where(both_zero, off - 1.0, torch.where(one_zero, off, base))


def _pearson(dots, q_sq, q_sum, t_sq, t_sum, ndim: int):
    n = float(ndim)
    num = n * dots - q_sum * t_sum
    den = (n * q_sq - q_sum * q_sum) * (n * t_sq - t_sum * t_sum)
    safe = torch.where(den <= 0.0, 1.0, den)
    return torch.where(den <= 0.0, 0.0, 1.0 - num / _sqrt(safe))


def dists_from_dots(metric, dots, q_sq, t_sq, shifted: bool = False) -> torch.Tensor:
    """ip/cos/l2sq distances from f32 dots; ``q_sq`` and ``t_sq`` broadcast
    against ``dots`` (``t_sq`` may be None for ip).

    ``shifted`` gives a per-query monotone transform instead of the distance
    (ip/cos drop the ``1 -`` offset, l2sq drops ``q_sq`` and the clamp): the
    ranking is unchanged, and values sit near 0 where bf16 resolves more."""
    if metric == MetricKind.IP:
        return -dots if shifted else 1.0 - dots
    if metric == MetricKind.Cos:
        return _cos(dots, q_sq, t_sq, 0.0 if shifted else 1.0)
    if metric == MetricKind.L2sq:
        if shifted:
            return t_sq - 2.0 * dots
        return torch.clamp_min(q_sq + t_sq - 2.0 * dots, 0.0)
    raise ValueError(f"expected ip/cos/l2sq, got {metric}")


def binary_dists(metric, dots, pop_q, pop_t) -> torch.Tensor:
    """hamming/tanimoto/sorensen from and-counts and popcounts that
    broadcast against them; an empty union or sum gives 0."""
    if metric == MetricKind.Hamming:
        return pop_q + pop_t - 2.0 * dots
    if metric == MetricKind.Tanimoto:
        union = pop_q + pop_t - dots
        return torch.where(union == 0.0, 0.0, 1.0 - dots / torch.where(union == 0.0, 1.0, union))
    if metric == MetricKind.Sorensen:
        denom = pop_q + pop_t
        return torch.where(denom == 0.0, 0.0, 1.0 - 2.0 * dots / torch.where(denom == 0.0, 1.0, denom))
    raise ValueError(f"expected hamming/tanimoto/sorensen, got {metric}")


def _metric_dists(metric, dots, q_sq, q_sum, t_sq, t_sum, ndim: int) -> torch.Tensor:
    """Distances from f32 dots and stats that broadcast against them."""
    if metric == MetricKind.Pearson:
        return _pearson(dots, q_sq, q_sum, t_sq, t_sum, ndim)
    if metric in MetricKindBitwise:
        return binary_dists(metric, dots, q_sq, t_sq)
    if metric not in (MetricKind.IP, MetricKind.Cos, MetricKind.L2sq):
        raise NotImplementedError(f"{metric.value} is not ported yet (ROADMAP queue A.7b)")
    return dists_from_dots(metric, dots, q_sq, t_sq)


def dot_metric_dists(metric, dots, q_stats, t_stats, ndim: int) -> torch.Tensor:
    """Raw dots ``[Q, T]`` to distances for ip/cos/l2sq/pearson, and for
    the binary metrics from and-counts and popcount stats."""
    return _metric_dists(metric, dots.float(), q_stats[:, 0, None], q_stats[:, 1, None], t_stats[None, :, 0],
                         t_stats[None, :, 1], ndim)


def pair_dists(metric, kind, a: torch.Tensor, b: torch.Tensor, ndim: int) -> torch.Tensor:
    """Row-wise distances of stored rows, ``a[i]`` against ``b[i]``: ``[N]``
    f32 (i8 dots summed exactly in i32, as the JAX package's
    `pair_dists`)."""
    if not is_ported(metric, kind):
        raise NotImplementedError(f"{metric.value}/{kind.value} is not ported yet (ROADMAP queue A.7b)")
    if kind == ScalarKind.B1:
        dots = bit_dot(a[:, None, :], b[:, None, :])[:, 0, 0]
    elif kind == ScalarKind.I8:
        dots = (a.to(torch.int32) * b.to(torch.int32)).sum(dim=-1).float()
    else:
        dots = (a.float() * b.float()).sum(dim=-1)
    sa, sb = row_stats(a, kind), row_stats(b, kind)
    return _metric_dists(metric, dots, sa[:, 0], sa[:, 1], sb[:, 0], sb[:, 1], ndim)


def scan_epilogue(metric, dots, q_sq, t_sq, penalty, shifted: bool = False) -> torch.Tensor:
    """The scan kernels' epilogue on ``[Q, T]`` dots, the deleted-row
    penalty included."""
    t_sq = None if t_sq is None else t_sq[None, :]
    return dists_from_dots(metric, dots.float(), q_sq[:, None], t_sq, shifted) + penalty[None, :]


def tile_dists(metric, kind, q, q_stats, tile, tile_stats, ndim: int) -> torch.Tensor:
    """Distances of queries against one table tile, ``[Q, T]`` f32. Packed
    b1 rows are unpacked and multiplied in one wide product (`bit_dot`)."""
    if not is_ported(metric, kind):
        raise NotImplementedError(f"{metric.value}/{kind.value} is not ported yet (ROADMAP queue A.7b)")
    dots = bit_dot(q, tile) if kind == ScalarKind.B1 else dot(q, tile)
    return dot_metric_dists(metric, dots, q_stats, tile_stats, ndim)
