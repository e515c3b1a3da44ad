"""Distances: the dot-product metrics as one product plus a float epilogue,
and the metric tail as broadcast formulas.

Counterpart of `usearch_tpu/ops/distances.py`. ip, cos, l2sq and pearson
over numeric rows, and hamming, tanimoto and sorensen over packed b1 rows,
are scored from one product and per-row stats (squared norm and sum;
popcount and 0 for b1) kept beside the table, so a scan reads each stored
byte once and the epilogue needs only the product (for b1 the and-count).
Every other pairing the JAX package accepts goes through the same
epilogue: the dot metrics over b1 rows (on their and-counts and
popcounts), the binary metrics over numeric rows (their squared norms in
the popcounts' place). Formulas and zero-denominator rules are those of the
reference, term for term, so that where the product is exact (i8, b1) the
distances agree bit for bit.

The metric tail has no product to share: haversine over (lat, lon) degree
pairs, Jensen-Shannon divergence and jaccard over padded integer sets (-1
is the padding) are scored by their own formulas, and a user-defined
metric (`enums.CompiledMetric`, a torch callable of two rows) by
`torch.func.vmap` over every pair. Jaccard's intersections are counted
exactly, by an indicator product over a tile (`jaccard_set_dists`) or a
search in each candidate's sorted row (`gathered_dists`), where the JAX
package compares every pair of entries.
"""

from __future__ import annotations

import torch

import numpy as np

from ..enums import MetricKind, MetricKindBitwise, ScalarKind
from .packbits import bit_dot, popcount_bytes

#: Large-but-finite f32 sentinel added to deleted rows; ``MASKED + d`` stays
#: finite in f32 and in bf16 (3e38 rounds to ~3.004e38 < bf16's maximum).
MASKED = 3.0e38

#: i8 products summed in f32 are exact while ``width * 128**2 <= 2**24``
#: (stored i8 may hold -128 when rows arrive as int8 tensors).
I8_F32_EXACT_WIDTH = (1 << 24) // (128 * 128)

_F32_EPS = float(np.finfo(np.float32).eps)
#: degrees to radians, rounded to f32 as the JAX package's constant
_DEG2RAD = float(np.float32(np.pi / 180.0))
#: elements of the indicator matrix of one jaccard tile step
_SET_TILE_ELEMS = 1 << 25


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
        raise ValueError(f"Not a dot-derived metric: {metric}")
    return dists_from_dots(metric, dots, q_sq, t_sq)


def dot_metric_dists(metric, dots, q_stats, t_stats, ndim: int) -> torch.Tensor:
    """Raw dots ``[Q, T]`` to distances for ip/cos/l2sq/pearson, and for
    the binary metrics from and-counts and popcount stats."""
    return _metric_dists(metric, dots.float(), q_stats[:, 0, None], q_stats[:, 1, None], t_stats[None, :, 0],
                         t_stats[None, :, 1], ndim)


# ----------------------------------------------------------------------
# The metric tail
# ----------------------------------------------------------------------


def _haversine(lat_q, lon_q, lat_t, lon_t) -> torch.Tensor:
    dlat = (lat_t - lat_q) * _DEG2RAD / 2.0
    dlon = (lon_t - lon_q) * _DEG2RAD / 2.0
    x = torch.sin(dlat) ** 2 + torch.cos(lat_q * _DEG2RAD) * torch.cos(lat_t * _DEG2RAD) * torch.sin(dlon) ** 2
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(x, 0.0, 1.0)))


def haversine_dists(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Great-circle distance of (lat, lon) degree pairs in columns 0 and 1:
    ``[Q, W] x [T, W] -> [Q, T]``."""
    q, t = q.float(), t.float()
    return _haversine(q[:, 0, None], q[:, 1, None], t[None, :, 0], t[None, :, 1])


def _divergence(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon divergence of broadcast rows, over the last axis."""
    m = (p + r) / 2.0 + _F32_EPS
    kld_pm = (p * torch.log((p + _F32_EPS) / m)).sum(dim=-1)
    kld_qm = (r * torch.log((r + _F32_EPS) / m)).sum(dim=-1)
    return (kld_pm + kld_qm) / 2.0


def divergence_dists(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon divergence, ``[Q, D] x [T, D] -> [Q, T]``, through a
    ``[Q, T, D]`` intermediate: callers keep tiles small."""
    return _divergence(q.float()[:, None, :], t.float()[None, :, :])


def _jaccard(inter, len_q, len_t) -> torch.Tensor:
    union = len_q + len_t - inter
    return torch.where(union == 0.0, 0.0, 1.0 - inter / torch.where(union == 0.0, 1.0, union))


def _set_intersections(q: torch.Tensor, t: torch.Tensor, sentinel: int) -> torch.Tensor:
    """``[Q, T]`` f32: how many of query ``i``'s entries (counted with
    their repeats) occur in row ``j``, as an indicator product: ``A [T, E]``
    marks which of the queries' ``E`` distinct elements each row holds,
    ``M [E, Q]`` counts them in each query, and ``A @ M`` is exact (0/1
    times small counts)."""
    n_q, n_t = q.shape[0], t.shape[0]
    q_ok = q != sentinel
    elems = torch.unique(q[q_ok])
    e = elems.numel()
    if e == 0:
        return torch.zeros((n_q, n_t), dtype=torch.float32, device=q.device)
    pos = torch.where(q_ok, torch.searchsorted(elems, q.contiguous()), e)
    counts = torch.zeros((e + 1, n_q), dtype=torch.float32, device=q.device)
    qid = torch.arange(n_q, device=q.device)[:, None].expand_as(pos)
    counts.index_put_((pos.reshape(-1), qid.reshape(-1)), torch.ones(pos.numel(), device=q.device),
                      accumulate=True)
    counts = counts[:e]
    out = torch.empty((n_t, n_q), dtype=torch.float32, device=q.device)
    step = max(_SET_TILE_ELEMS // (e + 1), 1)
    for lo in range(0, n_t, step):
        tt = t[lo : lo + step].contiguous()
        p = torch.searchsorted(elems, tt).clamp_max(e - 1)
        hit = (elems[p] == tt) & (tt != sentinel)
        ind = torch.zeros((tt.shape[0], e + 1), dtype=torch.float32, device=q.device)
        ind.scatter_(1, torch.where(hit, p, e), 1.0)
        out[lo : lo + step] = ind[:, :e] @ counts
    return out.T


def jaccard_set_dists(q: torch.Tensor, t: torch.Tensor, sentinel: int = -1) -> torch.Tensor:
    """Jaccard distance of padded integer sets (entries equal to
    ``sentinel`` are padding; a row's elements are unique), ``[Q, Wq] x
    [T, Wt] -> [Q, T]``."""
    q, t = q.to(torch.int32), t.to(torch.int32)
    len_q = (q != sentinel).sum(dim=-1).float()
    len_t = (t != sentinel).sum(dim=-1).float()
    return _jaccard(_set_intersections(q, t, sentinel), len_q[:, None], len_t[None, :])


def _gathered_intersections(qc: torch.Tensor, rows: torch.Tensor, sentinel: int) -> torch.Tensor:
    """``[Q, X]`` f32: how many of query ``i``'s entries occur in its
    candidate row ``x``, each entry searched in the row sorted with its
    padding moved past its elements."""
    n_q, x, wt = rows.shape
    big = torch.iinfo(torch.int32).max
    srt = torch.where(rows == sentinel, big, rows).sort(dim=-1).values.reshape(n_q * x, wt)
    n_t = (rows != sentinel).sum(dim=-1).reshape(-1, 1)
    vals = qc[:, None, :].expand(n_q, x, qc.shape[-1]).reshape(n_q * x, -1).contiguous()
    idx = torch.searchsorted(srt, vals)
    found = (idx < n_t) & (srt.gather(1, idx.clamp_max(wt - 1)) == vals) & (vals != sentinel)
    return found.sum(dim=-1).reshape(n_q, x).float()


def _udf_pairs(metric_fn, q: torch.Tensor, t: torch.Tensor, own_rows: bool) -> torch.Tensor:
    """A user-defined metric of f32 rows by `torch.func.vmap`: every query
    against every row of ``t [T, W]``, or (``own_rows``) against its own
    rows of ``t [Q, X, W]``."""
    per_row = torch.func.vmap(metric_fn, in_dims=(None, 0))
    return torch.func.vmap(per_row, in_dims=(0, 0 if own_rows else None))(q.float(), t.float()).float()


def tile_dists(metric, kind, q, q_stats, tile, tile_stats, ndim: int, metric_fn=None) -> torch.Tensor:
    """Distances of queries against one table tile, ``[Q, T]`` f32.
    ``metric_fn``, a user-defined metric, takes precedence over ``metric``.
    Packed b1 rows are multiplied in one wide product (`bit_dot`)."""
    if metric_fn is not None:
        return _udf_pairs(metric_fn, q, tile, own_rows=False)
    if metric == MetricKind.Haversine:
        return haversine_dists(q, tile)
    if metric == MetricKind.Divergence:
        return divergence_dists(q, tile)
    if metric == MetricKind.Jaccard:
        return jaccard_set_dists(q, tile)
    dots = bit_dot(q, tile) if kind == ScalarKind.B1 else dot(q, tile)
    return dot_metric_dists(metric, dots, q_stats, tile_stats, ndim)


def gathered_dists(metric, kind, qc: torch.Tensor, rows: torch.Tensor, ndim: int, metric_fn=None) -> torch.Tensor:
    """Distances of each query against its own gathered rows, ``qc [Q, W]``
    and ``rows [Q, X, W]`` to ``[Q, X]`` f32: the probe's scoring for the
    metrics with no product (haversine, divergence, jaccard) and for
    user-defined metrics."""
    if metric_fn is not None:
        return _udf_pairs(metric_fn, qc, rows, own_rows=True)
    if metric == MetricKind.Haversine:
        q, t = qc.float(), rows.float()
        return _haversine(q[:, 0, None], q[:, 1, None], t[..., 0], t[..., 1])
    if metric == MetricKind.Divergence:
        return _divergence(qc.float()[:, None, :], rows.float())
    if metric == MetricKind.Jaccard:
        q, t = qc.to(torch.int32), rows.to(torch.int32)
        len_q = (q != -1).sum(dim=-1).float()
        len_t = (t != -1).sum(dim=-1).float()
        return _jaccard(_gathered_intersections(q, t, -1), len_q[:, None], len_t)
    raise ValueError(f"No gathered-candidate epilogue for metric: {metric}")


def pair_dists(metric, kind, a: torch.Tensor, b: torch.Tensor, ndim: int) -> torch.Tensor:
    """Row-wise distances of stored rows, ``a[i]`` against ``b[i]``: ``[N]``
    f32 (i8 dots summed exactly in i32, b1 stats the popcounts, as the JAX
    package's `pair_dists`)."""
    if metric in (MetricKind.Haversine, MetricKind.Divergence, MetricKind.Jaccard):
        return gathered_dists(metric, kind, a, b[:, None, :], ndim)[:, 0]
    if kind == ScalarKind.B1:
        dots = bit_dot(a[:, None, :], b[:, None, :])[:, 0, 0]
        pa, pb = popcount_bytes(a).float(), popcount_bytes(b).float()
        return _metric_dists(metric, dots, pa, pa, pb, pb, ndim)
    if kind == ScalarKind.I8:
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
