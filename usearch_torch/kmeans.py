"""k-means on the device: the IVF quantizer's fit.

Counterpart of `usearch_tpu/kmeans.py`: assignment scores bf16-rounded
operands with f32 sums, the centroid update accumulates one-hot sums in
f32, and Lloyd's loop stops on the reference's criteria (inertia change
below 1e-4, mean relative centroid shift below 1%, a wall clock limit, or
the iteration cap), with empty clusters reseeded at the farthest points; or,
``fused``, runs a fixed count of iterations with no host read, reseeding
empty clusters at hashed rows. Means are unit-normalized for cos and ip.
`kmeans_hierarchical` is the two-level fit of large cluster counts: a
coarse fit on a sample, sub-fits inside each coarse cluster, and a flat
nearest-centroid pass over all the centroids.

k-means++ seeding draws from a `torch.Generator`, so it cannot give the JAX
package's bits; tests start both packages from the same centroids.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .enums import MetricKind, normalize_metric
from .exact import resolve_device
from .ops.distances import _sqrt

#: point rows per assignment tile
ASSIGN_TILE = 16384
#: the largest cluster count seeded by k-means++ (random points above it)
KMEANSPP_MAX_K = 4096
_FAR = 3.0e38


def _dists(metric, t16: torch.Tensor, tile: torch.Tensor, c16: torch.Tensor, c_sq: torch.Tensor):
    """``[T, K]`` distances of a point tile to the centroids: bf16-rounded
    operands, f32 products and sums."""
    dots = t16.float() @ c16.float().T
    t_sq = (tile.float() ** 2).sum(dim=1, keepdim=True)
    if metric in (MetricKind.Cos, MetricKind.IP):
        prod = _sqrt(t_sq) * _sqrt(c_sq)[None, :]
        return 1.0 - dots / torch.where(prod == 0.0, 1.0, prod)
    return torch.clamp_min(t_sq + c_sq[None, :] - 2.0 * dots, 0.0)


def assign_flat(metric, points: torch.Tensor, centroids: torch.Tensor, point_tile: int = 8192,
                cent_tile: int = 16384, top2: bool = False):
    """Nearest centroid of every point, tiled over points and centroids so
    no score block exceeds ``point_tile x cent_tile``. ``points [N, D]``
    (``N % point_tile == 0``), ``centroids [K, D]`` f32. Returns
    ``(assignments i32 [N], distances f32 [N])``; with ``top2`` the two
    nearest distinct centroids, ``(a1, d1, a2, d2)``."""
    n, d = points.shape
    k = centroids.shape[0]
    if n % point_tile:
        raise ValueError(f"{n} points are not a multiple of the tile {point_tile}")
    k_pad = -(-k // cent_tile) * cent_tile
    dev = points.device
    cents = torch.cat([centroids.float(), centroids.new_zeros((k_pad - k, d), dtype=torch.float32)])
    c_pen = torch.where(torch.arange(k_pad, device=dev) < k, 0.0, _FAR)
    c_sq = (cents ** 2).sum(dim=1)
    c16 = cents.to(torch.bfloat16)
    outs = []
    for p0 in range(0, n, point_tile):
        tile = points[p0 : p0 + point_tile]
        t16 = tile.to(torch.bfloat16)
        b1d = torch.full((point_tile,), _FAR, device=dev)
        b2d = b1d.clone()
        b1i = torch.full((point_tile,), -1, dtype=torch.int32, device=dev)
        b2i = b1i.clone()
        for c0 in range(0, k_pad, cent_tile):
            sl = slice(c0, c0 + cent_tile)
            dists = _dists(metric, t16, tile, c16[sl], c_sq[sl]) + c_pen[None, sl]
            t1d, am1 = dists.min(dim=1)
            t1i = am1.int() + c0
            if not top2:
                better = t1d < b1d
                b1d, b1i = torch.where(better, t1d, b1d), torch.where(better, t1i, b1i)
                continue
            masked = dists.scatter(1, am1[:, None], _FAR)
            t2d, am2 = masked.min(dim=1)
            t2i = am2.int() + c0
            # merge the sorted pairs (b1 <= b2, t1 <= t2) into their top-2
            first = b1d <= t1d
            n1d, n1i = torch.where(first, b1d, t1d), torch.where(first, b1i, t1i)
            n2d = torch.where(first, torch.minimum(b2d, t1d), torch.minimum(t2d, b1d))
            n2i = torch.where(first, torch.where(b2d <= t1d, b2i, t1i), torch.where(t2d <= b1d, t2i, b1i))
            b1d, b1i, b2d, b2i = n1d, n1i, n2d, n2i
        outs.append((b1i, b1d, b2i, b2d) if top2 else (b1i, b1d))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _assign_step(metric, points: torch.Tensor, centroids: torch.Tensor, tile_rows: int):
    """Assign every point to its nearest centroid: ``(assignments i32 [N],
    distances f32 [N], centroid sums f32 [K, D], member counts f32 [K])``."""
    n, d = points.shape
    k = centroids.shape[0]
    c16 = centroids.to(torch.bfloat16)
    c_sq = (centroids.float() ** 2).sum(dim=1)
    sums = torch.zeros((k, d), dtype=torch.float32, device=points.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=points.device)
    assigns, bests = [], []
    for p0 in range(0, n, tile_rows):
        tile = points[p0 : p0 + tile_rows]
        dists = _dists(metric, tile.to(torch.bfloat16), tile, c16, c_sq)
        best, assign = dists.min(dim=1)
        one_hot = torch.nn.functional.one_hot(assign, k).float()
        sums += one_hot.T @ tile.float()
        counts += one_hot.sum(dim=0)
        assigns.append(assign.int())
        bests.append(best)
    return torch.cat(assigns), torch.cat(bests), sums, counts


def _update_centroids(metric, sums: torch.Tensor, counts: torch.Tensor, old: torch.Tensor):
    """Means of the new members (unit-normalized for cos/ip); empty clusters
    keep their centroid. Returns ``(centroids, mean relative shift)``."""
    means = sums / torch.where(counts == 0, 1.0, counts)[:, None]
    if metric in (MetricKind.Cos, MetricKind.IP):
        norms = _sqrt((means * means).sum(dim=1, keepdim=True))
        means = means / torch.where(norms == 0, 1.0, norms)
    means = torch.where(counts[:, None] == 0, old, means)
    shift = _sqrt(((means - old) ** 2).sum(dim=1))
    scale = _sqrt((old ** 2).sum(dim=1))
    return means, (shift / torch.where(scale == 0, 1.0, scale)).mean()


def _kmeanspp_init(points: torch.Tensor, gen: torch.Generator, k: int) -> torch.Tensor:
    """k-means++ seeding: each step scores every point against the latest
    center and draws the next with probability proportional to its squared
    distance to the nearest center (Gumbel-max). Points are cast to f32 one
    row tile at a time, never as a whole copy of the table."""
    n, d = points.shape
    budget_rows = max(8, (128 * 1024 * 1024) // max(d * 4, 1))
    tile = min(1 << (budget_rows.bit_length() - 1), n)
    dev = points.device

    def per_tile(fn):
        return torch.cat([fn(points[r : r + tile].float()) for r in range(0, n, tile)])

    sq = per_tile(lambda b: (b * b).sum(dim=1))
    last = torch.randint(0, n, (), generator=gen, device=dev)
    chosen = [last]
    min_d = torch.full((n,), float("inf"), device=dev)
    for _ in range(k - 1):
        c = points[last].float()
        dist = torch.clamp_min(sq + (c * c).sum() - 2.0 * per_tile(lambda b: b @ c), 0.0)
        min_d = torch.minimum(min_d, dist)
        u = torch.rand((n,), generator=gen, device=dev).clamp_(min=1e-12)
        gumbel = -torch.log(-torch.log(u))
        scores = torch.where(min_d > 0, torch.log(torch.clamp_min(min_d, 1e-30)) + gumbel, -float("inf"))
        last = torch.argmax(scores)
        chosen.append(last)
    return points[torch.stack(chosen)].float()


def _as_points(points) -> torch.Tensor:
    """A tensor as it is (storage dtype, device); an array as f32 on the
    CPU."""
    if isinstance(points, torch.Tensor):
        return points
    return torch.as_tensor(np.ascontiguousarray(np.atleast_2d(points), dtype=np.float32))


def _drop_padding(assigns, sums, counts, pts: torch.Tensor, n_valid: int) -> None:
    """Take the padded rows (copies of row 0 past ``n_valid``) out of the
    centroid sums and counts, in place: they all share row 0's cluster."""
    n_pad = pts.shape[0]
    if n_valid < n_pad:
        pad = assigns[n_valid].long()
        sums[pad] -= pts[0].float() * float(n_pad - n_valid)
        counts[pad] -= float(n_pad - n_valid)


def _lloyd_fused(metric, pts: torch.Tensor, centroids: torch.Tensor, iters: int, tile_rows: int, n_valid: int):
    """Exactly ``iters`` Lloyd steps with no host read. ``pts`` past
    ``n_valid`` are copies of row 0, taken out of the sums. Empty clusters
    reseed at hashed rows, ``(c * 1103515245 + it * 40503) % n_valid`` in
    int32 arithmetic that wraps, as the JAX package computes it. Returns the
    final ``(assignments, distances, centroids)``."""
    iota = torch.arange(centroids.shape[0], dtype=torch.int64, device=pts.device)
    for it in range(iters):
        assigns, _, sums, counts = _assign_step(metric, pts, centroids, tile_rows)
        _drop_padding(assigns, sums, counts, pts, n_valid)
        new, _ = _update_centroids(metric, sums, counts, centroids)
        ridx = torch.remainder(_wrap_i32(_wrap_i32(iota * 1103515245) + it * 40503), n_valid)
        centroids = torch.where(counts[:, None] == 0, pts[ridx].float(), new)
    assigns, dists, _, _ = _assign_step(metric, pts, centroids, tile_rows)
    return assigns, dists, centroids


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values to what int32 arithmetic leaves of them (two's
    complement wrap)."""
    return torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)


def kmeans_fit(points, k: int, *, metric: MetricKind = MetricKind.L2sq, max_iterations: int = 300,
               inertia_threshold: float = 1e-4, max_seconds: float = 60.0, min_shift: float = 0.01,
               seed: Optional[int] = None, fused: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lloyd's algorithm. Returns ``(assignments i64 [N], distances f32 [N],
    centroids f32 [k, D])`` as numpy. ``points`` is a tensor (fit where it
    lies, in its storage dtype) or an array (fit on the CPU).

    ``fused`` runs exactly ``max_iterations`` steps with no early exit and
    no host read between them (the sub-fits of `kmeans_hierarchical`)."""
    pts = _as_points(points)
    n, d = pts.shape
    if n == 0:
        raise ValueError("kmeans needs at least one point")
    if k <= 0:
        raise ValueError(f"kmeans needs k >= 1 (got {k})")
    k = int(min(k, n))
    rng = np.random.default_rng(seed)

    # power-of-two sizes, padded with copies of row 0 whose share of the
    # centroid sums is taken out again below
    tile_rows = min(ASSIGN_TILE, max(8, 1 << (n - 1).bit_length()))
    n_pad = max(tile_rows, 1 << (n - 1).bit_length())
    if n_pad > n:
        pts = torch.cat([pts, pts[:1].expand(n_pad - n, d)])
    if k <= KMEANSPP_MAX_K:
        gen = torch.Generator(device=pts.device).manual_seed(int(rng.integers(0, 2**31)))
        centroids = _kmeanspp_init(pts, gen, k)
    else:
        rows = torch.as_tensor(rng.choice(n, size=k, replace=False), device=pts.device)
        centroids = pts[rows].float()

    if fused:
        assigns, dists, centroids = _lloyd_fused(metric, pts, centroids, int(max_iterations), tile_rows, n)
        return (assigns[:n].cpu().numpy().astype(np.int64), dists[:n].cpu().numpy().astype(np.float32),
                centroids.cpu().numpy().astype(np.float32))

    last_inertia = np.inf
    started = time.monotonic()
    for _ in range(int(max_iterations)):
        assigns, dists, sums, counts = _assign_step(metric, pts, centroids, tile_rows)
        _drop_padding(assigns, sums, counts, pts, n)
        centroids, rel_shift = _update_centroids(metric, sums, counts, centroids)
        empty = torch.nonzero(counts == 0).flatten()
        if len(empty):
            # reseed at the farthest points (the earlier point first on ties)
            far = torch.sort(dists[:n], descending=True, stable=True)[1][: len(empty)]
            centroids[empty] = pts[far].float()
        inertia = float(dists[:n].sum())
        if last_inertia != np.inf and last_inertia > 0:
            if abs(last_inertia - inertia) / last_inertia < inertia_threshold:
                break
        last_inertia = inertia
        if float(rel_shift) < min_shift:
            break
        if time.monotonic() - started > max_seconds:
            break

    assigns, dists, _, _ = _assign_step(metric, pts, centroids, tile_rows)
    return (
        assigns[:n].cpu().numpy().astype(np.int64),
        dists[:n].cpu().numpy().astype(np.float32),
        centroids.cpu().numpy().astype(np.float32),
    )


def _coarse_assign(metric, pts: torch.Tensor, coarse: torch.Tensor) -> np.ndarray:
    """Every point's nearest coarse centroid, tile by tile (the last tile
    ragged: no padded copy of the points)."""
    tile = min(ASSIGN_TILE, max(pts.shape[0], 1))
    assigns, _, _, _ = _assign_step(metric, pts, coarse, tile)
    return assigns.cpu().numpy()


def _flat_pass(metric, pts: torch.Tensor, centroids: np.ndarray) -> np.ndarray:
    """Every point's nearest centroid of the whole list (`assign_flat`):
    the tile-aligned rows in place, only the tail padded."""
    n, d = pts.shape
    k = centroids.shape[0]
    cent_tile = min(16384, 1 << (k - 1).bit_length())
    cents = torch.as_tensor(centroids, device=pts.device)
    point_tile = min(8192, 1 << (n - 1).bit_length())
    main = (n // point_tile) * point_tile
    parts = []
    if main:
        parts.append(assign_flat(metric, pts[:main], cents, point_tile, cent_tile)[0])
    if n > main:
        tail = torch.cat([pts[main:], pts[main : main + 1].expand(point_tile - (n - main), d)])
        parts.append(assign_flat(metric, tail, cents, point_tile, cent_tile)[0][: n - main])
    return torch.cat(parts).cpu().numpy().astype(np.int64)


def _assigned_dists(metric, pts: torch.Tensor, assigns: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Each point's f32 distance to its assigned centroid, in row tiles
    (no f32 copy of the points)."""
    cents = torch.as_tensor(centroids, device=pts.device)
    asg = torch.as_tensor(assigns, device=pts.device)
    tile = 1 << 17
    out = []
    for lo in range(0, pts.shape[0], tile):
        r = pts[lo : lo + tile].float()
        own = cents[asg[lo : lo + tile]]
        if metric in (MetricKind.Cos, MetricKind.IP):
            denom = torch.linalg.norm(r, dim=1) * torch.linalg.norm(own, dim=1)
            out.append(1.0 - (r * own).sum(dim=1) / torch.where(denom == 0, 1.0, denom))
        else:
            out.append(((r - own) ** 2).sum(dim=1))
    return torch.cat(out).cpu().numpy().astype(np.float32)


def kmeans_hierarchical(points, k: int, *, metric: MetricKind = MetricKind.L2sq, sample: int = 1 << 20,
                        max_iterations: int = 25, seed: Optional[int] = None, return_dists: bool = True,
                        flat_assign: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two-level k-means for large ``k``: ``ceil(sqrt(k))`` coarse centroids
    fit on ``sample`` rows (drawn by numpy's ``default_rng(seed)``, as the
    JAX package draws them), every point assigned once, then ``ceil(k /
    k1)`` centroids fit inside each coarse cluster (a cluster of at most
    that many members gives its members as centroids); every fit runs
    ``max_iterations`` fused steps. The assignment cost per step is
    ``N (sqrt(k) + k / sqrt(k)) D`` where the flat fit's is ``N k D``.

    ``flat_assign`` ends with one flat nearest-centroid pass over the whole
    list: top-down assignment strands points near coarse boundaries in cells
    that a flat-nearest probe never visits (in the JAX package, recall@10
    was capped at 0.66 at 100M x 96d without it). ``points`` keep their
    storage dtype where they lie; no f32 or padded copy of them is made.

    Returns ``(assignments i64 [N] into the centroid list, distances f32
    [N] (empty unless ``return_dists``), centroids f32 [k_actual, D])``."""
    pts = _as_points(points)
    n, d = pts.shape
    k = int(min(k, n))
    rng = np.random.default_rng(seed)
    k1 = max(1, int(math.ceil(math.sqrt(k))))
    k2 = max(1, int(math.ceil(k / k1)))

    train = pts[torch.as_tensor(rng.choice(n, size=sample, replace=False), device=pts.device)] if n > sample else pts
    _, _, coarse = kmeans_fit(train, k1, metric=metric, max_iterations=max_iterations, seed=seed, fused=True)
    coarse_assign = _coarse_assign(metric, pts, torch.as_tensor(coarse, device=pts.device))

    order = np.argsort(coarse_assign, kind="stable")
    bounds = np.searchsorted(coarse_assign[order], np.arange(coarse.shape[0] + 1))
    centroids_out = []
    assigns = np.zeros(n, dtype=np.int64)
    base = 0
    for c in range(coarse.shape[0]):
        members = order[bounds[c] : bounds[c + 1]]
        m = len(members)
        if m == 0:
            continue
        if m <= k2:
            sub_assign = np.arange(m, dtype=np.int64)
            sub_cents = pts[torch.as_tensor(members, device=pts.device)].float().cpu().numpy()
        else:
            # `kmeans_fit` pads the gather to a power of two with copies of
            # member 0, as the JAX package pads it before its fit
            sub_assign, _, sub_cents = kmeans_fit(pts[torch.as_tensor(members, device=pts.device)], min(k2, m),
                                                  metric=metric, max_iterations=max_iterations, seed=seed,
                                                  fused=True)
        assigns[members] = sub_assign + base
        base += sub_cents.shape[0]
        centroids_out.append(sub_cents)

    centroids = np.concatenate(centroids_out).astype(np.float32) if centroids_out else np.zeros((0, d), np.float32)
    if flat_assign and centroids.shape[0] > 1:
        # assignments only: the exact distances, when asked for, come below
        assigns = _flat_pass(metric, pts, centroids)
    if not return_dists:
        return assigns, np.zeros(0, np.float32), centroids
    return assigns, _assigned_dists(metric, pts, assigns, centroids), centroids


def kmeans(X, k: int, metric: str = "l2sq", dtype: str = "bf16", max_iterations: int = 300,
           inertia_threshold: float = 1e-4, max_seconds: float = 60.0, min_shifts: float = 0.01,
           seed: Optional[int] = None, *, device="cuda") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster the rows of ``X`` (the upstream `usearch.index.kmeans`):
    `kmeans_fit` over their f32 values on ``device`` (the card by default).
    Returns ``(assignments, distances, centroids)``. Scoring is always
    bf16 operands with f32 sums; ``dtype`` is accepted for the upstream
    signature and changes nothing, as in the JAX package."""
    return kmeans_fit(_as_points(X).to(resolve_device(device)), k, metric=normalize_metric(metric), max_iterations=max_iterations,
                      inertia_threshold=inertia_threshold, max_seconds=max_seconds, min_shift=min_shifts, seed=seed)
