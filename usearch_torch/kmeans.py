"""k-means on the device: the IVF quantizer's fit.

Counterpart of the flat fit of `usearch_tpu/kmeans.py`: assignment scores
bf16-rounded operands with f32 sums, the centroid update accumulates
one-hot sums in f32, and Lloyd's loop stops on the reference's criteria
(inertia change below 1e-4, mean relative centroid shift below 1%, a wall
clock limit, or the iteration cap). Empty clusters are reseeded at the
farthest points. Means are unit-normalized for cos and ip.

k-means++ seeding draws from a `torch.Generator`, so it cannot give the JAX
package's bits; tests start both packages from the same centroids. The
two-level fit (`kmeans_hierarchical`) is not ported (ROADMAP A.4b).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .enums import MetricKind
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


def kmeans_fit(points, k: int, *, metric: MetricKind = MetricKind.L2sq, max_iterations: int = 300,
               inertia_threshold: float = 1e-4, max_seconds: float = 60.0, min_shift: float = 0.01,
               seed: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lloyd's algorithm. Returns ``(assignments i64 [N], distances f32 [N],
    centroids f32 [k, D])`` as numpy. ``points`` is a tensor (fit where it
    lies, in its storage dtype) or an array (fit on the CPU)."""
    if isinstance(points, torch.Tensor):
        pts = points
    else:
        pts = torch.as_tensor(np.ascontiguousarray(np.atleast_2d(points), dtype=np.float32))
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

    last_inertia = np.inf
    started = time.monotonic()
    for _ in range(int(max_iterations)):
        assigns, dists, sums, counts = _assign_step(metric, pts, centroids, tile_rows)
        if n_pad > n:
            pad = assigns[n].long()
            sums[pad] -= pts[0].float() * float(n_pad - n)
            counts[pad] -= float(n_pad - n)
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
