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

On the card the steps a fit repeats are captured as CUDA graphs and
replayed (graphs.py `GraphCache.repeat`), the counterpart of the JAX
package's jitted programs: a k-means++ step, a fused Lloyd step and an
early-exit Lloyd step, each a graph a size bucket (`_Bucket`: the padded
point count, width, dtype, cluster count and tile) in a cache of the
top-level fit (`_fit_cache`). The row count, the iteration number and the
seeding's step are device scalars, so one graph serves every sub-fit of a
bucket. The CPU runs the same steps eagerly.
"""

from __future__ import annotations

import functools
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .enums import MetricKind, normalize_metric
from .exact import resolve_device
from .graphs import GraphCache
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


def _seed_tile(n: int, d: int) -> int:
    """Rows of the seeding's f32 tiles: at most 128 MiB each."""
    budget_rows = max(8, (128 * 1024 * 1024) // max(d * 4, 1))
    return min(1 << (budget_rows.bit_length() - 1), n)


def _per_tile(points: torch.Tensor, tile: int, fn, out=None) -> torch.Tensor:
    """``fn`` of the rows cast to f32 one tile at a time, never as a whole
    copy of the table, concatenated (into ``out`` where given)."""
    return torch.cat([fn(points[r : r + tile].float()) for r in range(0, points.shape[0], tile)], out=out)


def _seed_step(gen, points, sq, last, min_d, chosen, step):
    """One k-means++ step, in place: score every point against the latest
    center (``last [1]``), keep each point's squared distance to its nearest
    center (``min_d``), draw the next center with probability proportional
    to it (Gumbel-max over ``gen``'s uniforms) and write it at ``chosen[step
    + 1]``. No host read."""
    n, d = points.shape
    c = points.index_select(0, last).float()[0]
    dist = torch.clamp_min(sq + (c * c).sum() - 2.0 * _per_tile(points, _seed_tile(n, d), lambda b: b @ c), 0.0)
    min_d.copy_(torch.minimum(min_d, dist))
    u = torch.rand((n,), generator=gen, device=points.device).clamp_(min=1e-12)
    gumbel = -torch.log(-torch.log(u))
    scores = torch.where(min_d > 0, torch.log(torch.clamp_min(min_d, 1e-30)) + gumbel, -float("inf"))
    nxt = torch.argmax(scores).view(1)
    step += 1
    chosen.index_copy_(0, step, nxt)
    last.copy_(nxt)
    return ()


def _kmeanspp_init(points: torch.Tensor, gen: torch.Generator, k: int, b: "_Bucket") -> torch.Tensor:
    """k-means++ seeding: each step scores every point against the latest
    center and draws the next with probability proportional to its squared
    distance to the nearest center (Gumbel-max). Points are cast to f32 one
    row tile at a time, never as a whole copy of the table. The k - 1 steps
    run through bucket ``b``'s seeding graph (`_seed_step`; ``points`` are
    its points, its buffers the state)."""
    n, d = points.shape
    _per_tile(points, _seed_tile(n, d), lambda r: (r * r).sum(dim=1), out=b.sq)
    b.last.copy_(torch.randint(0, n, (), generator=gen, device=points.device).view(1))
    b.min_d.fill_(float("inf"))
    b.step.zero_()
    b.chosen[:1] = b.last
    b.run("seed", functools.partial(_seed_step, gen), (points, b.sq, b.last, b.min_d, b.chosen, b.step), k - 1,
          (b.last, b.min_d, b.chosen, b.step), (gen,))
    return points.index_select(0, b.chosen).float()


def _as_points(points) -> torch.Tensor:
    """A tensor as it is (storage dtype, device); an array as f32 on the
    CPU."""
    if isinstance(points, torch.Tensor):
        return points
    return torch.as_tensor(np.ascontiguousarray(np.atleast_2d(points), dtype=np.float32))


def _drop_padding(assigns, sums, counts, pts: torch.Tensor, n_valid: torch.Tensor) -> None:
    """Take the padded rows (copies of row 0 from ``n_valid``, a device
    scalar, on) out of the centroid sums and counts, in place and with no
    host read: they all share row 0's cluster, read at ``assigns[n_valid]``.
    Where no row is padded the sums and counts stay as they are."""
    n_pad = pts.shape[0]
    pad_n = (n_pad - n_valid).float().view(1)
    pad = assigns.index_select(0, torch.clamp_max(n_valid, n_pad - 1).view(1)).long()
    padded = pad_n > 0
    row, count = sums.index_select(0, pad), counts.index_select(0, pad)
    sums.index_copy_(0, pad, torch.where(padded, row - pts[0].float() * pad_n, row))
    counts.index_copy_(0, pad, torch.where(padded, count - pad_n, count))


def _lloyd_step(metric, tile_rows: int, pts, n_valid, centroids, it, assigns, dists):
    """One fused Lloyd step, in place and with no host read: ``assigns``
    and ``dists`` take the assignment to the centroids it starts from, the
    centroids become the means with empty clusters reseeded at hashed rows,
    ``(c * 1103515245 + it * 40503) % n_valid`` in int32 arithmetic that
    wraps, as the JAX package computes it, and ``it`` counts up."""
    a, dd, sums, counts = _assign_step(metric, pts, centroids, tile_rows)
    _drop_padding(a, sums, counts, pts, n_valid)
    new, _ = _update_centroids(metric, sums, counts, centroids)
    iota = torch.arange(centroids.shape[0], dtype=torch.int64, device=pts.device)
    ridx = torch.remainder(_wrap_i32(_wrap_i32(iota * 1103515245) + it * 40503), n_valid)
    centroids.copy_(torch.where(counts[:, None] == 0, pts[ridx].float(), new))
    it += 1
    assigns.copy_(a)
    dists.copy_(dd)
    return ()


def _loop_step(metric, tile_rows: int, n: int, pts, n_valid, centroids, assigns, dists, counts, scalars):
    """One step of the early-exit loop, in place and with no host read: the
    assignment to the centroids it starts from (``assigns``, ``dists``),
    the means (empty clusters keep their centroid) and the member
    ``counts``; ``scalars`` takes the inertia of the first ``n`` rows, the
    count of empty clusters and the mean relative shift."""
    a, dd, sums, cnt = _assign_step(metric, pts, centroids, tile_rows)
    _drop_padding(a, sums, cnt, pts, n_valid)
    new, rel_shift = _update_centroids(metric, sums, cnt, centroids)
    centroids.copy_(new)
    assigns.copy_(a)
    dists.copy_(dd)
    counts.copy_(cnt)
    scalars.copy_(torch.stack([dd[:n].sum(), (cnt == 0).sum().float(), rel_shift]))
    return ()


def _fit_cache(device: torch.device) -> Optional[GraphCache]:
    """The graph cache of one top-level fit on ``device``: the card's, or
    None off it (the steps run eagerly)."""
    return GraphCache(device) if device.type == "cuda" else None


class _Units:
    """The captured steps of one top-level fit: its graph cache and the
    count of its buckets (a bucket's serial number)."""

    def __init__(self, device: torch.device):
        self.cache = _fit_cache(torch.device(device))
        self.n_buckets = 0

    def run(self, key: tuple, body, args, times: int = 1, writes=(), generators=()) -> None:
        """``body(*args)``, a step that updates ``writes`` in place, run
        ``times`` times: through the graph of ``key`` (`GraphCache.repeat`),
        or eagerly where there is no cache."""
        if self.cache is None:
            for _ in range(times):
                body(*args)
        else:
            self.cache.repeat(key, 0, body, args, times, writes, generators)


class _Bucket:
    """The buffers of one size bucket of a top-level fit, which its graphs
    read by address: the points ``[n_pad, D]`` (past the valid rows copies
    of row 0), the valid row count, the centroids, the assignment and its
    distances, the Lloyd steps' counters and scalars, and the seeding's
    state and generator."""

    def __init__(self, units: _Units, metric, pts: torch.Tensor, k: int, tile_rows: int):
        n_pad, d = pts.shape
        dev = pts.device
        self.units, self.metric, self.pts, self.tile_rows = units, metric, pts, tile_rows
        self.key = (units.n_buckets, metric, pts.dtype, n_pad, d, k, tile_rows)
        units.n_buckets += 1
        self.n_valid = torch.zeros((), dtype=torch.int64, device=dev)
        self.centroids = torch.empty((k, d), dtype=torch.float32, device=dev)
        self.it = torch.zeros((), dtype=torch.int64, device=dev)
        self.assigns = torch.empty((n_pad,), dtype=torch.int32, device=dev)
        self.dists = torch.empty((n_pad,), dtype=torch.float32, device=dev)
        self.counts = torch.empty((k,), dtype=torch.float32, device=dev)
        self.scalars = torch.empty((3,), dtype=torch.float32, device=dev)
        self.gen = torch.Generator(device=dev)
        self.sq = torch.empty((n_pad,), dtype=torch.float32, device=dev)
        self.min_d = torch.empty((n_pad,), dtype=torch.float32, device=dev)
        self.last = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.chosen = torch.zeros((k,), dtype=torch.int64, device=dev)
        self.step = torch.zeros((1,), dtype=torch.int64, device=dev)

    def run(self, name: str, body, args, times: int = 1, writes=(), generators=()) -> None:
        self.units.run((name,) + self.key, body, args, times, writes, generators)

    def lloyd(self, times: int) -> None:
        """``times`` fused Lloyd steps (`_lloyd_step`)."""
        self.run("lloyd", functools.partial(_lloyd_step, self.metric, self.tile_rows),
                 (self.pts, self.n_valid, self.centroids, self.it, self.assigns, self.dists), times,
                 (self.centroids, self.it, self.assigns, self.dists))

    def loop(self, n: int) -> None:
        """One step of the early-exit loop over the first ``n`` rows
        (`_loop_step`)."""
        self.run(f"loop {n}", functools.partial(_loop_step, self.metric, self.tile_rows, n),
                 (self.pts, self.n_valid, self.centroids, self.assigns, self.dists, self.counts, self.scalars), 1,
                 (self.centroids, self.assigns, self.dists, self.counts, self.scalars))


def _final_step(bucket: _Bucket, step) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The assignment to the fit's final centroids: one more ``step`` (it
    writes the assignment to the centroids it starts from), whose update is
    dropped. Returns ``(assignments, distances, centroids)``."""
    centroids = bucket.centroids.clone()
    step()
    return bucket.assigns, bucket.dists, centroids


def _lloyd_fused(metric, pts: torch.Tensor, centroids: torch.Tensor, iters: int, tile_rows: int, n_valid: int,
                 bucket: Optional[_Bucket] = None):
    """Exactly ``iters`` Lloyd steps with no host read. ``pts`` past
    ``n_valid`` are copies of row 0, taken out of the sums. Empty clusters
    reseed at hashed rows, ``(c * 1103515245 + it * 40503) % n_valid`` in
    int32 arithmetic that wraps, as the JAX package computes it. The steps
    run through ``bucket``'s Lloyd graph (a bucket of its own over ``pts``
    where none is given). Returns the final ``(assignments, distances,
    centroids)``."""
    b = bucket or _Bucket(_Units(pts.device), metric, pts, centroids.shape[0], tile_rows)
    b.n_valid.fill_(n_valid)
    b.centroids.copy_(centroids)
    b.it.zero_()
    b.lloyd(iters)
    return _final_step(b, lambda: b.lloyd(1))


def _lloyd_loop(bucket: _Bucket, n: int, max_iterations: int, inertia_threshold: float, max_seconds: float,
                min_shift: float):
    """Lloyd's steps until an early exit (inertia change below
    ``inertia_threshold``, mean relative shift below ``min_shift``, the
    clock past ``max_seconds``) or ``max_iterations``, each a replay of
    ``bucket``'s loop graph and one copy of its scalars to the host; empty
    clusters reseed at the farthest points on the host's side. Returns
    ``(assignments, distances, centroids, steps run)``."""
    b, pts = bucket, bucket.pts
    last_inertia = np.inf
    started = time.monotonic()
    steps = 0
    for _ in range(int(max_iterations)):
        b.loop(n)
        steps += 1
        inertia, n_empty, rel_shift = b.scalars.tolist()
        if n_empty:
            # reseed at the farthest points (the earlier point first on ties)
            empty = torch.nonzero(b.counts == 0).flatten()
            far = torch.sort(b.dists[:n], descending=True, stable=True)[1][: len(empty)]
            b.centroids[empty] = pts[far].float()
        if last_inertia != np.inf and last_inertia > 0:
            if abs(last_inertia - inertia) / last_inertia < inertia_threshold:
                break
        last_inertia = inertia
        if rel_shift < min_shift:
            break
        if time.monotonic() - started > max_seconds:
            break
    return (*_final_step(b, lambda: b.loop(n)), steps)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values to what int32 arithmetic leaves of them (two's
    complement wrap)."""
    return torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)


def _fit_shape(n: int) -> Tuple[int, int]:
    """``(tile_rows, n_pad)`` of a fit of ``n`` rows: power-of-two sizes,
    padded with copies of row 0 whose share of the centroid sums is taken
    out again."""
    tile_rows = min(ASSIGN_TILE, max(8, 1 << (n - 1).bit_length()))
    return tile_rows, max(tile_rows, 1 << (n - 1).bit_length())


def _initial_centroids(bucket: _Bucket, n: int, k: int, rng: np.random.Generator) -> torch.Tensor:
    """k-means++ from ``rng``'s draw (`_kmeanspp_init`) up to
    `KMEANSPP_MAX_K` clusters, distinct random points above."""
    if k <= KMEANSPP_MAX_K:
        bucket.gen.manual_seed(int(rng.integers(0, 2**31)))
        return _kmeanspp_init(bucket.pts, bucket.gen, k, bucket)
    rows = torch.as_tensor(rng.choice(n, size=k, replace=False), device=bucket.pts.device)
    return bucket.pts[rows].float()


def _fit(units: _Units, pts: torch.Tensor, k: int, metric, max_iterations: int, inertia_threshold: float = 1e-4,
         max_seconds: float = 60.0, min_shift: float = 0.01, seed: Optional[int] = None, fused: bool = False):
    """`kmeans_fit` on the device: ``(assignments, distances, centroids)``
    of the ``n`` rows of ``pts`` as device tensors."""
    n, d = pts.shape
    k = int(min(k, n))
    rng = np.random.default_rng(seed)
    tile_rows, n_pad = _fit_shape(n)
    if n_pad > n:
        pts = torch.cat([pts, pts[:1].expand(n_pad - n, d)])
    b = _Bucket(units, metric, pts, k, tile_rows)
    centroids = _initial_centroids(b, n, k, rng)
    if fused:
        assigns, dists, centroids = _lloyd_fused(metric, pts, centroids, int(max_iterations), tile_rows, n, b)
    else:
        b.n_valid.fill_(n)
        b.centroids.copy_(centroids)
        assigns, dists, centroids, _ = _lloyd_loop(b, n, max_iterations, inertia_threshold, max_seconds, min_shift)
    return assigns[:n], dists[:n], centroids


def kmeans_fit(points, k: int, *, metric: MetricKind = MetricKind.L2sq, max_iterations: int = 300,
               inertia_threshold: float = 1e-4, max_seconds: float = 60.0, min_shift: float = 0.01,
               seed: Optional[int] = None, fused: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lloyd's algorithm. Returns ``(assignments i64 [N], distances f32 [N],
    centroids f32 [k, D])`` as numpy. ``points`` is a tensor (fit where it
    lies, in its storage dtype) or an array (fit on the CPU).

    ``fused`` runs exactly ``max_iterations`` steps with no early exit and
    no host read between them (the sub-fits of `kmeans_hierarchical`)."""
    pts = _as_points(points)
    if pts.shape[0] == 0:
        raise ValueError("kmeans needs at least one point")
    if k <= 0:
        raise ValueError(f"kmeans needs k >= 1 (got {k})")
    assigns, dists, centroids = _fit(_Units(pts.device), pts, k, metric, max_iterations, inertia_threshold,
                                     max_seconds, min_shift, seed, fused)
    return (assigns.cpu().numpy().astype(np.int64), dists.cpu().numpy().astype(np.float32),
            centroids.cpu().numpy().astype(np.float32))


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


def _sub_fit(bucket: _Bucket, pts: torch.Tensor, members: torch.Tensor, k: int, max_iterations: int,
             seed: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k`` centroids fit by `_lloyd_fused` over the rows ``members`` (a
    device tensor) of ``pts``, gathered straight into ``bucket``'s points
    (padded with copies of member 0, as the JAX package pads them), its
    graphs replayed. Returns the members' assignments (i32) and the
    centroids, on the device."""
    m, n_pad = members.shape[0], bucket.pts.shape[0]
    torch.index_select(pts, 0, torch.cat([members, members[:1].expand(n_pad - m)]), out=bucket.pts)
    init = _initial_centroids(bucket, m, k, np.random.default_rng(seed))
    assigns, _, centroids = _lloyd_fused(bucket.metric, bucket.pts, init, max_iterations, bucket.tile_rows, m, bucket)
    return assigns[:m].clone(), centroids


def _sub_bucket(units: _Units, metric, pts: torch.Tensor, m: int, k: int) -> _Bucket:
    """A bucket for sub-fits of ``m`` rows of ``pts`` into ``k`` centroids."""
    tile_rows, n_pad = _fit_shape(m)
    return _Bucket(units, metric, torch.empty((n_pad, pts.shape[1]), dtype=pts.dtype, device=pts.device), k,
                   tile_rows)


def _sub_fits(units: _Units, metric, pts: torch.Tensor, order: np.ndarray, bounds: np.ndarray, k2: int,
              max_iterations: int, seed: Optional[int]):
    """Level 2 of `kmeans_hierarchical`: inside each coarse cluster (its
    members ``order[bounds[c] : bounds[c + 1]]``) ``k2`` centroids fit by
    `_sub_fit` in its size bucket, or its members as centroids where there
    are at most ``k2``. Returns ``(assignments i32 into each cluster's own
    centroids, in ``order``'s order; centroids f32, cluster after cluster;
    each cluster's centroid count)``, the first two on the device."""
    sizes = np.diff(bounds)
    order = torch.as_tensor(order, device=pts.device)  # one upload: no sub-fit waits on a copy
    parts = {}
    bucket = None
    # a bucket's sub-fits one after another (any order gives the same
    # fits): its graphs are captured once and its buffers go after
    fitted = sorted((c for c in range(len(sizes)) if sizes[c] > k2), key=lambda c: _fit_shape(int(sizes[c]))[1])
    for c in fitted:
        if bucket is None or bucket.pts.shape[0] != _fit_shape(int(sizes[c]))[1]:
            bucket = _sub_bucket(units, metric, pts, int(sizes[c]), k2)
        parts[c] = _sub_fit(bucket, pts, order[bounds[c] : bounds[c + 1]], k2, max_iterations, seed)
    for c in np.nonzero((sizes > 0) & (sizes <= k2))[0]:
        parts[c] = (torch.arange(int(sizes[c]), dtype=torch.int32, device=pts.device),
                    pts[order[bounds[c] : bounds[c + 1]]].float())
    kept = [parts[c] for c in sorted(parts)]
    return (torch.cat([a for a, _ in kept]), torch.cat([cents for _, cents in kept]),
            np.array([cents.shape[0] for _, cents in kept], dtype=np.int64))


def kmeans_hierarchical(points, k: int, *, metric: MetricKind = MetricKind.L2sq, sample: int = 1 << 20,
                        max_iterations: int = 25, seed: Optional[int] = None, return_dists: bool = True,
                        flat_assign: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two-level k-means for large ``k``: ``ceil(sqrt(k))`` coarse centroids
    fit on ``sample`` rows (drawn by numpy's ``default_rng(seed)``, as the
    JAX package draws them), every point assigned once, then ``ceil(k /
    k1)`` centroids fit inside each coarse cluster (a cluster of at most
    that many members gives its members as centroids); every fit runs
    ``max_iterations`` fused steps. The assignment cost per step is
    ``N (sqrt(k) + k / sqrt(k)) D`` where the flat fit's is ``N k D``. The
    sub-fits' results stay on the device until level 2 is done.

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
    units = _Units(pts.device)

    train = pts[torch.as_tensor(rng.choice(n, size=sample, replace=False), device=pts.device)] if n > sample else pts
    if train.shape[0] == 0:
        raise ValueError("kmeans needs at least one point")
    _, _, coarse = _fit(units, train, k1, metric, max_iterations, seed=seed, fused=True)
    coarse_assign = _coarse_assign(metric, pts, coarse)

    order = np.argsort(coarse_assign, kind="stable")
    bounds = np.searchsorted(coarse_assign[order], np.arange(coarse.shape[0] + 1))
    sub_assign, sub_cents, per_cluster = _sub_fits(units, metric, pts, order, bounds, k2, max_iterations, seed)
    # the one read of level 2's results
    sub_assign, centroids = sub_assign.cpu().numpy(), sub_cents.cpu().numpy().astype(np.float32)
    bases = np.concatenate([[0], np.cumsum(per_cluster)[:-1]])
    assigns = np.zeros(n, dtype=np.int64)
    assigns[order] = sub_assign.astype(np.int64) + np.repeat(bases, np.diff(bounds)[np.diff(bounds) > 0])
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
