"""IVF partitioned scan: a k-means quantizer over the table, and searches
that probe the ``nprobe`` partitions nearest each query.

Counterpart of `usearch_tpu/ivf.py`, for every metric and pairing. b1
tables are partitioned in the unpacked {0, 1} bit space, where hamming is
squared L2, and probed by and-counts (`packbits.bit_dot`) over popcount
stats; set (jaccard) tables in a presence sketch of their ids
(`_set_sketch`), divergence tables in the square roots of their
probabilities (where l2sq tracks the divergence), the rest in their rows.
The metric tail (`GENERIC_PROBE_METRICS`) and user-defined metrics score
the gathered candidate rows by their full formulas
(`distances.gathered_dists`). Layouts:

- ``optimize()`` (copied): a partition-contiguous copy of the live rows,
  ``[C, P, W]``; a probe gathers whole partitions.
- ``optimize(reorder=True)`` (dense): the table itself is permuted into
  cluster-major order, partition ``c`` at rows ``[starts[c], starts[c] +
  lens[c])``. ``spill`` adds SOAR shadow rows: duplicates of the spilled
  rows inside their second-nearest partition, invisible to the index
  proper.

Probes of the dense layout over ip/cos/l2sq on i8/bf16/f32 and hamming on
b1, with ``k <= 128``, go through the probe kernels (ops/probe.py) in one
of the JAX package's flavours, picked by `PROBE_MODE` at each search:

- tanimoto and sorensen over b1, in every flavour: kernel B5 selects by
  hamming and the candidates are re-ranked exactly through the popcount
  identity;
- ``pair``: kernel B6, each query streams its own windows and keeps its
  own running top-k (batches of a multiple of 8 queries; others take the
  plain probe, as in the JAX package);
- ``bin``: kernel B7 over i8 rows with ip/cos/l2sq, a fully selectable
  surface (`BIN_KEEP` per `BIN_BW`-row bin) and at least
  `BIN_LIVE_FLOOR` of the positions live: top rows by raw dot, masked,
  rescored and de-duplicated outside;
- ``nofold``, and ``bin`` where B7 does not apply: kernel B5 with 4 per bin
  and an exact merge outside, for ``k <= 64`` on wide probe surfaces;
- ``group`` (the default) and ``xla``, and ``nofold``/``bin`` otherwise:
  the grouped probe, kernel B3, within the JAX package's working-set guard
  (a `ShardedIndex`'s shards take B3 in every flavour but ``xla``, which
  gives them the plain probe).

The rest (the other pairings, the metric tail, user-defined metrics,
pearson, f16) go through a plain block-gather probe.

Rows added after a build join a fresh list that every search scans
exactly, until ``optimize`` runs again. Where the JAX package differs:

- the coarse selection is an exact top-k everywhere, ties to the lower
  partition chunk (JAX: ``lax.approx_max_k`` on accelerators);
- merges are exact top-k's (JAX: `staged_topk`, exact while no 128-lane
  column holds more than 4 of the top-k);
- the fully-live gate of the aux-free ip probe reads host-side counts: the
  index's own mask, no fresh rows, live rows and shadows filling the
  capacity (JAX: a float32 mean of the mask);
- the flavour is a module attribute read at each search, and B7's bin
  width, keep and selection are constants at the JAX defaults (JAX:
  environment variables read at import, with an override of the grouped
  probe's per-bin count that is not ported);
- ``bin``'s live share is an exact count of the mask, cached by the mask's
  identity and version (JAX: a float32 mean cached by identity).
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np
import torch

from .enums import MetricKind, MetricKindBitwise, ScalarKind
from .keymap import KeyMap
from .kmeans import assign_flat, kmeans_fit, kmeans_hierarchical
from .ops.distances import I8_F32_EXACT_WIDTH, MASKED, _sqrt, binary_dists, gathered_dists, row_stats, tile_dists
from .ops.packbits import bit_dot, unpack_bits
from .ops.probe import (LANES, MAX_BIN_M, MAX_BINNED_WIDTH, binned_probe, grouped_probe, grouped_probe_nofold,
                        pair_probe)
from .ops.scan import supports
from .ops.topk import masked_topk, stable_topk, staged_topk

#: binary metrics with an IVF probe path over b1 tables: all of them
BINARY_PROBE_METRICS = MetricKindBitwise
#: metrics with no product: the probes score them (and user-defined
#: metrics) on the gathered candidate rows (`distances.gathered_dists`)
GENERIC_PROBE_METRICS = (MetricKind.Haversine, MetricKind.Divergence, MetricKind.Jaccard)
#: width of the presence sketch a set index is partitioned in
SET_SKETCH_DIM = 128
#: candidates per bin of the tanimoto/sorensen select: hamming distances
#: are small integers with many ties, which those metrics break otherwise
BINARY_BIN_M = 8

#: rows per gather block in the dense layout
DENSE_BLOCK = 256
#: query chunk of the plain probes
_QUERY_CHUNK = 256
#: bytes of the largest gathered temporary of one plain-probe chunk
_PROBE_BUDGET = 128 * 1024 * 1024
#: queries per grouped-probe launch
PROBE_QCHUNK = 16384
#: queries per coarse-selection step: bounds the [chunk, C] score surface
COARSE_QCHUNK = 2048
#: partition chunks are split at this many rows
CHUNK_CAP = 4096
#: the most partitions the flat k-means fit serves; more take the two-level
#: fit (`kmeans_hierarchical`). Read at each build.
MAX_PARTITIONS = 4096

#: the dense probe's flavour, read at each search (`dense_probe`): "group",
#: "nofold", "bin", "pair" or "xla". An `Index` takes "xla" as "group", as
#: the JAX index's probe setting does; a `ShardedIndex`, whose shards take
#: no other flavour, takes "xla" as the plain probe (the JAX sharded path's
#: own core) and every other value as "group".
PROBE_MODE = "group"
PROBE_MODES = ("group", "nofold", "bin", "pair", "xla")
#: ``bin``: rows per bin of kernel B7, rows kept per bin, and its selection,
#: fixed at the JAX package's defaults
BIN_BW = 32
BIN_KEEP = 4
BIN_SEL = "pack"
#: ``bin`` masks deleted and filtered rows after its merge: below this live
#: share the search takes the in-kernel penalty paths instead
BIN_LIVE_FLOOR = 0.5
#: the dense probe's flavours whose search an `Index` captures as a CUDA
#: graph on the card (graphs.py; the plain probe stays eager, `graphs.EAGER`)
CAPTURED_ROUTES = ("binary", "nofold", "group", "pair", "bin")

_SERIALS = itertools.count()


# ----------------------------------------------------------------------
# Spill shadows and the fresh list
# ----------------------------------------------------------------------


def _shadow_extend(valid: torch.Tensor, shadow_pos: torch.Tensor, shadow_src: torch.Tensor) -> torch.Tensor:
    """A copy of ``valid`` with each shadow position live iff its primary
    is."""
    out = valid.clone()
    out[shadow_pos.long()] = valid[shadow_src.long()]
    return out


def _shadow_canon(ids: torch.Tensor, shadow_pos: torch.Tensor, shadow_src: torch.Tensor) -> torch.Tensor:
    """Shadow positions (``shadow_pos`` sorted) to their primaries' slots;
    other ids, -1 included, pass through."""
    j = torch.clamp(torch.searchsorted(shadow_pos, ids), 0, shadow_pos.shape[0] - 1)
    hit = (shadow_pos[j] == ids) & (ids >= 0)
    return torch.where(hit, shadow_src[j], ids)


def _dedup_trim(d: torch.Tensor, slots: torch.Tensor, k: int):
    """Keep the first occurrence of each slot in each row (rows ascend by
    distance) and trim to ``k``; the JAX package's `_dedup_trim_host`."""
    kk = d.shape[1]
    j = torch.arange(kk, device=d.device)
    dup = (slots[:, :, None] == slots[:, None, :]) & (j[None, None, :] < j[None, :, None])
    bad = dup.any(-1) | (slots < 0)
    push = torch.argsort(bad.to(torch.int32), dim=1, stable=True)[:, :k]
    out_d, out_s, kept_bad = d.gather(1, push), slots.gather(1, push), bad.gather(1, push)
    return torch.where(kept_bad, MASKED, out_d), torch.where(kept_bad, -1, out_s)


def _fresh_probe_mask(fresh_slots: torch.Tensor, cap: int) -> torch.Tensor:
    """``[cap]`` bool, False at the fresh slots: their entries in the built
    layout are missing or stale, and only the fresh scan serves them."""
    mask = torch.ones((cap,), dtype=torch.bool, device=fresh_slots.device)
    mask[fresh_slots[fresh_slots >= 0].long()] = False
    return mask


def _fresh_topk(metric, kind, q, table, stats, valid, fresh_slots, ndim: int, k: int, metric_fn=None):
    """Exact top-k of the queries against the fresh list, read from the live
    table."""
    safe = fresh_slots.clamp_min(0).long()
    d = tile_dists(metric, kind, q, row_stats(q, kind), table[safe], stats[safe], ndim, metric_fn)
    d, idx = masked_topk(d, (fresh_slots >= 0) & valid[safe], k)
    return d, torch.where(idx >= 0, fresh_slots[idx.clamp_min(0).long()], -1)


# ----------------------------------------------------------------------
# Coarse selection
# ----------------------------------------------------------------------


def _set_sketch(rows: torch.Tensor) -> torch.Tensor:
    """Padded integer-set rows ``[N, W]`` (-1 pads) as presence counts
    ``[N, SET_SKETCH_DIM]`` f32: each element hashes (Knuth's
    multiplicative hash in uint32, then ``>> 7``) to one bucket, so sets of
    a small jaccard distance share most counts. The uint32 product is taken
    mod 2**32 in int64 halves (no uint32 shifts on every device)."""
    r = rows.long() & 0xFFFFFFFF
    mult = 2654435761
    prod = (((r & 0xFFFF) * mult) + ((((r >> 16) * mult) & 0xFFFF) << 16)) & 0xFFFFFFFF
    h = (prod >> 7) % SET_SKETCH_DIM
    out = torch.zeros((rows.shape[0], SET_SKETCH_DIM), dtype=torch.float32, device=rows.device)
    return out.scatter_add_(1, h, (rows != -1).float())


def _query_f32(kind, q: torch.Tensor, metric=None) -> torch.Tensor:
    """Query rows in the quantizer's space: the unpacked bits of b1 rows,
    the presence sketch of int32 set rows, for divergence the Hellinger
    embedding (the square roots of the probabilities, where l2sq tracks
    the divergence), else the rows as f32."""
    if kind == ScalarKind.B1:
        return unpack_bits(q).float()
    if q.dtype == torch.int32:
        return _set_sketch(q)
    if metric == MetricKind.Divergence:
        return torch.sqrt(torch.clamp_min(q.float(), 0.0))
    return q.float()


def _centroid_metric(metric):
    """Partitions rank by ip/cos/l2sq as their metric, pearson and the
    binary metrics by l2sq (their quantizer's space; hamming is l2sq over
    bits)."""
    return metric if metric in (MetricKind.IP, MetricKind.Cos, MetricKind.L2sq) else MetricKind.L2sq


def centroid_groups(centroids: torch.Tensor):
    """``(distinct centroids, chunk -> distinct row)``: chunks split from
    one cluster share a centroid, and scoring each distinct centroid once
    makes their scores tie exactly."""
    return torch.unique(centroids, dim=0, return_inverse=True)


def _score_centroids(metric, qf: torch.Tensor, centroids: torch.Tensor, lens=None, groups=None):
    """``[Q, C]`` partition scores, lower is nearer; empty chunks rank last."""
    uniq, inv = groups if groups is not None else (centroids, None)
    dots = qf @ uniq.T
    if metric == MetricKind.L2sq:
        c_sq = (uniq * uniq).sum(dim=1)
        cdist = (qf * qf).sum(dim=1, keepdim=True) + c_sq[None, :] - 2.0 * dots
    else:
        cdist = -dots
    if inv is not None:
        cdist = cdist[:, inv]
    if lens is not None:
        cdist = cdist + torch.where(lens == 0, MASKED, 0.0)[None, :]
    return cdist


def _probe_select(metric, qf: torch.Tensor, centroids: torch.Tensor, lens, nprobe: int, groups=None):
    """The ``nprobe`` best partitions per query, ``[Q, nprobe]`` i64, ties
    to the lower chunk index, scoring at most ``COARSE_QCHUNK`` queries at a
    time."""
    return torch.cat([
        stable_topk(_score_centroids(metric, qf[lo : lo + COARSE_QCHUNK], centroids, lens, groups), nprobe)[1]
        for lo in range(0, qf.shape[0], COARSE_QCHUNK)
    ])


# ----------------------------------------------------------------------
# Plain probes
# ----------------------------------------------------------------------


def _probe_dot(kind, qc: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``[chunk, W] . [chunk, X, W] -> [chunk, X]`` f32 at full precision
    (i8 in a float type that holds its sums exactly; and-counts of packed
    b1 rows)."""
    if kind == ScalarKind.B1:
        return bit_dot(qc[:, None, :], rows)[:, 0]
    if kind == ScalarKind.I8:
        acc = torch.float32 if qc.shape[-1] <= I8_F32_EXACT_WIDTH else torch.float64
    else:
        acc = torch.float32
    return torch.bmm(rows.to(acc), qc.to(acc)[:, :, None])[..., 0].float()


def _probe_metric_dists(metric, d_, q_sq, t_sq, q_sum=None, t_sum=None, ndim: int = 0):
    """Candidate distances from raw dots ``[chunk, X]``, the queries' stats
    ``[chunk]`` and the candidates' ``[chunk, X]`` (``t_sq`` None for ip)."""
    d_ = d_.float()
    if metric == MetricKind.IP:
        return 1.0 - d_
    if metric == MetricKind.Pearson:
        n = float(ndim)
        num = n * d_ - q_sum[:, None] * t_sum
        den = (n * q_sq - q_sum * q_sum)[:, None] * (n * t_sq - t_sum * t_sum)
        safe = torch.where(den <= 0.0, 1.0, den)
        return torch.where(den <= 0.0, 0.0, 1.0 - num / _sqrt(safe))
    if metric == MetricKind.Cos:
        denom = _sqrt(q_sq)[:, None] * _sqrt(t_sq)
        base = 1.0 - d_ / torch.where(denom == 0, 1.0, denom)
        one_zero = (q_sq[:, None] == 0) ^ (t_sq == 0)
        both_zero = (q_sq[:, None] == 0) & (t_sq == 0)
        return torch.where(both_zero, 0.0, torch.where(one_zero, 1.0, base))
    if metric == MetricKind.L2sq:
        return torch.clamp_min(q_sq[:, None] + t_sq - 2.0 * d_, 0.0)
    if metric in BINARY_PROBE_METRICS:
        return binary_dists(metric, d_, q_sq[:, None], t_sq)
    raise ValueError(f"probe epilogue: unsupported metric {metric}")


def _chunk_topk(dist, cand, ok, k: int):
    """Masked top-k of one query chunk, padded to ``k`` columns."""
    dist = torch.where(ok, dist, MASKED)
    kk = min(k, dist.shape[1])
    d_out, ids = staged_topk(dist, cand, kk)
    ids = torch.where(d_out >= MASKED / 2, -1, ids)
    if k > kk:
        d_out = torch.nn.functional.pad(d_out, (0, k - kk), value=MASKED)
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return d_out, ids.to(torch.int32)


def _chunk_rows(row_bytes: int) -> int:
    """Queries per plain-probe chunk for ``row_bytes`` gathered per query."""
    return int(np.clip(_PROBE_BUDGET // max(row_bytes, 1), 8, _QUERY_CHUNK))


def _row_bytes(kind, width: int, metric=None, metric_fn=None) -> int:
    """Bytes a plain probe holds per gathered row: its f32 (or f64) copy and
    12 bytes of ids, stats and mask; b1 rows unpack to 8 f32 per byte. The
    metrics scored on gathered rows hold more, as the JAX package budgets
    them: jaccard's search per entry, and the broadcast f32 intermediates of
    divergence, haversine and user-defined metrics (8 times the row)."""
    row = width * (32 if kind == ScalarKind.B1 else 4) + 12
    if metric == MetricKind.Jaccard:
        return row * max(width, 1)
    if metric_fn is not None or metric in GENERIC_PROBE_METRICS:
        return row * 8
    return row


def _candidate_dists(metric, kind, qc, qsc, rows, t_sq, t_sum, ndim: int, metric_fn):
    """Distances of a query chunk to its gathered candidates: the metric
    tail and user-defined metrics by their full formulas, the rest from
    their products and stats."""
    if metric_fn is not None or metric in GENERIC_PROBE_METRICS:
        return gathered_dists(metric, kind, qc, rows, ndim, metric_fn)
    return _probe_metric_dists(metric, _probe_dot(kind, qc, rows), qsc[:, 0], t_sq, qsc[:, 1], t_sum, ndim)


def _part_valid_compute(valid: torch.Tensor, part_slots: torch.Tensor) -> torch.Tensor:
    """Partition-aligned validity ``[C, P]``: pads and deleted rows False."""
    return (part_slots >= 0) & valid[part_slots.clamp_min(0).long()]


def _ivf_probe_search(metric, kind, q, part_valid, centroids, part_table, part_stats, part_slots,
                      ndim: int, k: int, nprobe: int, groups=None, metric_fn=None):
    """Copied layout: each query gathers its ``nprobe`` partitions whole,
    scored in query chunks of a fixed memory budget. Returns slots."""
    n_q, p = q.shape[0], part_table.shape[1]
    q_stats = row_stats(q, kind)
    probes = _probe_select(_centroid_metric(metric), _query_f32(kind, q, metric), centroids, part_valid.sum(dim=1),
                           nprobe, groups)
    chunk = _chunk_rows(nprobe * p * _row_bytes(kind, part_table.shape[-1], metric, metric_fn))
    out_d, out_i = [], []
    for lo in range(0, n_q, chunk):
        prc, qc, qsc = probes[lo : lo + chunk], q[lo : lo + chunk], q_stats[lo : lo + chunk]
        m = prc.shape[0]
        rows = part_table[prc].reshape(m, nprobe * p, -1)
        rstats = part_stats[prc].reshape(m, nprobe * p, 2)
        dist = _candidate_dists(metric, kind, qc, qsc, rows, rstats[..., 0], rstats[..., 1], ndim, metric_fn)
        d, i = _chunk_topk(dist, part_slots[prc].reshape(m, -1), part_valid[prc].reshape(m, -1), k)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def _dense_probe_core(metric, kind, qc, qsc, prc, starts, lens, vblk, tblk, sblk, cap2: int, block: int,
                      nblk: int, k: int, ndim: int = 0, metric_fn=None):
    """Score one query chunk against its probed windows in the dense layout:
    the blocks covering each window are gathered whole and the rows outside
    the window masked. Returns (distances, positions), ``[chunk, k]``."""
    chunk, nprobe = prc.shape
    nb = tblk.shape[0]
    r = nblk * block
    dev = qc.device
    st, ln = starts[prc].long(), lens[prc].long()
    blk0 = st // block
    bidx = torch.clamp_max(blk0[:, :, None] + torch.arange(nblk, device=dev), nb - 1)
    rows = tblk[bidx].reshape(chunk, nprobe * r, -1)
    cand = ((blk0 * block)[:, :, None] + torch.arange(r, device=dev)).reshape(chunk, nprobe * r)
    st_f, ln_f = st.repeat_interleave(r, dim=1), ln.repeat_interleave(r, dim=1)
    # clamped duplicate blocks carry other rows' validity, but their
    # positions fall outside every window
    ok = (cand >= st_f) & (cand < st_f + ln_f) & (cand < cap2) & vblk[bidx].reshape(chunk, nprobe * r)
    t_sq = t_sum = None
    if sblk is not None:
        sg = sblk[bidx]
        t_sq, t_sum = sg[..., 0].reshape(chunk, nprobe * r), sg[..., 1].reshape(chunk, nprobe * r)
    dist = _candidate_dists(metric, kind, qc, qsc, rows, t_sq, t_sum, ndim, metric_fn)
    return _chunk_topk(dist, cand, ok, k)


def _ivf_probe_search_dense(metric, kind, q, valid, centroids, table, stats, starts, lens, ndim: int,
                            k: int, nprobe: int, p_win: int, block: int, groups=None, metric_fn=None):
    """Dense layout, plain: each probe gathers the ``block``-row blocks
    covering its window. Serves what the grouped probes do not: pearson,
    f16, the other pairings, the metric tail, user-defined metrics, k >
    128, and windows past the grouped probe's guard."""
    n_q = q.shape[0]
    cap2 = table.shape[0]
    nb = cap2 // block
    q_stats = row_stats(q, kind)
    probes = _probe_select(_centroid_metric(metric), _query_f32(kind, q, metric), centroids, lens, nprobe, groups)
    tblk = table.view(nb, block, -1)
    vblk = valid.view(nb, block)
    generic = metric_fn is not None or metric in GENERIC_PROBE_METRICS
    sblk = stats.view(nb, block, 2) if metric != MetricKind.IP and not generic else None
    nblk = (p_win - 1) // block + 2
    chunk = _chunk_rows(nprobe * nblk * block * _row_bytes(kind, table.shape[-1], metric, metric_fn))
    out_d, out_i = [], []
    for lo in range(0, n_q, chunk):
        d, i = _dense_probe_core(metric, kind, q[lo : lo + chunk], q_stats[lo : lo + chunk],
                                 probes[lo : lo + chunk], starts, lens, vblk, tblk, sblk, cap2, block,
                                 nblk, k, ndim, metric_fn)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


# ----------------------------------------------------------------------
# The grouped probe (kernel B3)
# ----------------------------------------------------------------------


def _binned_pairs(q, probes, starts, lens, cap2: int, w_pad: int, nprobe: int):
    """(query, partition) pairs sorted by partition (stably, pads last) and
    padded to cells of 128. Returns the pairs' query rows, query ids, DMA
    starts ``st_c`` (128-aligned, clamped so ``w_pad`` rows fit), offsets of
    the windows inside them and window lengths, the sort order, and the
    real and padded pair counts."""
    n_q = q.shape[0]
    c = lens.shape[0]
    dev = q.device
    p0 = n_q * nprobe
    p_total = -(-p0 // LANES) * LANES
    part = torch.cat([probes.reshape(-1).long(), torch.full((p_total - p0,), c, dtype=torch.long, device=dev)])
    qid = torch.cat([torch.arange(p0, device=dev) // nprobe, torch.zeros(p_total - p0, dtype=torch.long, device=dev)])
    order = torch.argsort(part, stable=True)
    part_s, qid_s = part[order], qid[order]
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    st_raw = torch.cat([starts.int(), zero])[part_s]
    ln = torch.cat([lens.int(), zero])[part_s]
    st_c = torch.clamp_max(st_raw // 128 * 128, cap2 - w_pad)
    return q[qid_s], qid_s, st_c, st_raw - st_c, ln, order, p0, p_total


def probe_bin_m(k: int, nprobe: int, w_pad: int) -> int:
    """Candidates kept per 128-row bin: 4 on wide probe surfaces, ``k`` on
    narrow ones (exact within the window), at most 16."""
    return min(4 if nprobe * (w_pad // 128) >= 8 * k else k, MAX_BIN_M)


def padded_window(p_win: int) -> int:
    """Rows of a probe's padded window: window starts align down to 128
    rows, so it covers the longest window plus the shift."""
    return max(((p_win + 127) // 128) * 128 + 128, 256)


def grouped_fits(k: int, nprobe: int, w_pad: int) -> bool:
    """The JAX package's guard on the grouped kernel's working set, kept as
    it is so both packages take the same path."""
    return (probe_bin_m(k, nprobe, w_pad) + 15) * w_pad * 512 <= 96 * 1024 * 1024


def _merge_windows(d, ids, order, p0: int, n_q: int, k: int):
    """Per-pair candidates ``[P, t]`` back to (query, probe) order through
    the inverse permutation, merged exactly into each query's top-k."""
    inv = torch.argsort(order)[:p0]
    d_out, out = staged_topk(d[inv].reshape(n_q, -1), ids[inv].reshape(n_q, -1), k)
    return d_out, torch.where(d_out >= MASKED / 2, -1, out)


def _ivf_probe_search_dense_grouped(metric, kind, q, valid, centroids, table, stats, starts, lens, k: int,
                                    nprobe: int, w_pad: int, all_live: bool = False, groups=None):
    """Dense layout through kernel B3: pairs sorted by partition share
    their window's reads; each pair's top-k come back to (query, probe)
    order through the inverse permutation and merge exactly."""
    cap2 = table.shape[0]
    qf = _query_f32(kind, q)
    probes = _probe_select(_centroid_metric(metric), qf, centroids, lens, nprobe, groups)
    q_g, qid_s, st_c, off, ln, order, p0, _ = _binned_pairs(q, probes, starts, lens, cap2, w_pad, nprobe)
    q_sq = (qf * qf).sum(dim=1)  # popcounts for b1
    # ip over a fully-live table needs no per-row aux
    auxless = all_live and metric == MetricKind.IP
    penalty = None if auxless else torch.where(valid, 0.0, MASKED)
    t_sq = None if metric == MetricKind.IP else stats[:, 0].contiguous()
    pd, pi = grouped_probe(metric, q_g.contiguous(), q_sq[qid_s].contiguous(), table, t_sq, penalty,
                           (st_c + off).contiguous(), ln.contiguous(), k, probe_bin_m(k, nprobe, w_pad))
    return _merge_windows(pd, pi, order, p0, q.shape[0], k)


def _ivf_probe_search_dense_nofold(metric, kind, q, valid, centroids, table, stats, starts, lens, k: int,
                                   nprobe: int, w_pad: int, groups=None, bin_m: int = 4):
    """Dense layout through kernel B5 (the ``nofold`` flavour): each pair's
    ``bin_m`` best per bin with their final distances, then per window the
    ``t = min(max(k, 16), out_pad)`` best (the earlier column first on
    ties, as ``lax.top_k`` takes them), merged exactly across windows."""
    cap2 = table.shape[0]
    qf = _query_f32(kind, q)
    probes = _probe_select(_centroid_metric(metric), qf, centroids, lens, nprobe, groups)
    q_g, qid_s, st_c, off, ln, order, p0, _ = _binned_pairs(q, probes, starts, lens, cap2, w_pad, nprobe)
    q_sq = (qf * qf).sum(dim=1)  # popcounts for b1
    t_sq = None if metric == MetricKind.IP else stats[:, 0].contiguous()
    pd, pi = grouped_probe_nofold(metric, q_g.contiguous(), q_sq[qid_s].contiguous(), table, t_sq,
                                  torch.where(valid, 0.0, MASKED), st_c.contiguous(), (st_c + off).contiguous(),
                                  ln.contiguous(), w_pad, bin_m)
    wd, ws = stable_topk(pd, min(max(k, 16), pd.shape[1]))
    return _merge_windows(wd, pi.gather(1, ws), order, p0, q.shape[0], k)


def _ivf_probe_search_dense_binned(metric, kind, q, valid, centroids, table, stats, starts, lens, k: int,
                                   nprobe: int, w_pad: int, groups=None, bw: int = 32, keep: int = 4,
                                   sel: str = "pack"):
    """i8 dense layout through kernel B7 (the ``bin`` flavour): each pair's
    ``keep`` rows of largest raw dot per ``bw``-row bin of its whole padded
    window, with no masks; per window the ``t`` best keys, merged to the
    ``k + slack`` best per query; then deleted and filtered rows masked,
    the metric's distances computed from the stats, repeated rows (padded
    windows overlap their neighbours) dropped, and the final top-k. cos and
    l2sq select by raw dot too, over a wider slack: i8 rows are near unit
    norm, so the dot nearly ranks them."""
    n_q, cap2 = q.shape[0], table.shape[0]
    qf = _query_f32(kind, q)
    probes = _probe_select(_centroid_metric(metric), qf, centroids, lens, nprobe, groups)
    q_g, _, st_c, _, _, order, p0, _ = _binned_pairs(q, probes, starts, lens, cap2, w_pad, nprobe)
    pd, pi = binned_probe(q_g.contiguous(), table, st_c.contiguous(), w_pad, bw, keep, sel)
    slack = 32 if metric == MetricKind.IP else 96
    t = min(max(k, slack // 2), pd.shape[1])
    wd, ws = stable_topk(pd, t)
    d1, i1 = _merge_windows(wd, pi.gather(1, ws), order, p0, n_q, min(k + slack, nprobe * t))
    safe = i1.clamp(0, cap2 - 1).long()
    t_sq = None if metric == MetricKind.IP else stats[safe, 0]
    dt = _probe_metric_dists(metric, -d1, (qf * qf).sum(dim=1), t_sq)
    dt = torch.where(valid[safe] & (i1 >= 0) & (d1 < MASKED / 2), dt, MASKED)
    o = torch.argsort(i1, dim=1, stable=True)
    si, sd = i1.gather(1, o), dt.gather(1, o)
    repeat = torch.cat([torch.zeros_like(si[:, :1], dtype=torch.bool), si[:, 1:] == si[:, :-1]], dim=1)
    d_out, pos = stable_topk(torch.where(repeat, MASKED, sd), k)
    return d_out, torch.where(d_out >= MASKED / 2, -1, si.gather(1, pos))


def _ivf_probe_search_dense_pair(metric, kind, q, valid, centroids, table, stats, starts, lens, k: int,
                                 nprobe: int, w_pad: int, groups=None):
    """Dense layout through kernel B6 (the ``pair`` flavour): each query
    streams its own ``nprobe`` windows and keeps its own running top-k, so
    no window read is shared; B6's ``[Q, k]`` is the result. The penalty
    row goes with every metric, ip included, as in the JAX package."""
    cap2 = table.shape[0]
    qf = _query_f32(kind, q)
    probes = _probe_select(_centroid_metric(metric), qf, centroids, lens, nprobe, groups)
    st, ln = starts[probes].int(), lens[probes].int()
    st_c = torch.clamp_max(st // 128 * 128, cap2 - w_pad)
    t_sq = None if metric == MetricKind.IP else stats[:, 0].contiguous()
    bin_m = 4 if nprobe * (w_pad // 128) >= 8 * k else k
    return pair_probe(metric, q.contiguous(), (qf * qf).sum(dim=1), table, t_sq, torch.where(valid, 0.0, MASKED),
                      st_c.contiguous(), (st - st_c).contiguous(), ln.contiguous(), k, w_pad, bin_m)


def _ivf_probe_search_dense_binary(metric, kind, q, valid, centroids, table, stats, starts, lens, k: int,
                                   nprobe: int, w_pad: int, groups=None, bin_m: int = BINARY_BIN_M):
    """tanimoto/sorensen over b1 through kernel B5: each pair's ``bin_m``
    best rows per bin by hamming, then per window the ``t = min(max(2k,
    24), out_pad)`` best by hamming (the earlier column first on ties, as
    ``lax.top_k`` takes them), re-ranked exactly through the popcount
    identity ``and = (pop_q + pop_t - hamming) / 2`` before the windows
    merge, so no candidate row is read again."""
    cap2 = table.shape[0]
    qf = _query_f32(kind, q)
    probes = _probe_select(MetricKind.L2sq, qf, centroids, lens, nprobe, groups)
    q_g, qid_s, st_c, off, ln, order, p0, _ = _binned_pairs(q, probes, starts, lens, cap2, w_pad, nprobe)
    q_sq = (qf * qf).sum(dim=1)  # popcounts
    pop_q = q_sq[qid_s].contiguous()
    pd, pi = grouped_probe_nofold(MetricKind.Hamming, q_g.contiguous(), pop_q, table, stats[:, 0].contiguous(),
                                  torch.where(valid, 0.0, MASKED), st_c.contiguous(), (st_c + off).contiguous(),
                                  ln.contiguous(), w_pad, bin_m)
    d_h, sel = stable_topk(pd, min(max(2 * k, 24), pd.shape[1]))
    wi = pi.gather(1, sel)
    pop_t = stats[wi.clamp(0, cap2 - 1).long(), 0]
    inter = torch.clamp_min((pop_q[:, None] + pop_t - d_h) * 0.5, 0.0)
    dt = binary_dists(metric, inter, pop_q[:, None], pop_t)
    dt = torch.where((wi >= 0) & (d_h < MASKED / 2), dt, MASKED)
    return _merge_windows(dt, wi, order, p0, q.shape[0], k)


def _binned_ok(metric, kind, width: int, k: int, nprobe: int, w_pad: int, live_share) -> bool:
    """Kernel B7's preconditions: i8 rows of at most `MAX_BINNED_WIDTH`, a
    dot-selectable metric, enough bin winners to cover ``8 k``, and a mostly
    live mask (B7 masks after its merge, not during selection); the mask's
    ``live_share()``, a host read, is asked last."""
    return (kind == ScalarKind.I8 and metric in (MetricKind.IP, MetricKind.Cos, MetricKind.L2sq)
            and width <= MAX_BINNED_WIDTH
            and nprobe * BIN_KEEP * (w_pad // BIN_BW) >= 8 * k
            and live_share() >= BIN_LIVE_FLOOR)


def _bin_fallback(k: int, nprobe: int, w_pad: int) -> str:
    """The route ``bin`` takes where B7's gate refuses: as ``nofold``."""
    return "nofold" if _nofold_fits(k, nprobe, w_pad) else "group" if grouped_fits(k, nprobe, w_pad) else "plain"


def _live_fraction(valid: torch.Tensor) -> float:
    """Share of live positions in ``valid``: an exact count, one scalar
    read."""
    return int(valid.sum()) / max(valid.numel(), 1)


def _nofold_fits(k: int, nprobe: int, w_pad: int) -> bool:
    """B5's gate in the ``nofold`` (and ``bin``) flavour: ``k <= 64`` on a
    wide probe surface."""
    return k <= 64 and nprobe * (w_pad // LANES) >= 8 * k


def dense_route(metric, kind, n_q: int, n_rows: int, k: int, nprobe: int, p_win: int, *, shard: bool = False,
                metric_fn=None) -> str:
    """The flavour `dense_probe` takes for a chunk of ``n_q`` queries over
    ``n_rows`` table rows, from host values alone: "binary" (tanimoto and
    sorensen: B5 and the re-rank), "pair" (B6), "bin" (B7 where the mask
    passes `_binned_ok`, else as ``nofold``), "nofold" (B5), "group" (B3) or
    "plain" (the plain block-gather probe)."""
    mode = PROBE_MODE
    if mode not in PROBE_MODES:
        raise ValueError(f"PROBE_MODE must be one of {PROBE_MODES}, got {mode!r}")
    if shard:
        mode = "plain" if mode == "xla" else "group"
    w_pad = padded_window(p_win)
    binary = kind == ScalarKind.B1 and metric in BINARY_PROBE_METRICS
    if not (mode != "plain" and w_pad <= n_rows and k <= 128 and (binary or supports(metric, kind))
            and metric_fn is None and (mode != "pair" or n_q % 8 == 0)):
        return "plain"
    if metric in (MetricKind.Tanimoto, MetricKind.Sorensen):
        return "binary"  # before the guard, as in the JAX package
    if mode in ("pair", "bin"):
        return mode
    if mode == "nofold" and _nofold_fits(k, nprobe, w_pad):
        return "nofold"
    return "group" if grouped_fits(k, nprobe, w_pad) else "plain"


def dense_probe(metric, kind, q, valid, centroids, table, stats, starts, lens, ndim: int, k: int, nprobe: int,
                p_win: int, *, shard: bool = False, block: int = DENSE_BLOCK, all_live: bool = False, groups=None,
                metric_fn=None, binned: bool):
    """The dense layout's probe of an `Index` and of each shard of a
    `ShardedIndex`: ``[Q, k]`` distances and table rows, in query chunks of
    `PROBE_QCHUNK`. Inside the kernels' gates (the padded window within the
    table, ``k <= 128``, ip/cos/l2sq over i8/bf16/f32 or the binary metrics
    over b1, no user-defined metric; B6 takes batches of 8 queries),
    tanimoto and sorensen take B5 and the re-rank, then the `PROBE_MODE`
    flavour, then B3 under the JAX package's working-set guard; the rest
    takes the plain probe of ``block``-row blocks (`dense_route`). A
    ``shard`` takes no other flavour: B3, or the plain probe under
    ``"xla"`` (see `PROBE_MODE`). ``binned`` is ``bin``'s gate
    (`_binned_ok`), decided on the host before the body
    (`IVFPartitions.plan`); where it is false, ``bin`` takes its fallback."""
    if q.shape[0] > PROBE_QCHUNK:
        parts = [dense_probe(metric, kind, q[lo : lo + PROBE_QCHUNK], valid, centroids, table, stats, starts, lens,
                             ndim, k, nprobe, p_win, shard=shard, block=block, all_live=all_live, groups=groups,
                             metric_fn=metric_fn, binned=binned)
                 for lo in range(0, q.shape[0], PROBE_QCHUNK)]
        return torch.cat([d for d, _ in parts]), torch.cat([s for _, s in parts])
    route = dense_route(metric, kind, q.shape[0], table.shape[0], k, nprobe, p_win, shard=shard, metric_fn=metric_fn)
    w_pad = padded_window(p_win)
    args = (metric, kind, q, valid, centroids, table, stats, starts, lens, k, nprobe, w_pad)
    if route == "binary":
        return _ivf_probe_search_dense_binary(*args, groups)
    if route == "pair":
        return _ivf_probe_search_dense_pair(*args, groups)
    if route == "bin":
        if binned:
            return _ivf_probe_search_dense_binned(*args, groups, BIN_BW, BIN_KEEP, BIN_SEL)
        route = _bin_fallback(k, nprobe, w_pad)
    if route == "nofold":
        return _ivf_probe_search_dense_nofold(*args, groups)
    if route == "group":
        return _ivf_probe_search_dense_grouped(*args, all_live, groups)
    return _ivf_probe_search_dense(metric, kind, q, valid, centroids, table, stats, starts, lens, ndim, k, nprobe,
                                   p_win, block, groups, metric_fn)


# ----------------------------------------------------------------------
# The partition structure
# ----------------------------------------------------------------------


class IVFPartitions:
    """A built partition structure over an `Index`'s table, in the copied
    layout (``part_table`` set) or the dense one (``starts``/``lens`` set)."""

    def __init__(self, centroids, part_table, part_stats, part_slots, avg_rows, built_count,
                 inplace_shape=None, starts=None, lens=None, p_win: int = 0):
        self.centroids = centroids          # [C, W] f32, one row per chunk
        self.part_table = part_table        # [C, P, W] or None (dense)
        self.part_stats = part_stats        # [C, P, 2] or None
        self.part_slots = part_slots        # [C, P] i32 slots, -1 pads (copied)
        self.avg_rows_per_part = avg_rows
        self.built_count = built_count
        self.inplace_shape = inplace_shape  # (C, p_win) in the dense layout
        self.starts = starts                # [C] i32 (dense)
        self.lens = lens                    # [C] i32 (dense)
        self.p_win = p_win                  # longest window, rounded up to 8
        self.spilled = False
        # slots added or overwritten since the build: scanned exactly
        self.fresh_np = np.zeros(0, dtype=np.int64)
        self._fresh_cache = None            # (cap, padded slots, probe mask)
        # dense-layout spill shadows: duplicate positions and their primaries
        self.shadow_np_pos = np.zeros(0, dtype=np.int32)  # ascending
        self.shadow_np_src = np.zeros(0, dtype=np.int32)
        self._shadow_dev = None             # (pos, src) on the device, made at the first search
        self._groups = centroid_groups(centroids)
        self._live_cache = None             # (mask, its version, live share)
        # a structure's own number, and the count of its device tensors
        # made anew since (the fresh list's, the shadows'): a captured
        # search reads them by address (graphs.py)
        self.serial = next(_SERIALS)
        self.generation = 0

    def set_shadows(self, pos: np.ndarray, src: np.ndarray) -> None:
        o = np.argsort(pos, kind="stable")
        self.shadow_np_pos = np.ascontiguousarray(pos[o], dtype=np.int32)
        self.shadow_np_src = np.ascontiguousarray(src[o], dtype=np.int32)
        self.spilled = self.shadow_np_pos.size > 0
        self._shadow_dev = None

    def _shadows(self, dev):
        """The shadows' positions and sources on ``dev``, uploaded once a
        layout: a search then makes no blocking host-to-device copy."""
        if self._shadow_dev is None or self._shadow_dev[0].device != dev:
            self._shadow_dev = (torch.as_tensor(self.shadow_np_pos, device=dev),
                                torch.as_tensor(self.shadow_np_src, device=dev))
            self.generation += 1
        return self._shadow_dev

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    @staticmethod
    def _quantize(index, n_partitions: Optional[int], p_cap_mult: float = 4.0, spill: float = 0.0):
        """k-means over the live rows, then partitions cut into chunks of at
        most ``p_cap_mult`` times the average (and ``CHUNK_CAP``) rows.
        ``spill``: that share of the rows with the smallest margin between
        their two nearest centroids also joins the second one (SOAR).
        Returns (chunk members as old slots, spilled-member flags, per-chunk
        centroids, chunk depth, live count)."""
        live = index._live_slots()
        n = len(live)
        if n_partitions is None:
            n_partitions = max(1, int(math.sqrt(n)))
        n_partitions = min(n_partitions, n)
        dev = index._device
        rows = index._table[torch.as_tensor(live, device=dev)]
        if index._is_set_index:
            # sets are partitioned by their presence sketches
            rows = _set_sketch(rows)
        elif index._metric_kind == MetricKind.Divergence:
            # the Hellinger embedding: l2sq there tracks the divergence
            rows = torch.sqrt(torch.clamp_min(rows.float(), 0.0))
        elif index._dtype == ScalarKind.B1:
            # the unpacked {0, 1} bits as i8: hamming is l2sq there
            rows = unpack_bits(rows)
        km_metric = _centroid_metric(index._metric_kind)
        # past MAX_PARTITIONS the flat fit (N k D a step) gives way to the
        # two-level one; with spill, the top-2 sweep below assigns to the
        # nearest centroid too, so the fit skips its own flat pass
        skipped_flat = n_partitions > MAX_PARTITIONS and spill > 0
        if n_partitions > MAX_PARTITIONS:
            assigns, _, centroids = kmeans_hierarchical(rows, n_partitions, metric=km_metric, max_iterations=25,
                                                        seed=0, return_dists=False, flat_assign=not skipped_flat)
        else:
            assigns, _, centroids = kmeans_fit(rows, n_partitions, metric=km_metric, max_iterations=25, seed=0)
        c = centroids.shape[0]

        spill_lists = [None] * c
        if spill > 0 and c > 1 and n > 1:
            pt = min(8192, 1 << (n - 1).bit_length())
            n_pad = -(-n // pt) * pt
            rows_p = torch.cat([rows, rows[:1].expand(n_pad - n, -1)]) if n_pad > n else rows
            ct = min(16384, 1 << (c - 1).bit_length())
            a1, d1, a2, d2 = assign_flat(km_metric, rows_p, torch.as_tensor(centroids, device=dev), pt, ct, True)
            if skipped_flat:
                assigns = a1[:n].cpu().numpy().astype(np.int64)
            a2 = a2[:n].cpu().numpy()
            margin = d2[:n].cpu().numpy().astype(np.float64) - d1[:n].cpu().numpy().astype(np.float64)
            ok = (a2 >= 0) & (a2 < c) & (margin < 1e37)
            spill_n = min(int(spill * n), int(ok.sum()), max(n - 1, 0))
            if spill_n:
                cand = np.nonzero(ok)[0]
                sel = cand[np.argsort(margin[cand], kind="stable")[:spill_n]]
                spill_slots = live[sel].astype(np.int32)
                spill_into = a2[sel]
                so = np.argsort(spill_into, kind="stable")
                s_into, s_slots = spill_into[so], spill_slots[so]
                s_start = np.searchsorted(s_into, np.arange(c))
                s_end = np.searchsorted(s_into, np.arange(c), side="right")
                for ci in range(c):
                    if s_end[ci] > s_start[ci]:
                        spill_lists[ci] = s_slots[s_start[ci] : s_end[ci]]

        counts = np.bincount(assigns, minlength=c)
        # oversized clusters split into chunks that share their centroid
        avg = max(int(np.ceil(n / max(c, 1))), 1)
        p_cap = min(((int(p_cap_mult * avg) + 7) // 8) * 8, CHUNK_CAP)
        p_max = min(max(int(counts.max()), 8), p_cap)
        p_max = ((p_max + 7) // 8) * 8

        order = np.argsort(assigns, kind="stable")
        sorted_assigns = assigns[order]
        sorted_slots = live[order].astype(np.int32)
        starts = np.searchsorted(sorted_assigns, np.arange(c))
        ends = np.searchsorted(sorted_assigns, np.arange(c), side="right")
        chunk_rows, chunk_spill, chunk_centroids = [], [], []
        for ci in range(c):
            members = sorted_slots[starts[ci] : ends[ci]]
            flags = np.zeros(len(members), dtype=bool)
            if spill_lists[ci] is not None:
                members = np.concatenate([members, spill_lists[ci]])
                flags = np.concatenate([flags, np.ones(len(spill_lists[ci]), dtype=bool)])
            for off in range(0, max(len(members), 1), p_max):
                chunk_rows.append(members[off : off + p_max])
                chunk_spill.append(flags[off : off + p_max])
                chunk_centroids.append(centroids[ci])
        return chunk_rows, chunk_spill, np.stack(chunk_centroids), p_max, n

    @staticmethod
    def build(index, n_partitions: Optional[int] = None, spill: float = 0.0) -> "IVFPartitions":
        """The copied layout: ``[C, P]`` slots and a cluster-major copy of
        their rows and stats."""
        chunk_rows, _, centroids, p_max, n = IVFPartitions._quantize(index, n_partitions, spill=spill)
        c = len(chunk_rows)
        part_slots = np.full((c, p_max), -1, dtype=np.int32)
        for ci, members in enumerate(chunk_rows):
            part_slots[ci, : len(members)] = members
        dev = index._device
        slots = torch.as_tensor(part_slots, device=dev)
        safe = slots.clamp_min(0).long()
        out = IVFPartitions(
            centroids=torch.as_tensor(centroids, device=dev), part_table=index._table[safe],
            part_stats=index._stats[safe], part_slots=slots, avg_rows=max(n / c, 1.0), built_count=n,
        )
        out.spilled = spill > 0
        return out

    @staticmethod
    def build_inplace(index, n_partitions: Optional[int] = None, spill: float = 0.0) -> "IVFPartitions":
        """Permute the index's own table into dense cluster-major order:
        keys stay, slots change. Spilled rows become shadow rows inside
        their second partition's window: not live, keyless, never recycled,
        re-enabled by the probes while their primary is live."""
        chunk_rows, chunk_spill, centroids, p_max, n = IVFPartitions._quantize(
            index, n_partitions, p_cap_mult=1.5, spill=spill)
        c = len(chunk_rows)
        lens = np.array([len(m) for m in chunk_rows], dtype=np.int32)
        starts = np.zeros(c, dtype=np.int32)
        starts[1:] = np.cumsum(lens[:-1])
        body = int(lens.sum())
        p_win = max(((int(lens.max(initial=1)) + 7) // 8) * 8, 8)
        cap2 = max(-(-body // 65536) * 65536, 65536) if body > 65536 else -(-body // 1024) * 1024
        cap2 = -(-cap2 // DENSE_BLOCK) * DENSE_BLOCK

        # position -> old slot, -1 for the padding at the tail
        old_of_pos = np.full(cap2, -1, dtype=np.int32)
        is_shadow = np.zeros(cap2, dtype=bool)
        if body:
            old_of_pos[:body] = np.concatenate(chunk_rows)
            is_shadow[:body] = np.concatenate(chunk_spill)
        primary = (old_of_pos >= 0) & ~is_shadow

        dev = index._device
        old_dev = torch.as_tensor(old_of_pos, device=dev)
        safe, empty = old_dev.clamp_min(0).long(), old_dev < 0
        new_table = index._table[safe]
        new_table[empty] = 0
        new_stats = index._stats[safe]
        new_stats[empty] = 0

        new_slot_keys = np.zeros(cap2, dtype=np.uint64)
        new_slot_keys[primary] = index._slot_keys[old_of_pos[primary]]
        pos = np.nonzero(primary)[0]
        keymap = KeyMap(multi=index._multi)
        keymap.insert_many(new_slot_keys[pos], pos)

        # shadow position -> its primary's new position
        shadow_pos = np.nonzero(is_shadow)[0].astype(np.int32)
        shadow_src = np.zeros(0, dtype=np.int32)
        if shadow_pos.size:
            new_pos_of_old = np.full(int(index._capacity), -1, dtype=np.int32)
            new_pos_of_old[old_of_pos[primary]] = pos.astype(np.int32)
            shadow_src = new_pos_of_old[old_of_pos[shadow_pos]]
            kept = shadow_src >= 0
            shadow_pos, shadow_src = shadow_pos[kept], shadow_src[kept]

        index._table = new_table
        index._stats = new_stats
        index._valid = torch.as_tensor(primary, device=dev)
        index._capacity = cap2
        index._slot_keys = new_slot_keys
        index._keymap = keymap
        # shadow positions hold live duplicates: never recycled
        index._free_slots = np.nonzero(old_of_pos < 0)[0].tolist()
        index._next_slot = cap2
        if index._host_f64 is not None:
            occupied = old_of_pos >= 0  # shadows carry their primary's row too
            new_f64 = np.zeros((cap2, index._ndim), dtype=np.float64)
            new_f64[occupied] = index._host_f64[old_of_pos[occupied]]
            index._host_f64 = new_f64

        out = IVFPartitions(
            centroids=torch.as_tensor(centroids, device=dev), part_table=None, part_stats=None,
            part_slots=None, avg_rows=max(n / c, 1.0), built_count=n, inplace_shape=(c, p_win),
            starts=torch.as_tensor(starts, device=dev), lens=torch.as_tensor(lens, device=dev), p_win=p_win,
        )
        if shadow_pos.size:
            out.set_shadows(shadow_pos, shadow_src)
        return out

    def _shape(self):
        if self.inplace_shape is not None:
            return self.inplace_shape
        return tuple(self.part_slots.shape)

    # ------------------------------------------------------------------
    # The fresh list
    # ------------------------------------------------------------------

    def add_fresh(self, slots) -> None:
        """Slots written after the build; the exact fresh scan serves them
        until the next build. A recycled slot kills the shadows of the row
        it held."""
        new = np.asarray(slots, dtype=np.int64)
        if self.shadow_np_pos.size:
            kill = np.isin(self.shadow_np_src.astype(np.int64), new)
            if kill.any():
                self.set_shadows(self.shadow_np_pos[~kill], self.shadow_np_src[~kill])
        if self.fresh_np.size:
            new = new[~np.isin(new, self.fresh_np)]
        if new.size:
            self.fresh_np = np.concatenate([self.fresh_np, new])
            self._fresh_cache = None

    def remove_fresh(self, slots) -> None:
        """Drop removed slots from the fresh list."""
        if self.fresh_np.size:
            keep = ~np.isin(self.fresh_np, np.asarray(slots, dtype=np.int64))
            if not keep.all():
                self.fresh_np = self.fresh_np[keep]
                self._fresh_cache = None

    def _fresh_state(self, cap: int, dev):
        """(fresh slots padded to a multiple of 128 with -1, probe mask),
        rebuilt when the list or the capacity changes."""
        if self._fresh_cache is None or self._fresh_cache[0] != cap:
            f = self.fresh_np
            padded = np.full(max(-(-len(f) // 128) * 128, 128), -1, dtype=np.int32)
            padded[: len(f)] = f
            fresh = torch.as_tensor(padded, device=dev)
            self._fresh_cache = (cap, fresh, _fresh_probe_mask(fresh, cap))
            self.generation += 1
        return self._fresh_cache[1], self._fresh_cache[2]

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def nprobe_for(self, expansion_search: int, connectivity: int = 16) -> int:
        budget = max(expansion_search, 1) * max(connectivity, 1)
        c, _ = self._shape()
        return int(np.clip(math.ceil(budget / self.avg_rows_per_part), 1, c))

    def scanned_rows(self, expansion_search: int, connectivity: int = 16) -> int:
        return int(self.nprobe_for(expansion_search, connectivity) * self._shape()[1] + self.fresh_np.size)

    def plan(self, index, n_q: int, valid, k: int, expansion_search: int):
        """The host's part of a search of ``n_q`` queries: ``(key, body)``,
        ``body(q, valid)`` the device part (the top-k of prepared queries:
        ``[Q, k]`` f32 distances and i32 slots, -1 where none), ``key`` the
        decisions it takes on the host, or None where the body stays eager on
        the card (the copied layout, and the plain probe: `graphs.EAGER`).
        The fresh list's and the shadows' tensors are made here, outside the
        body, and ``bin``'s gate is decided here (`_live_share`): the body
        takes the route the key names."""
        nprobe = self.nprobe_for(expansion_search, index._connectivity)
        fresh_n = int(self.fresh_np.size)
        fresh = probe_mask = None
        if fresh_n:
            fresh, probe_mask = self._fresh_state(int(valid.shape[0]), valid.device)
        # every position live, from host-side counts (no device read): the
        # index's own mask, no fresh rows, and each position a live row or a
        # shadow (live rows fill every other position, so every primary is)
        all_live = (valid is index._valid and not fresh_n
                    and index._count + self.shadow_np_pos.size == int(index._capacity))
        shadowed = self.inplace_shape is not None and self.spilled and self.shadow_np_pos.size > 0
        if shadowed:
            self._shadows(valid.device)

        key, binned = None, False
        if self.inplace_shape is not None:
            kk = min(2 * k, 128) if shadowed else k
            route = dense_route(index._metric_kind, index._kind, min(n_q, PROBE_QCHUNK), index._table.shape[0], kk,
                                nprobe, self.p_win, metric_fn=index._metric_fn)
            if route == "bin":
                w_pad = padded_window(self.p_win)
                binned = _binned_ok(index._metric_kind, index._kind, index._table.shape[1], kk, nprobe, w_pad,
                                    lambda: self._live_share(valid, probe_mask))
                route = "bin" if binned else _bin_fallback(kk, nprobe, w_pad)
            if route in CAPTURED_ROUTES:
                key = ("ivf", route, nprobe, kk, all_live, 0 if fresh is None else int(fresh.shape[0]),
                       int(self.shadow_np_pos.size) if shadowed else 0)

        def body(q, valid):
            probe_valid = valid if probe_mask is None else valid & probe_mask
            d, slots = self._search_built(index, q, probe_valid, k, nprobe, all_live, binned)
            if fresh is None:
                return d, slots
            df, sf = _fresh_topk(index._metric_kind, index._kind, q, index._table, index._stats, valid,
                                 fresh, index._ndim, min(k, int(fresh.shape[0])), index._metric_fn)
            # on equal distances the probed entries, then earlier ones, win
            return staged_topk(torch.cat([d, df], dim=1),
                               torch.cat([slots.to(torch.int32), sf.to(torch.int32)], dim=1), k)

        return key, body

    def _search_built(self, index, q, valid, k: int, nprobe: int, all_live: bool, binned: bool):
        if self.inplace_shape is not None:
            if self.spilled and self.shadow_np_pos.size:
                # shadows: probe at twice the depth with the extended mask,
                # map winners to their primaries, drop duplicates
                pos, src = self._shadows(valid.device)
                d, slots = self._search_dense(index, q, _shadow_extend(valid, pos, src), min(2 * k, 128), nprobe,
                                              all_live, binned)
                return _dedup_trim(d, _shadow_canon(slots.to(torch.int32), pos, src), k)
            return self._search_dense(index, q, valid, k, nprobe, all_live, binned)
        c, p = self.part_slots.shape
        kk = min(2 * k, c * p) if self.spilled else k
        d, slots = _ivf_probe_search(
            index._metric_kind, index._kind, q, _part_valid_compute(valid, self.part_slots), self.centroids,
            self.part_table, self.part_stats, self.part_slots, index._ndim, kk, nprobe, self._groups,
            index._metric_fn)
        if self.spilled and kk > k:
            # a spilled row lives in two partitions: keep its first hit
            return _dedup_trim(d, slots, k)
        return d, slots

    def _live_share(self, valid: torch.Tensor, probe_mask: Optional[torch.Tensor]) -> float:
        """Share of live positions in the mask the dense probe sees (``valid``
        without the fresh rows' ``probe_mask``, the shadows extended): an
        exact count, one scalar read, cached by ``valid``'s identity and
        version (the index updates its own mask in place) and the
        structure's generation (the fresh list's and the shadows' tensors)."""
        c = self._live_cache
        version = (valid._version, self.generation)
        if c is None or c[0] is not valid or c[1] != version:
            seen = valid if probe_mask is None else valid & probe_mask
            if self.spilled and self.shadow_np_pos.size:
                seen = _shadow_extend(seen, *self._shadows(valid.device))
            self._live_cache = c = (valid, version, _live_fraction(seen))
        return c[2]

    def _search_dense(self, index, q, valid, k: int, nprobe: int, all_live: bool, binned: bool):
        return dense_probe(index._metric_kind, index._kind, q, valid, self.centroids, index._table, index._stats,
                           self.starts, self.lens, index._ndim, k, nprobe, self.p_win, all_live=all_live,
                           groups=self._groups, metric_fn=index._metric_fn, binned=binned)
