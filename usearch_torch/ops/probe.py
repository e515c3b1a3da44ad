"""The grouped IVF probes: kernels B3 and B5 and their plain versions.

Counterpart of `_make_grouped_kernel` / `pallas_ivf_probe_grouped` (B3) and
`_make_grouped_nofold_kernel` / `pallas_ivf_probe_grouped_nofold` (B5) in
`usearch_tpu/ops/pallas_probe.py`. The input is a list of (query,
partition) pairs, sorted by partition and cut into cells of 128 pairs; each
pair owns one window of the dense cluster-major table, rows
``[win_start, win_start + win_len)``. For each pair:

1. every row of its window is scored in rank form (`window_dists`): ip
   ``1 - dot``, cos ``-dot / |t|``, l2sq ``|t|^2 - 2 dot``, plus the
   deleted-row penalty when one is given. Over packed b1 rows (kernel B4,
   the b1 instantiation of B3) hamming is l2sq's expression with popcounts
   for the squared norms and the and-count (`packbits.bit_dot`) for the
   dot;
2. each 128-row bin of the table (bins aligned to multiples of 128 rows)
   keeps its ``bin_m`` smallest rows, the lower row first on ties;
3. the ``max(k, 8)`` smallest of those candidates are kept, taken in
   (extraction round, bin) order, the earlier candidate first on ties;
4. `rank_epilogue` restores the metric's distances, and the first ``k``
   are returned with the global row ids, ``-1`` where the distance is at
   least ``MASKED / 2``.

B5 (`grouped_probe_nofold`) stops after step 2: it writes every pair's
``bin_m`` best per bin of its padded window, ``w_pad`` rows from the
128-aligned ``win_base``, round-major (round ``j`` of bin ``b`` at column
``j * nb_w + b``, ``nb_w = w_pad / 128``) into ``[P, out_pad]``, with
`rank_epilogue` applied and ``MASKED``/-1 in every other column; the caller
merges.

A pair's result depends on its own window only, so cells only decide which
pairs share the reads of a window. The TPU kernels carried the pair-to-window
slot as f32 in their query aux and packed window lists per cell in SMEM; the
port passes each pair's window start and length as plain int32 tensors.

The probe kernels have their own metric and dtype codes (`METRIC_CODES`,
`DTYPE_CODES`): hamming over uint8 is theirs alone, never the scan
kernels'. Each wrapper runs the plain version for CPU tensors and the CUDA
kernel (csrc/probe.cu) for CUDA tensors; there is no fallback between them.
``grouped_probe.launches`` and ``grouped_probe_nofold.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..enums import MetricKind
from .distances import MASKED, _sqrt, dot
from .packbits import bit_dot
from .scan import _launch, _ptr
from .topk import position_order, stable_topk

#: pairs per cell, and rows per bin
LANES = 128
#: candidates per bin are at most this many (the JAX caller's clamp)
MAX_BIN_M = 16
#: the probe kernels' codes (csrc/probe.cu `Metric`, `DType`); uint8 holds
#: packed b1 rows and goes with hamming only
METRIC_CODES = {MetricKind.IP: 0, MetricKind.Cos: 1, MetricKind.L2sq: 2, MetricKind.Hamming: 3}
DTYPE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2, torch.uint8: 3}


def window_dists(metric, dots: torch.Tensor, q_sq: torch.Tensor, t_sq: Optional[torch.Tensor],
                 penalty: Optional[torch.Tensor]) -> torch.Tensor:
    """Rank-form distances of ``[m, R]`` dots, with the penalty of each row
    added when given: the JAX `_window_dists`. ``q_sq`` is ``[m]``, ``t_sq``
    and ``penalty`` ``[R]`` (``t_sq`` None for ip)."""
    dots = dots.float()
    if metric == MetricKind.IP:
        d = 1.0 - dots
    elif metric == MetricKind.Cos:
        zero_t = t_sq == 0.0
        rsqrt_t = torch.where(zero_t, 0.0, 1.0 / _sqrt(torch.where(zero_t, 1.0, t_sq)))
        d = -(dots * rsqrt_t[None, :])
        d = torch.where(zero_t[None, :] & (q_sq[:, None] == 0.0), -1.0, d)
    elif metric in (MetricKind.L2sq, MetricKind.Hamming):
        d = t_sq[None, :] - 2.0 * dots
    else:
        raise ValueError(f"the probe kernels take ip/cos/l2sq/hamming, got {metric}")
    return d if penalty is None else d + penalty[None, :]


def rank_epilogue(metric, acc: torch.Tensor, q_sq: torch.Tensor) -> torch.Tensor:
    """Rank-form ``[m, k]`` back to the metric's distances with the
    per-query terms `window_dists` dropped; entries at or above
    ``MASKED / 2`` pass through: the JAX `_rank_epilogue`."""
    if metric == MetricKind.IP:
        return acc
    qs = q_sq[:, None]
    keep = acc >= MASKED / 2
    if metric in (MetricKind.L2sq, MetricKind.Hamming):
        return torch.where(keep, acc, torch.clamp_min(acc + qs, 0.0))
    scale = torch.where(qs == 0.0, 1.0, 1.0 / _sqrt(torch.where(qs == 0.0, 1.0, qs)))
    return torch.where(keep, acc, 1.0 + acc * scale)


def _check(metric, q_g, q_sq, table, t_sq, penalty, win_start, win_len, k, bin_m, win_base=None) -> None:
    if metric not in METRIC_CODES:
        raise ValueError(f"the probe kernels take ip/cos/l2sq/hamming, got {metric}")
    if q_g.dtype not in DTYPE_CODES or table.dtype != q_g.dtype:
        raise TypeError(f"q_g and table must share a dtype of {list(DTYPE_CODES)}: {q_g.dtype}, {table.dtype}")
    if (metric == MetricKind.Hamming) != (q_g.dtype == torch.uint8):
        raise TypeError(f"hamming goes with packed uint8 rows and they with it: {metric}, {q_g.dtype}")
    if q_g.dim() != 2 or table.dim() != 2 or q_g.shape[1] != table.shape[1]:
        raise ValueError(f"q_g [P, W] and table [N, W] expected: {tuple(q_g.shape)}, {tuple(table.shape)}")
    p, (n, width) = q_g.shape[0], table.shape
    if p % LANES or n % LANES or width % LANES:
        raise ValueError(f"pairs, table rows and width must be multiples of {LANES}: {p}, {tuple(table.shape)}")
    if not 1 <= k <= 128 or not 1 <= bin_m <= MAX_BIN_M:
        raise ValueError(f"1 <= k <= 128 and 1 <= bin_m <= {MAX_BIN_M} expected, got k={k}, bin_m={bin_m}")
    if metric != MetricKind.IP and (t_sq is None or penalty is None):
        raise ValueError("cos, l2sq and hamming need t_sq and the penalty")
    aux = [(q_sq, p, torch.float32), (win_start, p, torch.int32), (win_len, p, torch.int32)]
    aux += [(x, n, torch.float32) for x in (t_sq, penalty) if x is not None]
    aux += [(win_base, p, torch.int32)] if win_base is not None else []
    for x, length, dtype in aux:
        if x.dtype != dtype or x.shape != (length,):
            raise ValueError(f"expected {dtype} of length {length}, got {x.dtype} {tuple(x.shape)}")
    for x in (q_g, table, q_sq, t_sq, penalty, win_start, win_len, win_base):
        if x is not None and (x.device != q_g.device or not x.is_contiguous()):
            raise ValueError("all operands must be contiguous and on one device")


def _dots(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``[m, W] x [R, W]`` f32 dots; and-counts of packed uint8 rows."""
    return bit_dot(q, t) if q.dtype == torch.uint8 else dot(q, t)


def _windows(win_start, win_len, n_rows: int, win_base=None):
    """The distinct windows of the pairs, as ``(pairs, base, start,
    length)``: the pairs that share each one, the first row of its first
    bin (``win_base``, else the start aligned down to 128 rows), its start
    and length. A window past the table has length 0."""
    start = win_start.long()
    ok = (start >= 0) & (start + win_len <= n_rows) & (win_len > 0)
    base = start // LANES * LANES if win_base is None else win_base.long()
    key = torch.stack([base, start, win_len.long()], dim=1) * ok[:, None]
    windows, owner = torch.unique(key, dim=0, return_inverse=True)
    order = torch.argsort(owner, stable=True)
    bounds = torch.cumsum(torch.bincount(owner, minlength=windows.shape[0]), 0).tolist()
    lo = 0
    for (b, st, ln), hi in zip(windows.tolist(), bounds):
        pairs, lo = order[lo:hi], hi
        yield pairs, b, st, ln


def _bin_candidates(metric, q, q_sq, table, t_sq, penalty, r0: int, r1: int, st: int, ln: int, bin_m: int):
    """Rank-form scores of rows ``[r0, r1)`` (whole bins) for queries ``q``,
    rows outside ``[st, st + ln)`` masked, and the ``bin_m`` smallest of
    each bin, the lower row first on ties (as rounds of min/argmin extract
    them), laid out round-major: ``([m, bin_m * n_bins]`` values, global
    rows)."""
    n_bins = (r1 - r0) // LANES
    d = window_dists(metric, _dots(q, table[r0:r1]), q_sq, None if t_sq is None else t_sq[r0:r1],
                     None if penalty is None else penalty[r0:r1])
    rows = torch.arange(r0, r1, device=q.device)
    d = torch.where(((rows >= st) & (rows < st + ln))[None, :], d, MASKED)
    d3 = d.view(-1, n_bins, LANES)
    bi = position_order(d3)[..., :bin_m]
    cand_v = d3.gather(-1, bi).transpose(1, 2).reshape(q.shape[0], -1)
    cand_i = (bi + rows.view(n_bins, LANES)[:, :1]).transpose(1, 2).reshape(q.shape[0], -1)
    return cand_v, cand_i


def grouped_probe_plain(metric, q_g, q_sq, table, t_sq, penalty, win_start, win_len, k: int,
                        bin_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """What kernel B3 computes, in plain torch: ``[P, k]`` f32 distances
    and i32 global row ids. Pairs that share a window are scored together,
    one window at a time, so the memory held is one window's scores."""
    n_pairs, n_rows = q_g.shape[0], table.shape[0]
    k_pad = max(k, 8)
    bin_m = min(bin_m, k_pad)
    dev = q_g.device
    out_d = torch.full((n_pairs, k), MASKED, dtype=torch.float32, device=dev)
    out_i = torch.full((n_pairs, k), -1, dtype=torch.int32, device=dev)
    for pairs, r0, st, ln in _windows(win_start, win_len, n_rows):
        if ln == 0:
            continue
        r1 = (st + ln + LANES - 1) // LANES * LANES
        qs = q_sq[pairs]
        cand_v, cand_i = _bin_candidates(metric, q_g[pairs], qs, table, t_sq, penalty, r0, r1, st, ln, bin_m)
        v, sel = stable_topk(cand_v, k)
        ids = cand_i.gather(1, sel)
        kk = v.shape[1]
        out_d[pairs, :kk] = rank_epilogue(metric, v, qs)
        out_i[pairs, :kk] = torch.where(v >= MASKED / 2, -1, ids).to(torch.int32)
    return out_d, out_i


def grouped_probe(metric, q_g, q_sq, table, t_sq, penalty, win_start, win_len, k: int,
                  bin_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3 (csrc/probe.cu `usearch_grouped_probe`), or its plain
    version for CPU tensors. ``q_g [P, W]`` are the pairs' query rows,
    ``q_sq [P]`` their squared norms; ``t_sq`` is None for ip and
    ``penalty`` None when every row is live (ip only)."""
    _check(metric, q_g, q_sq, table, t_sq, penalty, win_start, win_len, k, bin_m)
    if q_g.device.type == "cpu":
        return grouped_probe_plain(metric, q_g, q_sq, table, t_sq, penalty, win_start, win_len, k, bin_m)
    from .. import build

    n_pairs, (n_rows, width) = q_g.shape[0], table.shape
    out_d = torch.empty((n_pairs, k), dtype=torch.float32, device=q_g.device)
    out_i = torch.empty((n_pairs, k), dtype=torch.int32, device=q_g.device)
    if n_pairs == 0:
        return out_d, out_i
    lib = build.load("probe")
    with torch.cuda.device(q_g.device):
        _launch(
            lib.usearch_grouped_probe, _ptr(q_g), _ptr(q_sq), _ptr(table), _ptr(t_sq), _ptr(penalty),
            _ptr(win_start), _ptr(win_len), _ptr(out_d), _ptr(out_i), n_pairs, n_rows, width,
            DTYPE_CODES[q_g.dtype], METRIC_CODES[metric], k, min(bin_m, max(k, 8)),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    grouped_probe.launches += 1
    return out_d, out_i


grouped_probe.launches = 0


def nofold_width(bin_m: int, w_pad: int) -> int:
    """Columns of B5's output: ``bin_m`` per bin of the padded window,
    rounded up to a multiple of 128."""
    return -(-bin_m * (w_pad // LANES) // LANES) * LANES


def grouped_probe_nofold_plain(metric, q_g, q_sq, table, t_sq, penalty, win_base, win_start, win_len,
                               w_pad: int, bin_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """What kernel B5 computes, in plain torch: ``[P, out_pad]`` f32
    distances and i32 global row ids, ``bin_m`` per 128-row bin of each
    pair's padded window ``[win_base, win_base + w_pad)``, round-major.
    A window that does not lie inside its padded window, or a padded window
    that is not 128-aligned inside the table, finds nothing."""
    n_pairs, n_rows = q_g.shape[0], table.shape[0]
    nb_w = w_pad // LANES
    dev = q_g.device
    out_d = torch.full((n_pairs, nofold_width(bin_m, w_pad)), MASKED, dtype=torch.float32, device=dev)
    out_i = torch.full(out_d.shape, -1, dtype=torch.int32, device=dev)
    for pairs, base, st, ln in _windows(win_start, win_len, n_rows, win_base):
        if ln == 0 or base % LANES or st < base or st + ln > base + w_pad or base + w_pad > n_rows:
            continue
        qs = q_sq[pairs]
        v, ids = _bin_candidates(metric, q_g[pairs], qs, table, t_sq, penalty, base, base + w_pad, st, ln, bin_m)
        v = rank_epilogue(metric, v, qs)
        out_d[pairs, : bin_m * nb_w] = torch.where(v >= MASKED / 2, MASKED, v)
        out_i[pairs, : bin_m * nb_w] = torch.where(v >= MASKED / 2, -1, ids).to(torch.int32)
    return out_d, out_i


def grouped_probe_nofold(metric, q_g, q_sq, table, t_sq, penalty, win_base, win_start, win_len, w_pad: int,
                         bin_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B5 (csrc/probe.cu `usearch_grouped_probe_nofold`), or its
    plain version for CPU tensors. It takes packed b1 rows with hamming,
    the select of the tanimoto and sorensen probes."""
    _check(metric, q_g, q_sq, table, t_sq, penalty, win_start, win_len, 1, bin_m, win_base)
    if metric != MetricKind.Hamming or w_pad <= 0 or w_pad % LANES or w_pad > table.shape[0]:
        raise ValueError(f"B5 takes hamming and 0 < w_pad <= table rows, a multiple of {LANES}: {metric}, {w_pad}")
    if q_g.device.type == "cpu":
        return grouped_probe_nofold_plain(metric, q_g, q_sq, table, t_sq, penalty, win_base, win_start, win_len,
                                          w_pad, bin_m)
    from .. import build

    n_pairs, (n_rows, width) = q_g.shape[0], table.shape
    out_pad = nofold_width(bin_m, w_pad)
    out_d = torch.empty((n_pairs, out_pad), dtype=torch.float32, device=q_g.device)
    out_i = torch.empty((n_pairs, out_pad), dtype=torch.int32, device=q_g.device)
    if n_pairs == 0:
        return out_d, out_i
    lib = build.load("probe")
    with torch.cuda.device(q_g.device):
        _launch(
            lib.usearch_grouped_probe_nofold, _ptr(q_g), _ptr(q_sq), _ptr(table), _ptr(t_sq), _ptr(penalty),
            _ptr(win_base), _ptr(win_start), _ptr(win_len), _ptr(out_d), _ptr(out_i), n_pairs, n_rows, width,
            DTYPE_CODES[q_g.dtype], METRIC_CODES[metric], w_pad, bin_m,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    grouped_probe_nofold.launches += 1
    return out_d, out_i


grouped_probe_nofold.launches = 0
