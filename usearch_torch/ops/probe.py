"""The IVF probe kernels B3, B5, B6 and B7, and their plain versions.

Counterparts of the probe kernels in `usearch_tpu/ops/pallas_probe.py`:

| kernel | TPU kernel; wrapper | here | CUDA |
|---|---|---|---|
| B3 | `_make_grouped_kernel`; `pallas_ivf_probe_grouped` | `grouped_probe` | csrc/probe.cu |
| B5 | `_make_grouped_nofold_kernel`; `pallas_ivf_probe_grouped_nofold` | `grouped_probe_nofold` | csrc/probe.cu |
| B6 | `_make_probe_kernel`; `pallas_ivf_probe` | `pair_probe` | csrc/probe.cu, csrc/pair.cu |
| B7 | `_make_binned_probe_kernel`; `pallas_ivf_probe_binned` | `binned_probe` | csrc/probe.cu |

B3, B5 and B7 take a list of (query, partition) pairs, sorted by partition
and cut into cells of 128 pairs (`ivf._binned_pairs`); each pair owns one
window of the dense cluster-major table, rows ``[win_start, win_start +
win_len)``, inside a padded window of ``w_pad`` rows from its 128-aligned
DMA start. B3 and B5 do, for each pair:

1. every row of its window is scored in rank form (`window_dists`): ip
   ``1 - dot``, cos ``-dot / |t|``, l2sq ``|t|^2 - 2 dot``, plus the
   deleted-row penalty when one is given. Over packed b1 rows (kernel B4,
   the b1 instantiation of B3, B5 and B6) hamming is l2sq's expression with
   popcounts for the squared norms and the and-count (`packbits.bit_dot`)
   for the dot;
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

B6 (`pair_probe`, the ``pair`` flavour) takes no pairs: each query scores
its own ``nprobe`` windows in the coarse selection's order, steps 1-2 over
each padded window (bins counted from its DMA start), and folds each
window's candidates into the query's running top-k, so equal distances
keep the order (window, round, bin). Restricted to one window that order is
B3's, and a window gives at most ``k`` of the result, so on the card B6 is
B3 over the (query, window) pairs (`pair_cells`), each pair's list kept in
rank form (``usearch_pair_lists``), then a fold of each query's lists in
window order (csrc/pair.cu ``usearch_pair_fold``, `pair_fold_plain`).

B7 (`binned_probe`, the ``bin`` flavour, i8 only) takes the pairs but no
window masks, stats or penalty: for every row of the padded window the raw
int32 dot, and per ``bw``-row bin the ``keep`` largest, by a packed key
``(-dot << 5) | row_in_bin`` (``pack``) or by f32 ``-dot`` and the first
argmin (``fminarg``), written round-major as B5 does, the raw ``-dot`` as
f32 beside the global row. The caller masks, rescores and merges.

A pair's result depends on its own window only, so cells only decide which
pairs share the reads of a window. The TPU kernels carried the pair-to-window
slot as f32 in their query aux and packed window lists per cell in SMEM; the
port passes each pair's window start and length as plain int32 tensors. The
TPU kernels' window batching and DMA ring depth (``wb``, ``n_slots``) change
no output and are not parameters here.

The probe kernels have their own metric and dtype codes (`METRIC_CODES`,
`DTYPE_CODES`): hamming over uint8 is theirs alone, never the scan
kernels'. Each wrapper runs the plain version for CPU tensors and the CUDA
kernel for CUDA tensors; there is no fallback between them. Each wrapper's
``launches`` attribute counts its kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..enums import MetricKind
from ..graphs import count_launch
from .distances import I8_F32_EXACT_WIDTH, MASKED, _sqrt, dot
from .packbits import bit_dot
from .scan import _launch, _ptr
from .topk import position_order, stable_topk

#: pairs per cell, and rows per bin
LANES = 128
#: candidates per bin are at most this many (the JAX caller's clamp)
MAX_BIN_M = 16
#: B5 over numeric tables keeps at most this many per bin (its lists)
MAX_NOFOLD_BIN_M = 8
#: the probe kernels' codes (csrc/probe.cu and csrc/pair.cu `Metric`,
#: `DType`); uint8 holds packed b1 rows and goes with hamming only
METRIC_CODES = {MetricKind.IP: 0, MetricKind.Cos: 1, MetricKind.L2sq: 2, MetricKind.Hamming: 3}
DTYPE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2, torch.uint8: 3}
#: B7's selections; the TPU's diagnostic ``dotonly`` returns no result
BIN_SELECTIONS = ("pack", "fminarg")
#: B7 keeps at most this many rows per bin (its per-lane lists)
MAX_KEEP = 8
#: B7's widest rows: the packed key holds ``-dot`` of i8 rows this wide
MAX_BINNED_WIDTH = 2048
#: bytes of the largest gathered temporary of one plain B6 chunk
_PAIR_BUDGET = 128 * 1024 * 1024


def window_dists(metric, dots: torch.Tensor, q_sq: torch.Tensor, t_sq: Optional[torch.Tensor],
                 penalty: Optional[torch.Tensor]) -> torch.Tensor:
    """Rank-form distances of ``[m, R]`` dots, with the penalty of each row
    added when given: the JAX `_window_dists`. ``q_sq`` is ``[m]``; ``t_sq``
    and ``penalty`` are ``[R]``, shared by the ``m`` queries, or ``[m, R]``
    (``t_sq`` None for ip)."""
    dots = dots.float()

    def per_row(x):
        return x if x.dim() == 2 else x[None, :]

    if metric == MetricKind.IP:
        d = 1.0 - dots
    elif metric == MetricKind.Cos:
        zero_t = t_sq == 0.0
        rsqrt_t = torch.where(zero_t, 0.0, 1.0 / _sqrt(torch.where(zero_t, 1.0, t_sq)))
        d = -(dots * per_row(rsqrt_t))
        d = torch.where(per_row(zero_t) & (q_sq[:, None] == 0.0), -1.0, d)
    elif metric in (MetricKind.L2sq, MetricKind.Hamming):
        d = per_row(t_sq) - 2.0 * dots
    else:
        raise ValueError(f"the probe kernels take ip/cos/l2sq/hamming, got {metric}")
    return d if penalty is None else d + per_row(penalty)


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


def _check_rows(metric, q, table, t_sq) -> None:
    """The operands every probe kernel shares: metric and dtype codes,
    ``q [m, W]`` and ``table [N, W]`` of one dtype, ``N`` and ``W``
    multiples of 128, ``t_sq`` for every metric but ip."""
    if metric not in METRIC_CODES:
        raise ValueError(f"the probe kernels take ip/cos/l2sq/hamming, got {metric}")
    if q.dtype not in DTYPE_CODES or table.dtype != q.dtype:
        raise TypeError(f"queries and table must share a dtype of {list(DTYPE_CODES)}: {q.dtype}, {table.dtype}")
    if (metric == MetricKind.Hamming) != (q.dtype == torch.uint8):
        raise TypeError(f"hamming goes with packed uint8 rows and they with it: {metric}, {q.dtype}")
    if q.dim() != 2 or table.dim() != 2 or q.shape[1] != table.shape[1]:
        raise ValueError(f"queries [m, W] and table [N, W] expected: {tuple(q.shape)}, {tuple(table.shape)}")
    if table.shape[0] % LANES or table.shape[1] % LANES:
        raise ValueError(f"table rows and width must be multiples of {LANES}: {tuple(table.shape)}")
    if metric != MetricKind.IP and t_sq is None:
        raise ValueError("cos, l2sq and hamming need t_sq")


def _check_aux(device, required, optional=()) -> None:
    """Each ``(tensor, shape, dtype)`` of ``required``, and of ``optional``
    where its tensor is not None, has that shape and dtype, is contiguous
    and lies on ``device``: the kernels read every operand they are given."""
    for x, shape, dtype in [*required, *(s for s in optional if s[0] is not None)]:
        if x is None:
            raise ValueError(f"a required {dtype} operand of shape {tuple(shape)} is None")
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"expected {dtype} of shape {tuple(shape)}, got {x.dtype} {tuple(x.shape)}")
        if x.device != device or not x.is_contiguous():
            raise ValueError("all operands must be contiguous and on one device")


def _check(metric, q_g, q_sq, table, t_sq, penalty, win_start, win_len, k, bin_m, win_base=None) -> None:
    _check_rows(metric, q_g, table, t_sq)
    p, n = q_g.shape[0], table.shape[0]
    if p % LANES:
        raise ValueError(f"pairs must be a multiple of {LANES}: {p}")
    if not 1 <= k <= 128 or not 1 <= bin_m <= MAX_BIN_M:
        raise ValueError(f"1 <= k <= 128 and 1 <= bin_m <= {MAX_BIN_M} expected, got k={k}, bin_m={bin_m}")
    if metric != MetricKind.IP and penalty is None:
        raise ValueError("cos, l2sq and hamming need the penalty")
    _check_aux(q_g.device, [(q_g, q_g.shape, q_g.dtype), (table, table.shape, table.dtype),
                            (q_sq, (p,), torch.float32), (win_start, (p,), torch.int32),
                            (win_len, (p,), torch.int32)],
               [(t_sq, (n,), torch.float32), (penalty, (n,), torch.float32), (win_base, (p,), torch.int32)])


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


def _round_major(d3: torch.Tensor, first_row: torch.Tensor, keep: int, order=position_order):
    """The ``keep`` smallest of each bin of ``d3 [m, n_bins, bin_rows]``,
    the earlier row first on ties (as rounds of min/argmin extract them),
    laid out round-major: ``([m, keep * n_bins]`` values, global rows),
    with ``first_row [n_bins]`` (or ``[m, n_bins]``) the bins' first rows."""
    m = d3.shape[0]
    bi = order(d3)[..., :keep]
    values = d3.gather(-1, bi).transpose(1, 2).reshape(m, -1)
    rows = (bi + first_row[..., None]).transpose(1, 2).reshape(m, -1)
    return values, rows


def _bin_candidates(metric, q, q_sq, table, t_sq, penalty, r0: int, r1: int, st: int, ln: int, bin_m: int):
    """Rank-form scores of rows ``[r0, r1)`` (whole bins) for queries ``q``,
    rows outside ``[st, st + ln)`` masked, and the ``bin_m`` smallest of
    each bin, round-major (`_round_major`)."""
    n_bins = (r1 - r0) // LANES
    d = window_dists(metric, _dots(q, table[r0:r1]), q_sq, None if t_sq is None else t_sq[r0:r1],
                     None if penalty is None else penalty[r0:r1])
    rows = torch.arange(r0, r1, device=q.device)
    d = torch.where(((rows >= st) & (rows < st + ln))[None, :], d, MASKED)
    return _round_major(d.view(-1, n_bins, LANES), rows.view(n_bins, LANES)[:, 0], bin_m)


def grouped_probe_plain(metric, q_g, q_sq, table, t_sq, penalty, win_start, win_len, k: int, bin_m: int,
                        rank_form: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """What kernel B3 computes, in plain torch: ``[P, k]`` f32 distances
    and i32 global row ids; with ``rank_form`` the distances before
    `rank_epilogue` (B6's lists). Pairs that share a window are scored
    together, one window at a time, so the memory held is one window's
    scores."""
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
        out_d[pairs, :kk] = v if rank_form else rank_epilogue(metric, v, qs)
        out_i[pairs, :kk] = torch.where(v >= MASKED / 2, -1, ids).to(torch.int32)
    return out_d, out_i


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


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
            DTYPE_CODES[q_g.dtype], METRIC_CODES[metric], k, min(bin_m, max(k, 8)), _stream(),
        )
    count_launch(grouped_probe)
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
    plain version for CPU tensors: ip/cos/l2sq over i8/bf16/f32 rows with at
    most `MAX_NOFOLD_BIN_M` per bin (the ``nofold`` flavour), and hamming
    over packed b1 rows (the select of the tanimoto and sorensen probes).
    The penalty row is required."""
    _check(metric, q_g, q_sq, table, t_sq, penalty, win_start, win_len, 1, bin_m, win_base)
    if penalty is None or win_base is None:
        raise ValueError("B5 needs the penalty row and win_base")
    if q_g.dtype != torch.uint8 and bin_m > MAX_NOFOLD_BIN_M:
        raise ValueError(f"B5 over numeric rows keeps at most {MAX_NOFOLD_BIN_M} per bin, got {bin_m}")
    if w_pad <= 0 or w_pad % LANES or w_pad > table.shape[0]:
        raise ValueError(f"B5 takes 0 < w_pad <= table rows, a multiple of {LANES}: {w_pad}")
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
            DTYPE_CODES[q_g.dtype], METRIC_CODES[metric], w_pad, bin_m, _stream(),
        )
    count_launch(grouped_probe_nofold)
    return out_d, out_i


grouped_probe_nofold.launches = 0


# ----------------------------------------------------------------------
# B6: the per-query probe
# ----------------------------------------------------------------------


def _check_pair(metric, q, q_sq, table, t_sq, penalty, starts, offs, lens, k, w_pad, bin_m) -> None:
    _check_rows(metric, q, table, t_sq)
    if starts.dim() != 2 or starts.shape[0] != q.shape[0] or starts.shape[1] < 1:
        raise ValueError(f"starts [Q, nprobe] expected: {tuple(starts.shape)}")
    if not 1 <= k <= 128 or bin_m < 1:
        raise ValueError(f"1 <= k <= 128 and bin_m >= 1 expected, got k={k}, bin_m={bin_m}")
    if w_pad <= 0 or w_pad % LANES or w_pad > table.shape[0]:
        raise ValueError(f"B6 takes 0 < w_pad <= table rows, a multiple of {LANES}: {w_pad}")
    n, grid = table.shape[0], tuple(starts.shape)
    _check_aux(q.device, [(q, q.shape, q.dtype), (table, table.shape, table.dtype),
                          (q_sq, (q.shape[0],), torch.float32), (starts, grid, torch.int32),
                          (offs, grid, torch.int32), (lens, grid, torch.int32)],
               [(t_sq, (n,), torch.float32), (penalty, (n,), torch.float32)])


def _gathered_dots(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``[m, W] . [m, R, W] -> [m, R]`` f32 dots of each query with its own
    rows (i8 in a float type that holds the sums exactly); and-counts of
    packed uint8 rows."""
    if q.dtype == torch.uint8:
        return bit_dot(q[:, None, :], rows)[:, 0]
    acc = torch.float64 if q.dtype == torch.int8 and q.shape[-1] > I8_F32_EXACT_WIDTH else torch.float32
    return torch.bmm(rows.to(acc), q.to(acc)[:, :, None])[..., 0].float()


def pair_probe_plain(metric, q, q_sq, table, t_sq, penalty, starts, offs, lens, k: int, w_pad: int,
                     bin_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """What kernel B6 computes, in plain torch: ``[Q, k]`` f32 distances
    and i32 global row ids. Query ``i``'s window ``j`` is the padded window
    of ``w_pad`` rows from ``starts[i, j]`` (128-aligned) with its rows
    ``[offs, offs + lens)`` in play; each 128-row bin of it gives its
    ``min(bin_m, k)`` best (`_round_major`), and the ``k`` best of all the
    candidates are kept in (distance, window, round, bin) order, the order
    in which the TPU kernel's running fold meets them. A window that does
    not lie inside the table finds nothing. Queries run in chunks whose
    gathered windows stay under `_PAIR_BUDGET` bytes."""
    (n_q, nprobe), (n_rows, width) = starts.shape, table.shape
    nb_w = w_pad // LANES
    bin_m = min(bin_m, k)
    dev = q.device
    out_d = torch.full((n_q, k), MASKED, dtype=torch.float32, device=dev)
    out_i = torch.full((n_q, k), -1, dtype=torch.int32, device=dev)
    row_bytes = width * (32 if q.dtype == torch.uint8 else 4) + 12
    chunk = max(1, _PAIR_BUDGET // (nprobe * w_pad * row_bytes))
    pos = torch.arange(w_pad, device=dev)
    for lo in range(0, n_q, chunk):
        st, off, ln = (x[lo : lo + chunk].long() for x in (starts, offs, lens))
        m = st.shape[0]
        ok = (ln > 0) & (st >= 0) & (st % LANES == 0) & (st <= n_rows - w_pad) & (off >= 0) & (off <= w_pad - ln)
        rows = torch.where(ok, st, 0)[:, :, None] + pos  # [m, nprobe, w_pad]
        flat = rows.reshape(m, -1)
        qs = q_sq[lo : lo + m]
        d = window_dists(metric, _gathered_dots(q[lo : lo + m], table[flat]), qs,
                         None if t_sq is None else t_sq[flat], None if penalty is None else penalty[flat])
        inside = (pos >= off[:, :, None]) & (pos < (off + ln)[:, :, None]) & ok[:, :, None]
        d = torch.where(inside.reshape(m, -1), d, MASKED)
        cand_v, cand_i = _round_major(d.view(m, nprobe * nb_w, LANES), flat[:, ::LANES], bin_m)
        # round-major over the whole row: regroup as (window, round, bin)
        cand_v = cand_v.view(m, bin_m, nprobe, nb_w).transpose(1, 2).reshape(m, -1)
        cand_i = cand_i.view(m, bin_m, nprobe, nb_w).transpose(1, 2).reshape(m, -1)
        v, sel = stable_topk(cand_v, k)
        kk = v.shape[1]
        out_d[lo : lo + m, :kk] = rank_epilogue(metric, v, qs)
        out_i[lo : lo + m, :kk] = torch.where(v >= MASKED / 2, -1, cand_i.gather(1, sel)).to(torch.int32)
    return out_d, out_i


def pair_cells(starts, offs, lens, n_rows: int, w_pad: int):
    """B6's ``[Q, nprobe]`` windows as B3's pairs: flattened, sorted stably by
    the window's first row so that the pairs reading a window share a cell
    (a padded window's windows stay together, empty ones last), and padded
    to cells of 128 with empty pairs. A window that does not lie inside its
    padded window, or a padded window that is not 128-aligned inside the
    table, gets length 0. Returns each pair's query, window start and length
    (int32), and ``inv [Q, nprobe]``, the pair of each (query, window)."""
    n_q, nprobe = starts.shape
    p0 = n_q * nprobe
    p_total = -(-p0 // LANES) * LANES
    st, off, ln = (x.reshape(-1).long() for x in (starts, offs, lens))
    ok = (ln > 0) & (st >= 0) & (st % LANES == 0) & (st <= n_rows - w_pad) & (off >= 0) & (off <= w_pad - ln)
    first = torch.where(ok, st + off, 0)
    order = torch.argsort(torch.where(ok, first, n_rows), stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(p0, device=order.device)
    pad = torch.zeros(p_total - p0, dtype=torch.long, device=order.device)
    qid = torch.cat([order // nprobe, pad])
    win_start = torch.cat([first[order], pad]).int()
    win_len = torch.cat([torch.where(ok, ln, 0)[order], pad]).int()
    return qid, win_start, win_len, inv.view(n_q, nprobe).int()


def pair_fold_plain(metric, lists_d, lists_i, inv, q_sq, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """What B6's fold computes, in plain torch: per query the ``k`` best
    entries of its ``nprobe`` pairs' rank-form lists (``[P, k]``), taken in
    window order through ``inv [Q, nprobe]``, the earlier window and then the
    earlier place first among equal values; `rank_epilogue` applied, ``-1``
    where the distance is at least ``MASKED / 2``."""
    n_q = inv.shape[0]
    d = lists_d[inv.long()].reshape(n_q, -1)
    v, sel = stable_topk(d, k)
    out_d = rank_epilogue(metric, v, q_sq)
    return out_d, torch.where(out_d >= MASKED / 2, -1, lists_i[inv.long()].reshape(n_q, -1).gather(1, sel))


def pair_lists(metric, q, q_sq, table, t_sq, penalty, cells, k: int, bin_m: int):
    """Step 2 of B6 on the card (csrc/probe.cu ``usearch_pair_lists``): B3
    over `pair_cells`' pairs, each pair's first ``k`` in rank form, ``bin_m
    <= k`` per bin."""
    from .. import build

    qid, win_start, win_len, _ = cells
    (n_rows, width), n_pairs = table.shape, win_start.shape[0]
    q_g, qs = q[qid].contiguous(), q_sq[qid].contiguous()
    out_d = torch.empty((n_pairs, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((n_pairs, k), dtype=torch.int32, device=q.device)
    lib = build.load("probe")
    with torch.cuda.device(q.device):
        _launch(
            lib.usearch_pair_lists, _ptr(q_g), _ptr(qs), _ptr(table), _ptr(t_sq), _ptr(penalty), _ptr(win_start),
            _ptr(win_len), _ptr(out_d), _ptr(out_i), n_pairs, n_rows, width, DTYPE_CODES[q.dtype],
            METRIC_CODES[metric], k, bin_m, _stream(),
        )
    return out_d, out_i


def pair_fold(metric, lists_d, lists_i, inv, q_sq, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 3 of B6 on the card (csrc/pair.cu ``usearch_pair_fold``)."""
    from .. import build

    n_q, nprobe = inv.shape
    out_d = torch.empty((n_q, k), dtype=torch.float32, device=inv.device)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=inv.device)
    lib = build.load("pair")
    with torch.cuda.device(inv.device):
        _launch(
            lib.usearch_pair_fold, _ptr(lists_d), _ptr(lists_i), _ptr(inv), _ptr(q_sq), _ptr(out_d), _ptr(out_i),
            n_q, nprobe, k, METRIC_CODES[metric], _stream(),
        )
    return out_d, out_i


def pair_probe(metric, q, q_sq, table, t_sq, penalty, starts, offs, lens, k: int, w_pad: int,
               bin_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B6, or its plain version for CPU tensors. ``q [Q, W]`` are
    the queries and ``q_sq [Q]`` their squared norms (popcounts for b1);
    ``starts``, ``offs`` and ``lens`` are ``[Q, nprobe]`` int32: each probed
    window's 128-aligned DMA start, the window's offset inside it and its
    length. Bins keep ``min(bin_m, k)`` candidates (``pallas_ivf_probe``'s
    clamp), up to 128. On the card: `pair_cells`, then B3's tensor-core
    kernel (f32 rows through the three-pass TF32 product) for each pair's list in
    rank form (`pair_lists`), then `pair_fold`; one launch of B6 a call."""
    _check_pair(metric, q, q_sq, table, t_sq, penalty, starts, offs, lens, k, w_pad, bin_m)
    if q.device.type == "cpu":
        return pair_probe_plain(metric, q, q_sq, table, t_sq, penalty, starts, offs, lens, k, w_pad, bin_m)
    if q.shape[0] == 0:
        empty = torch.empty((0, k), device=q.device)
        return empty, empty.int()
    cells = pair_cells(starts, offs, lens, table.shape[0], w_pad)
    lists_d, lists_i = pair_lists(metric, q, q_sq, table, t_sq, penalty, cells, k, min(bin_m, k))
    out = pair_fold(metric, lists_d, lists_i, cells[3], q_sq, k)
    count_launch(pair_probe)
    return out


pair_probe.launches = 0


# ----------------------------------------------------------------------
# B7: the packed-key binned probe
# ----------------------------------------------------------------------


def binned_width(keep: int, w_pad: int, bw: int) -> int:
    """Columns of B7's output: ``keep`` per ``bw``-row bin of the padded
    window, rounded up to a multiple of 128."""
    return -(-keep * (w_pad // bw) // LANES) * LANES


def _check_binned(q_g, table, win_base, w_pad: int, bw: int, keep: int, sel: str) -> None:
    if sel not in BIN_SELECTIONS:
        raise ValueError(f"B7 selects by {BIN_SELECTIONS}, got {sel!r} (the TPU diagnostic 'dotonly' is not ported)")
    if q_g.dtype != torch.int8 or table.dtype != torch.int8:
        raise TypeError(f"B7 takes i8 rows: {q_g.dtype}, {table.dtype}")
    _check_rows(MetricKind.IP, q_g, table, None)
    if q_g.shape[0] % LANES or q_g.shape[1] > MAX_BINNED_WIDTH:
        raise ValueError(f"B7 takes pairs in cells of {LANES} and rows of at most {MAX_BINNED_WIDTH}: "
                         f"{tuple(q_g.shape)}")
    if bw & (bw - 1) or not 2 * keep <= bw <= (32 if sel == "pack" else LANES) or not 1 <= keep <= MAX_KEEP:
        raise ValueError(f"B7 takes a power-of-two bw with 2 keep <= bw <= {32 if sel == 'pack' else LANES} "
                         f"and 1 <= keep <= {MAX_KEEP}: bw={bw}, keep={keep}")
    if w_pad <= 0 or w_pad % LANES or w_pad > table.shape[0]:
        raise ValueError(f"B7 takes 0 < w_pad <= table rows, a multiple of {LANES}: {w_pad}")
    _check_aux(q_g.device, [(q_g, q_g.shape, q_g.dtype), (table, table.shape, table.dtype),
                            (win_base, (q_g.shape[0],), torch.int32)])


def _exact_dots(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``[m, W] x [R, W]`` i8 dots as exact int64."""
    acc = torch.float32 if q.shape[-1] <= I8_F32_EXACT_WIDTH else torch.float64
    return (q.to(acc) @ t.to(acc).T).long()


def binned_probe_plain(q_g, table, win_base, w_pad: int, bw: int, keep: int,
                       sel: str = "pack") -> Tuple[torch.Tensor, torch.Tensor]:
    """What kernel B7 computes, in plain torch: ``[P, out_pad]`` f32 raw
    keys ``-dot`` and i32 global rows, the ``keep`` rows of largest dot per
    ``bw``-row bin of each pair's padded window ``[win_base, win_base +
    w_pad)``, round-major, ``MASKED``/-1 past ``keep * w_pad / bw``.
    ``pack`` orders by the exact ``-dot``, ``fminarg`` by ``-dot`` rounded
    to f32 (the same below ``|dot| < 2**24``), the lower row first on ties.
    A padded window that is not 128-aligned inside the table finds
    nothing."""
    n_pairs, n_rows = q_g.shape[0], table.shape[0]
    nbw = w_pad // bw
    dev = q_g.device
    out_d = torch.full((n_pairs, binned_width(keep, w_pad, bw)), MASKED, dtype=torch.float32, device=dev)
    out_i = torch.full(out_d.shape, -1, dtype=torch.int32, device=dev)
    base = win_base.long()
    ok = (base >= 0) & (base % LANES == 0) & (base <= n_rows - w_pad)
    bases, owner = torch.unique(torch.where(ok, base, -1), return_inverse=True)
    order = torch.argsort(owner, stable=True)
    bounds = torch.cumsum(torch.bincount(owner, minlength=bases.shape[0]), 0).tolist()
    first = torch.arange(0, w_pad, bw, device=dev)
    by_key = lambda x: torch.sort(x, dim=-1, stable=True)[1]  # noqa: E731
    by_f32 = lambda x: position_order(x.float())  # noqa: E731
    lo = 0
    for b, hi in zip(bases.tolist(), bounds):
        pairs, lo = order[lo:hi], hi
        if b < 0:
            continue
        neg = -_exact_dots(q_g[pairs], table[b : b + w_pad]).view(-1, nbw, bw)
        v, rows = _round_major(neg, b + first, keep, by_key if sel == "pack" else by_f32)
        out_d[pairs, : keep * nbw] = v.float()
        out_i[pairs, : keep * nbw] = rows.to(torch.int32)
    return out_d, out_i


def binned_probe(q_g, table, win_base, w_pad: int, bw: int, keep: int,
                 sel: str = "pack") -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B7 (csrc/probe.cu `usearch_binned_probe`), or its plain
    version for CPU tensors. ``q_g [P, W]`` i8 are the pairs' query rows
    and ``win_base [P]`` their padded windows' 128-aligned starts."""
    _check_binned(q_g, table, win_base, w_pad, bw, keep, sel)
    if q_g.device.type == "cpu":
        return binned_probe_plain(q_g, table, win_base, w_pad, bw, keep, sel)
    from .. import build

    n_pairs, (n_rows, width) = q_g.shape[0], table.shape
    out_pad = binned_width(keep, w_pad, bw)
    out_d = torch.empty((n_pairs, out_pad), dtype=torch.float32, device=q_g.device)
    out_i = torch.empty((n_pairs, out_pad), dtype=torch.int32, device=q_g.device)
    if n_pairs == 0:
        return out_d, out_i
    lib = build.load("probe")
    with torch.cuda.device(q_g.device):
        _launch(
            lib.usearch_binned_probe, _ptr(q_g), _ptr(table), _ptr(win_base), _ptr(out_d), _ptr(out_i), n_pairs,
            n_rows, width, w_pad, bw, keep, int(sel == "fminarg"), _stream(),
        )
    count_launch(binned_probe)
    return out_d, out_i


binned_probe.launches = 0
