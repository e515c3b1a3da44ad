"""The binned scans: kernels B1, B2, B8, B9 and B10, the exact rescore's
kernel, their plain versions, and the searches around them.

Counterpart of `usearch_tpu/ops/pallas_scan.py`. For every query and every
128-row bin of the table, a kernel computes the dots, the metric epilogue
plus the deleted-row penalty, and the bin's minimum (all but B2 also its
first arg-min row). The surface of bin minima is 128x smaller than the
score matrix, which never reaches device memory; a top-k over it picks
candidates, then plain torch finishes:

- `search_binned` (approximate, B1 over the transposed path): the best ``k``
  bins, one row each; in compact mode (f32 storage) ``OVERSAMPLE * k`` bins
  rescored exactly.
- `search_exact` (B2): the best ``k + 4`` bins by minimum, every row of them
  rescored exactly. A row closer than the true k-th distance makes its bin's
  minimum smaller than that distance, so no better row is left out. The
  rescore's dots are one kernel (`block_dots`), the counterpart of
  `pallas_search_exact`'s batched ``dot_general`` over the gathered bins.

B1's and B2's surfaces are ``[Q, N/128]`` (the JAX kernels write
``[N/128, Q]``), so the top-k reads each query's bins contiguously. The
top-k is ``torch.topk``, exact everywhere, where the JAX package uses
``lax.approx_min_k``.

The flat-scan flavours, which the JAX package reaches only through its
ops-level functions (no `Index` path), have the same entry points here:

- `search_fused` (B8, `pallas_search`): the scan keeps each query's running
  top-k of bin minima itself, so the surface never reaches memory;
- `search_fused_stream` (B9, `pallas_search_dma`): B8's result, the bin
  minima gathered and merged every `MERGE_EVERY` bins;
- `search_binned_lanes` (B10, `pallas_search_binned(transposed=False)`):
  B1's surface in the JAX orientation ``[N/128, Q]``.

B8 and B9 return the stable top-k, by (value, bin), of the bin minima,
padded with ``(MASKED, -1)``. The three run one kernel with B1's
tensor-core product and epilogue (csrc/wgmma_common.cuh), so over i8 and
bf16 their distances, and B10's rows, are B1's; over f32 it is the
three-pass TF32 product (`ops/tf32.py` is its plain twin), so B8/B9's f32
distances are B10's and within that product's bound of B1's. Their
TPU kernels' tile sizes and merge interval, and B10's ``split_dot``, change
no output and are not parameters here.

Each kernel wrapper runs the plain version for CPU tensors and the CUDA
kernel (csrc/scan.cu, csrc/fused.cu, csrc/rescore.cu) for CUDA tensors;
there is no fallback between them. Each wrapper's ``launches`` counts its
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..enums import MetricKind, ScalarKind
from ..graphs import count_launch
from .distances import I8_F32_EXACT_WIDTH, MASKED, dists_from_dots, dot, scan_epilogue
from .topk import finish, ordered_topk, sort_pairs, stable_topk, topk_min

LANES = 128
#: most results the fused scans (B8, B9) keep per query
KPAD = 128
#: bins whose minima B9 gathers between merges; no result depends on it
MERGE_EVERY = 8
#: bins beyond k rescored by the exact path: absorbs f32 rounding between
#: the kernel's minima and the rescore (free margin for exact i8 dots)
EXACT_BIN_SLACK = 4
#: survivors a lane of the exact search's staged bin selection (`staged_bins`)
STAGED_SURVIVORS = 4
#: candidates per k that the compact (f32 storage) approximate path rescores
#: exactly; the JAX package's default (USEARCH_TPU_OVERSAMPLE)
OVERSAMPLE = 2
#: bytes of the largest temporary of one chunk of the exact rescore's plain
#: version (`block_dots_plain`)
_RESCORE_BUDGET = 128 * 1024 * 1024
#: widest i8 rows the rescore kernel takes: |dot| <= 2**16 * 2**14 in int32
_I8_DOTS_WIDTH = 1 << 16
#: elements of the score block of one step of the plain versions
_PLAIN_BLOCK = 1 << 26

_METRIC_CODES = {MetricKind.IP: 0, MetricKind.Cos: 1, MetricKind.L2sq: 2}
_DTYPE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def supports(metric: MetricKind, kind: ScalarKind) -> bool:
    """The (metric, storage) pairs the kernels take; the same set as the JAX
    package's, which excludes f16."""
    return metric in _METRIC_CODES and kind in (ScalarKind.BF16, ScalarKind.F32, ScalarKind.I8)


def _check_rows(q, table) -> None:
    if q.dtype not in _DTYPE_CODES or table.dtype != q.dtype:
        raise TypeError(f"q and table must share a dtype of {list(_DTYPE_CODES)}: {q.dtype}, {table.dtype}")
    if q.dim() != 2 or table.dim() != 2 or q.shape[1] != table.shape[1]:
        raise ValueError(f"q [Q, W] and table [N, W] expected: {tuple(q.shape)}, {tuple(table.shape)}")
    n, width = table.shape
    if n % LANES or width % LANES:
        raise ValueError(f"table rows and width must be multiples of {LANES}: {tuple(table.shape)}")


def _check(metric, q, table, q_sq, t_sq, penalty) -> None:
    if metric not in _METRIC_CODES:
        raise ValueError(f"the scan kernels take ip/cos/l2sq, got {metric}")
    _check_rows(q, table)
    n = table.shape[0]
    aux = [(q_sq, q.shape[0]), (penalty, n)] + ([] if metric == MetricKind.IP else [(t_sq, n)])
    for x, length in aux:
        if x is None or x.dtype != torch.float32 or x.shape != (length,):
            raise ValueError(f"aux vectors must be f32 of length {length}")
    for x in (q, table, q_sq, t_sq, penalty):
        if x is not None and (x.device != q.device or not x.is_contiguous()):
            raise ValueError("all operands must be contiguous and on one device")


def _row_blocks(n_q: int, n_rows: int):
    step = max(LANES, (_PLAIN_BLOCK // max(n_q, 1)) // LANES * LANES)
    for off in range(0, n_rows, step):
        yield off, min(off + step, n_rows)


def _plain_bins(metric, q, table, q_sq, t_sq, penalty, shifted: bool, round_bf16: bool):
    """Per-bin minimum and first arg-min row, ``[Q, N/128]`` f32 + i64."""
    n_q, n = q.shape[0], table.shape[0]
    if round_bf16:
        q = q.to(torch.bfloat16)
    vals = torch.empty((n_q, n // LANES), dtype=torch.float32, device=q.device)
    args = torch.empty((n_q, n // LANES), dtype=torch.int64, device=q.device)
    for lo, hi in _row_blocks(n_q, n):
        tile = table[lo:hi].to(torch.bfloat16) if round_bf16 else table[lo:hi]
        ts = None if t_sq is None else t_sq[lo:hi]
        d = scan_epilogue(metric, dot(q, tile), q_sq, ts, penalty[lo:hi], shifted)
        v, a = d.view(n_q, -1, LANES).min(dim=-1)  # first arg-min on ties
        vals[:, lo // LANES : hi // LANES] = v
        args[:, lo // LANES : hi // LANES] = a
    return vals, args


def binned_scan_plain(metric, q, table, q_sq, t_sq, penalty, compact: bool = False):
    """What kernel B1 computes, in plain torch. Returns ``[Q, N/128]``
    minima and rows: f32 + global i32, or (compact) bf16 minima of the
    shifted distance + i8 row within the bin, from bf16-rounded operands."""
    vals, args = _plain_bins(metric, q, table, q_sq, t_sq, penalty, compact, compact)
    if compact:
        return vals.to(torch.bfloat16), args.to(torch.int8)
    base = torch.arange(0, table.shape[0], LANES, device=q.device)
    return vals, (args + base).to(torch.int32)


def binned_minima_plain(metric, q, table, q_sq, t_sq, penalty):
    """What kernel B2 computes, in plain torch: ``[Q, N/128]`` f32 minima."""
    return _plain_bins(metric, q, table, q_sq, t_sq, penalty, False, False)[0]


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {err}")


def binned_scan(metric, q, table, q_sq, t_sq, penalty, compact: bool = False):
    """Kernel B1 (csrc/scan.cu `usearch_binned_scan`), or its plain version
    for CPU tensors. ``t_sq`` may be None for ip."""
    _check(metric, q, table, q_sq, t_sq, penalty)
    if q.device.type == "cpu":
        return binned_scan_plain(metric, q, table, q_sq, t_sq, penalty, compact)
    from .. import build

    n_q, (n, width) = q.shape[0], table.shape
    out_v = torch.empty((n_q, n // LANES), dtype=torch.bfloat16 if compact else torch.float32, device=q.device)
    out_i = torch.empty((n_q, n // LANES), dtype=torch.int8 if compact else torch.int32, device=q.device)
    if n_q == 0 or n == 0:
        return out_v, out_i
    if compact and q.dtype == torch.float32:
        q = q.to(torch.bfloat16)  # the kernel rounds the table itself, as the plain version does
    lib = build.load("scan")
    with torch.cuda.device(q.device):
        _launch(
            lib.usearch_binned_scan, _ptr(q), _ptr(table), _ptr(q_sq), _ptr(t_sq), _ptr(penalty),
            _ptr(out_v), _ptr(out_i), n_q, n, width, _DTYPE_CODES[table.dtype], _METRIC_CODES[metric],
            int(compact), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    count_launch(binned_scan)
    return out_v, out_i


binned_scan.launches = 0


def binned_minima(metric, q, table, q_sq, t_sq, penalty):
    """Kernel B2 (csrc/scan.cu `usearch_binned_minima`), or its plain
    version for CPU tensors."""
    _check(metric, q, table, q_sq, t_sq, penalty)
    if q.device.type == "cpu":
        return binned_minima_plain(metric, q, table, q_sq, t_sq, penalty)
    from .. import build

    n_q, (n, width) = q.shape[0], table.shape
    out_v = torch.empty((n_q, n // LANES), dtype=torch.float32, device=q.device)
    if n_q == 0 or n == 0:
        return out_v
    lib = build.load("scan")
    with torch.cuda.device(q.device):
        _launch(
            lib.usearch_binned_minima, _ptr(q), _ptr(table), _ptr(q_sq), _ptr(t_sq), _ptr(penalty),
            _ptr(out_v), n_q, n, width, _DTYPE_CODES[q.dtype], _METRIC_CODES[metric],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    count_launch(binned_minima)
    return out_v


binned_minima.launches = 0


def _check_k(k: int) -> None:
    if not 1 <= k <= KPAD:
        raise ValueError(f"the fused scans keep 1 to {KPAD} results per query, got k={k}")


def fused_topk_plain(metric, q, table, q_sq, t_sq, penalty, k: int):
    """What kernels B8 and B9 compute, in plain torch: ``[Q, k]`` f32 + i32,
    the first ``k`` of ``[MASKED] * k ++ bin minima`` in a stable sort by
    value (ties to the earlier bin), ids -1 where the distance is at least
    ``MASKED / 2``. No ``torch.topk``: its tie order is not the contract."""
    return topk_of_minima(*binned_scan_plain(metric, q, table, q_sq, t_sq, penalty), k)


def topk_of_minima(vals: torch.Tensor, rows: torch.Tensor, k: int):
    """B8/B9's selection over a ``[Q, N/128]`` surface of bin minima and
    their i32 rows: the first ``k`` of ``[MASKED] * k ++ minima`` in a
    stable sort by value, ids -1 at or above ``MASKED / 2``."""
    n_q = vals.shape[0]
    pad_v = torch.full((n_q, k), MASKED, dtype=torch.float32, device=vals.device)
    pad_i = torch.full((n_q, k), -1, dtype=torch.int32, device=vals.device)
    d, sel = stable_topk(torch.cat([pad_v, vals], dim=1), k)
    ids = torch.cat([pad_i, rows], dim=1).gather(1, sel)
    return d, torch.where(d >= MASKED / 2, -1, ids)


def _launch_fused(wrapper, fn_name: str, metric, q, table, q_sq, t_sq, penalty, k: int, *extra):
    """B8 or B9 into new ``[Q, k]`` outputs, counted on ``wrapper``; an
    empty table or batch gives ``(MASKED, -1)`` without a launch."""
    from .. import build

    n_q, (n, width) = q.shape[0], table.shape
    out_d = torch.full((n_q, k), MASKED, dtype=torch.float32, device=q.device)
    out_i = torch.full((n_q, k), -1, dtype=torch.int32, device=q.device)
    if n_q == 0 or n == 0:
        return out_d, out_i
    lib = build.load("fused")
    with torch.cuda.device(q.device):
        _launch(
            getattr(lib, fn_name), _ptr(q), _ptr(table), _ptr(q_sq), _ptr(t_sq), _ptr(penalty), _ptr(out_d),
            _ptr(out_i), n_q, n, width, _DTYPE_CODES[q.dtype], _METRIC_CODES[metric], k, *extra,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    count_launch(wrapper)
    return out_d, out_i


def fused_topk(metric, q, table, q_sq, t_sq, penalty, k: int):
    """Kernel B8 (csrc/fused.cu `usearch_fused_topk`), or its plain version
    for CPU tensors: each query's top ``k <= 128`` bin minima and their
    rows, ``[Q, k]`` f32 + i32."""
    _check(metric, q, table, q_sq, t_sq, penalty)
    _check_k(k)
    if q.device.type == "cpu":
        return fused_topk_plain(metric, q, table, q_sq, t_sq, penalty, k)
    return _launch_fused(fused_topk, "usearch_fused_topk", metric, q, table, q_sq, t_sq, penalty, k)


fused_topk.launches = 0


def fused_topk_stream(metric, q, table, q_sq, t_sq, penalty, k: int):
    """Kernel B9 (csrc/fused.cu `usearch_fused_topk_stream`), or the plain
    version of B8 for CPU tensors: B8's result, the bin minima gathered in
    shared memory and merged every `MERGE_EVERY` bins."""
    _check(metric, q, table, q_sq, t_sq, penalty)
    _check_k(k)
    if q.device.type == "cpu":
        return fused_topk_plain(metric, q, table, q_sq, t_sq, penalty, k)
    return _launch_fused(fused_topk_stream, "usearch_fused_topk_stream", metric, q, table, q_sq, t_sq, penalty, k,
                         MERGE_EVERY)


fused_topk_stream.launches = 0


def binned_scan_lanes_plain(metric, q, table, q_sq, t_sq, penalty):
    """What kernel B10 computes, in plain torch: B1's surface transposed,
    ``[N/128, Q]`` f32 minima + global i32 rows."""
    vals, rows = binned_scan_plain(metric, q, table, q_sq, t_sq, penalty)
    return vals.T.contiguous(), rows.T.contiguous()


def binned_scan_lanes(metric, q, table, q_sq, t_sq, penalty):
    """Kernel B10 (csrc/fused.cu `usearch_binned_scan_lanes`), or its plain
    version for CPU tensors. The kernel reduces each bin as soon as its
    product is done, the schedule ``split_dot`` asks the TPU kernel for: B8's
    tensor-core kernel, which stores each 256-row tile's two bins (f32 rows
    through the three-pass TF32 product)."""
    _check(metric, q, table, q_sq, t_sq, penalty)
    if q.device.type == "cpu":
        return binned_scan_lanes_plain(metric, q, table, q_sq, t_sq, penalty)
    from .. import build

    n_q, (n, width) = q.shape[0], table.shape
    out_v = torch.empty((n // LANES, n_q), dtype=torch.float32, device=q.device)
    out_i = torch.empty((n // LANES, n_q), dtype=torch.int32, device=q.device)
    if n_q == 0 or n == 0:
        return out_v, out_i
    lib = build.load("fused")
    with torch.cuda.device(q.device):
        _launch(
            lib.usearch_binned_scan_lanes, _ptr(q), _ptr(table), _ptr(q_sq), _ptr(t_sq), _ptr(penalty),
            _ptr(out_v), _ptr(out_i), n_q, n, width, _DTYPE_CODES[q.dtype], _METRIC_CODES[metric],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    count_launch(binned_scan_lanes)
    return out_v, out_i


binned_scan_lanes.launches = 0


def scan_aux(metric, q, stats, valid):
    """Query norms, row norms (None for ip) and the deleted-row penalty."""
    qf = q.float()
    q_sq = (qf * qf).sum(dim=1)
    t_sq = None if metric == MetricKind.IP else stats[:, 0].contiguous()
    penalty = torch.zeros(valid.shape, dtype=torch.float32, device=valid.device)
    penalty.masked_fill_(~valid, MASKED)
    return q_sq, t_sq, penalty


def _exact_acc(q: torch.Tensor) -> torch.dtype:
    """The dtype that sums a row's products exactly: f64 for i8 rows wider
    than f32 keeps integers exact, else f32."""
    return torch.float64 if q.dtype == torch.int8 and q.shape[-1] > I8_F32_EXACT_WIDTH else torch.float32


def _exact_dots(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``[Q, W]`` . ``[Q, R, W]`` -> ``[Q, R]`` at full precision; an
    elementwise product and sum, so no matmul setting (TF32) can round it."""
    acc = _exact_acc(q)
    return (rows.to(acc) * q.to(acc)[:, None, :]).sum(dim=-1).float()


def _check_block_dots(q, table, bins) -> None:
    _check_rows(q, table)
    n, width = table.shape
    if n == 0:
        raise ValueError("the rescore takes bins of a table with rows")
    if q.dtype == torch.int8 and width > _I8_DOTS_WIDTH:
        raise ValueError(f"i8 rows past {_I8_DOTS_WIDTH} bytes could overflow an int32 dot: {width}")
    if bins.dtype != torch.int64 or bins.dim() != 2 or bins.shape[0] != q.shape[0] or bins.shape[1] < 1:
        raise ValueError(f"bins must be i64 [Q, b], b >= 1: {bins.dtype} {tuple(bins.shape)}")
    for x in (q, table, bins):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError("all operands must be contiguous and on one device")


def block_dots_plain(q: torch.Tensor, table: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """What the rescore kernel computes, in plain torch: ``[Q, b * 128]``
    dots of each query with every row of its ``b`` bins,
    ``dots[i, j * 128 + r] = <q[i], table[bins[i, j] * 128 + r]>``. The
    gathered rows are widened (`_exact_acc`: f64 for i8 past
    ``I8_F32_EXACT_WIDTH``, else f32), multiplied in place and summed, in
    query chunks of `_RESCORE_BUDGET`; i8 dots are exact integers."""
    n_q, b = bins.shape
    width = table.shape[1]
    t_blk = table.view(-1, LANES, width)
    acc = _exact_acc(q)
    qa = q.to(acc)
    dots = torch.empty((n_q, b * LANES), dtype=acc, device=q.device)
    chunk = max(8, min(512, _RESCORE_BUDGET // (b * LANES * (width * 4 + 8))))
    for lo in range(0, n_q, chunk):
        bc = bins[lo : lo + chunk]
        m = bc.shape[0]
        rows = t_blk[bc].reshape(m, b * LANES, width).to(acc)  # a gathered copy: multiplied in place
        torch.sum(rows.mul_(qa[lo : lo + m, None, :]), dim=-1, out=dots[lo : lo + m])
    return dots


def block_dots(q: torch.Tensor, table: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """The exact rescore's dots (csrc/rescore.cu `usearch_block_dots`), or
    its plain version for CPU tensors: ``[Q, b * 128]``, int32 for i8 rows
    (exact), f32 for bf16 and f32 rows. ``bins`` ``[Q, b]`` i64 must hold
    bins of the table (a top-k over its bins); the kernel gives 0 dots for
    any other."""
    _check_block_dots(q, table, bins)
    if q.device.type == "cpu":
        return block_dots_plain(q, table, bins)
    from .. import build

    (n_q, b), (n, width) = bins.shape, table.shape
    dots = torch.empty((n_q, b * LANES), dtype=torch.int32 if q.dtype == torch.int8 else torch.float32,
                       device=q.device)
    if n_q == 0:
        return dots
    if q.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("the rescore kernel reads rows in 16-byte chunks: q and table must be 16-byte aligned")
    lib = build.load("rescore")
    with torch.cuda.device(q.device):
        _launch(
            lib.usearch_block_dots, _ptr(q), _ptr(table), _ptr(bins), _ptr(dots), n_q, b, n, width,
            _DTYPE_CODES[q.dtype], ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    count_launch(block_dots)
    return dots


block_dots.launches = 0


def rescore_exact(metric, q, q_sq, table, stats, valid, ids):
    """Exact f32 distances of ``[Q, m]`` candidate rows, sorted ascending."""
    dots = _exact_dots(q, table[ids])
    d = dists_from_dots(metric, dots, q_sq[:, None], stats[:, 0][ids])
    d = torch.where(valid[ids], d, d + MASKED)
    return sort_pairs(d, ids)


def search_binned(metric, q, table, stats, valid, k: int,
                  compact: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k: one candidate per 128-row bin (B1), then the best
    ``k`` bins. ``compact`` rescores ``OVERSAMPLE * k`` bins exactly."""
    q_sq, t_sq, penalty = scan_aux(metric, q, stats, valid)
    vals, rows = binned_scan(metric, q, table, q_sq, t_sq, penalty, compact)
    n_bins = vals.shape[1]
    if compact:
        kk = min(OVERSAMPLE * k, 4 * LANES, n_bins)
        _, sel = topk_min(vals, kk)
        ids = sel * LANES + rows.gather(1, sel).long()
        d, ids = rescore_exact(metric, q, q_sq, table, stats, valid, ids)
        return finish(d[:, :k], ids[:, :k])
    d, sel = topk_min(vals, k)
    return finish(d, rows.gather(1, sel))


def full_bins(vals: torch.Tensor, b: int) -> torch.Tensor:
    """The ``b`` bins of smallest minimum of each row of ``vals`` ``[Q,
    n_bins]``, by (value, bin number): ``lax.top_k``'s answer."""
    return ordered_topk(vals, b)[1]


def staged_bins(vals: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_select_bins_exact`'s staged selection (usearch_tpu/ops/pallas_scan.py
    :664-703) over ``vals`` ``[Q, n_bins]``, ``n_bins`` a multiple of 128:
    `STAGED_SURVIVORS` rounds each take every lane's (bin % 128) smallest
    minimum, the first sub-index among equal ones, and put MASKED in its
    place; the best ``b`` survivors by (value, position in (round, lane)
    order), and the device flag that says the result is exact: every
    query's smallest last-round survivor lies past its ``b``-th survivor,
    over the whole batch."""
    n_q, n_bins = vals.shape
    # lane-major ([Q, lane, sub]), a copy the rounds write into
    d3 = vals.reshape(n_q, n_bins // LANES, LANES).transpose(1, 2).contiguous()
    lane = torch.arange(LANES, device=vals.device)
    values, bins = [], []
    for _ in range(STAGED_SURVIVORS):
        first = torch.argmin(d3, dim=2, keepdim=True)  # the first sub-index among equal minima
        values.append(d3.gather(2, first).squeeze(2))
        bins.append(first.squeeze(2) * LANES + lane)
        d3.scatter_(2, first, MASKED)
    d_sel, pos = ordered_topk(torch.stack(values, dim=1).reshape(n_q, -1), b)
    exact_ok = torch.all(values[-1].amin(dim=1) > d_sel[:, -1])
    return torch.stack(bins, dim=1).reshape(n_q, -1).gather(1, pos), exact_ok


def select_bins_exact(vals: torch.Tensor, b: int) -> torch.Tensor:
    """The exact search's ``b`` bins of each query in `_select_bins_exact`'s
    order: `staged_bins` where the surface takes it (a multiple of 128
    bins, at least ``2 * STAGED_SURVIVORS`` a lane, ``b`` at most
    ``STAGED_SURVIVORS * 128``) and its flag holds, else `full_bins`. Both
    are computed and the flag chooses on the device, as ``lax.cond`` does:
    no host read, so the search stays capturable."""
    n_bins = vals.shape[1]
    full = full_bins(vals, b)
    if n_bins % LANES or n_bins // LANES < 2 * STAGED_SURVIVORS or b > STAGED_SURVIVORS * LANES:
        return full
    staged, exact_ok = staged_bins(vals, b)
    return torch.where(exact_ok, staged, full)


def exact_steps(metric, q, table, stats, valid, k: int):
    """`search_exact` one launch group at a time: a generator that yields
    after B2 and its bin selection, and after the rescore's dots are
    launched, and returns the ``[Q, k]`` distances and rows. Searches of
    several shards taken a step each in turn launch every device's first
    work before any device's last. The bins are `select_bins_exact`'s, in
    its order, and the rows the ``k`` best by (distance, position) over the
    gathered bins in that order (`topk.ordered_topk`), as `pallas_search_exact`
    takes them with ``lax.top_k``: among equal distances both pick the same
    ids. The dots are `block_dots`': the rescore kernel for CUDA tensors,
    its plain version (widened, a query chunk at a time) for CPU tensors;
    the epilogue, the mask and the selections are torch ops on either
    device."""
    q_sq, t_sq, penalty = scan_aux(metric, q, stats, valid)
    vals = binned_minima(metric, q, table, q_sq, t_sq, penalty)
    n_q, n_bins = vals.shape
    bins = select_bins_exact(vals, min(k + EXACT_BIN_SLACK, n_bins))
    yield
    dots = block_dots(q, table, bins)
    yield
    t_sq_rows = stats[:, 0].reshape(n_bins, LANES)[bins].reshape(n_q, -1)
    dist = dists_from_dots(metric, dots.float(), q_sq[:, None], t_sq_rows)
    dist = torch.where(valid.view(n_bins, LANES)[bins].reshape(n_q, -1), dist, MASKED)
    d, sel = ordered_topk(dist, k)
    return finish(d, bins.gather(1, sel // LANES) * LANES + sel % LANES)


def run_steps(steps):
    """A step generator (`exact_steps`) run to its end: its result."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def search_exact(metric, q, table, stats, valid, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: bin minima (B2), the best ``k + 4`` bins, and every row
    of them rescored (`block_dots`)."""
    return run_steps(exact_steps(metric, q, table, stats, valid, k))


def search_fused(metric, q, table, stats, valid, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k, one candidate per 128-row bin, selected inside the
    scan (B8); `pallas_search`'s results."""
    q_sq, t_sq, penalty = scan_aux(metric, q, stats, valid)
    return finish(*fused_topk(metric, q, table, q_sq, t_sq, penalty, k))


def search_fused_stream(metric, q, table, stats, valid, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`search_fused`'s results through the streamed kernel (B9);
    `pallas_search_dma`'s."""
    q_sq, t_sq, penalty = scan_aux(metric, q, stats, valid)
    return finish(*fused_topk_stream(metric, q, table, q_sq, t_sq, penalty, k))


def search_binned_lanes(metric, q, table, stats, valid, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k over B10's ``[N/128, Q]`` surface: the best ``k``
    bins, one row each; `pallas_search_binned(transposed=False)`'s."""
    q_sq, t_sq, penalty = scan_aux(metric, q, stats, valid)
    vals, rows = binned_scan_lanes(metric, q, table, q_sq, t_sq, penalty)
    d, sel = topk_min(vals.T, k)
    return finish(d, rows.T.gather(1, sel))
