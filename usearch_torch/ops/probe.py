"""The grouped IVF probe: kernel B3 and its plain version.

Counterpart of `_make_grouped_kernel` / `pallas_ivf_probe_grouped` in
`usearch_tpu/ops/pallas_probe.py`. The input is a list of (query,
partition) pairs, sorted by partition and cut into cells of 128 pairs; each
pair owns one window of the dense cluster-major table, rows
``[win_start, win_start + win_len)``. For each pair:

1. every row of its window is scored in rank form (`window_dists`): ip
   ``1 - dot``, cos ``-dot / |t|``, l2sq ``|t|^2 - 2 dot``, plus the
   deleted-row penalty when one is given;
2. each 128-row bin of the table (bins aligned to multiples of 128 rows)
   keeps its ``bin_m`` smallest rows, the lower row first on ties;
3. the ``max(k, 8)`` smallest of those candidates are kept, taken in
   (extraction round, bin) order, the earlier candidate first on ties;
4. `rank_epilogue` restores the metric's distances, and the first ``k``
   are returned with the global row ids, ``-1`` where the distance is at
   least ``MASKED / 2``.

A pair's result depends on its own window only, so cells only decide which
pairs share the reads of a window. The TPU kernel carried the pair-to-window
slot as f32 in its query aux and packed window lists per cell in SMEM; the
port passes each pair's window start and length as plain int32 tensors.

`grouped_probe` runs the plain version for CPU tensors and the CUDA kernel
(csrc/probe.cu) for CUDA tensors; there is no fallback between them.
``grouped_probe.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..enums import MetricKind
from .distances import MASKED, _sqrt, dot
from .scan import _DTYPE_CODES, _METRIC_CODES, _launch, _ptr
from .topk import position_order, stable_topk

#: pairs per cell, and rows per bin
LANES = 128
#: candidates per bin are at most this many (the JAX caller's clamp)
MAX_BIN_M = 16


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
    elif metric == MetricKind.L2sq:
        d = t_sq[None, :] - 2.0 * dots
    else:
        raise ValueError(f"the probe kernel takes ip/cos/l2sq, got {metric}")
    return d if penalty is None else d + penalty[None, :]


def rank_epilogue(metric, acc: torch.Tensor, q_sq: torch.Tensor) -> torch.Tensor:
    """Rank-form ``[m, k]`` back to the metric's distances with the
    per-query terms `window_dists` dropped; entries at or above
    ``MASKED / 2`` pass through: the JAX `_rank_epilogue`."""
    if metric == MetricKind.IP:
        return acc
    qs = q_sq[:, None]
    keep = acc >= MASKED / 2
    if metric == MetricKind.L2sq:
        return torch.where(keep, acc, torch.clamp_min(acc + qs, 0.0))
    scale = torch.where(qs == 0.0, 1.0, 1.0 / _sqrt(torch.where(qs == 0.0, 1.0, qs)))
    return torch.where(keep, acc, 1.0 + acc * scale)


def _check(metric, q_g, q_sq, table, t_sq, penalty, win_start, win_len, k, bin_m) -> None:
    if metric not in _METRIC_CODES:
        raise ValueError(f"the probe kernel takes ip/cos/l2sq, got {metric}")
    if q_g.dtype not in _DTYPE_CODES or table.dtype != q_g.dtype:
        raise TypeError(f"q_g and table must share a dtype of {list(_DTYPE_CODES)}: {q_g.dtype}, {table.dtype}")
    if q_g.dim() != 2 or table.dim() != 2 or q_g.shape[1] != table.shape[1]:
        raise ValueError(f"q_g [P, W] and table [N, W] expected: {tuple(q_g.shape)}, {tuple(table.shape)}")
    p, (n, width) = q_g.shape[0], table.shape
    if p % LANES or n % LANES or width % LANES:
        raise ValueError(f"pairs, table rows and width must be multiples of {LANES}: {p}, {tuple(table.shape)}")
    if not 1 <= k <= 128 or not 1 <= bin_m <= MAX_BIN_M:
        raise ValueError(f"1 <= k <= 128 and 1 <= bin_m <= {MAX_BIN_M} expected, got k={k}, bin_m={bin_m}")
    if metric != MetricKind.IP and (t_sq is None or penalty is None):
        raise ValueError("cos and l2sq need t_sq and the penalty")
    aux = [(q_sq, p, torch.float32), (win_start, p, torch.int32), (win_len, p, torch.int32)]
    aux += [(x, n, torch.float32) for x in (t_sq, penalty) if x is not None]
    for x, length, dtype in aux:
        if x.dtype != dtype or x.shape != (length,):
            raise ValueError(f"expected {dtype} of length {length}, got {x.dtype} {tuple(x.shape)}")
    for x in (q_g, table, q_sq, t_sq, penalty, win_start, win_len):
        if x is not None and (x.device != q_g.device or not x.is_contiguous()):
            raise ValueError("all operands must be contiguous and on one device")


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
    start = win_start.long()
    length = torch.where((start >= 0) & (start + win_len <= n_rows), win_len.long(), 0)
    windows, owner = torch.unique(start * (n_rows + 1) + length, return_inverse=True)
    order = torch.argsort(owner, stable=True)
    bounds = torch.cumsum(torch.bincount(owner, minlength=windows.shape[0]), 0).tolist()
    lo = 0
    for key, hi in zip(windows.tolist(), bounds):
        pairs, lo = order[lo:hi], hi
        st, ln = divmod(key, n_rows + 1)
        if ln == 0:
            continue
        r0, r1 = st // LANES * LANES, (st + ln + LANES - 1) // LANES * LANES
        n_bins = (r1 - r0) // LANES
        qs = q_sq[pairs]
        d = window_dists(metric, dot(q_g[pairs], table[r0:r1]), qs,
                         None if t_sq is None else t_sq[r0:r1], None if penalty is None else penalty[r0:r1])
        rows = torch.arange(r0, r1, device=dev)
        d = torch.where(((rows >= st) & (rows < st + ln))[None, :], d, MASKED)
        # the bin_m smallest of each bin (lower row first on ties, as
        # rounds of min/argmin extract them), laid out round-major
        d3 = d.view(-1, n_bins, LANES)
        bi = position_order(d3)[..., :bin_m]
        cand_v = d3.gather(-1, bi).transpose(1, 2).reshape(len(pairs), -1)
        cand_i = (bi + rows.view(n_bins, LANES)[:, :1]).transpose(1, 2).reshape(len(pairs), -1)
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
            _DTYPE_CODES[q_g.dtype], _METRIC_CODES[metric], k, min(bin_m, max(k, 8)),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    grouped_probe.launches += 1
    return out_d, out_i


grouped_probe.launches = 0
