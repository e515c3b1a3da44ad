"""The exact scan over packed b1 rows (usearch_torch/ops/bitscan.py, kernel
csrc/bitscan.cu) on the CPU, against the JAX package's XLA scan
(`usearch_tpu.exact._search_kernel_xla`, `ops.topk.scan_topk`) on the same
numpy inputs.

- Ties: both scans keep the k smallest (distance, row) pairs, the lower row
  first, at the k-th place too. In exact mode the JAX scan merges with
  ``lax.top_k`` (position order over rows met in ascending order), so ids
  are held strictly equal on tables full of equal distances. In the
  approximate mode that ranks in bf16 the JAX scan takes each tile's top-k
  with ``lax.approx_min_k``, which XLA's CPU backend lowers to an unstable
  sort on values alone, so its order among equal distances inside a tile is
  not the rows'. There the tables plant each query's nearest rows at
  distinct distances inside a tile and equal ones across the tile edge and
  at the k-th place, and ids are held strictly equal again.
- Distances are held bit for bit: both sides take the same f32 operations
  (one correctly rounded division for tanimoto and sorensen).
- A numpy model of the kernel (its splits, 128-row tiles, the four threads
  of a query with their 32 rows each, the division-free prefilter in the
  kernel's f32 arithmetic, the turns of list insertion and the merge of
  the splits' lists) against `bit_scan_plain`; the prefilter never drops a
  pair that enters a list.
- The b1 `Index` (exact and approximate, captured through a stand-in graph
  cache) and `exact_search` against the JAX package, ids strictly equal.
"""

import functools
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_capture import HostReadGuard, StandIn, replays_equal_eager  # noqa: E402

import usearch_tpu  # noqa: E402
from usearch_tpu import exact as jexact  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.enums import ScalarKind as JKind  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import index as index_mod  # noqa: E402
from usearch_torch.enums import MetricKind, ScalarKind  # noqa: E402
from usearch_torch.exact import search_kernel  # noqa: E402
from usearch_torch.graphs import GraphCache  # noqa: E402
from usearch_torch.ops import bitscan, topk  # noqa: E402
from usearch_torch.ops.distances import MASKED, row_stats  # noqa: E402

METRICS = ["hamming", "tanimoto", "sorensen"]
NQ = 40


def few_bytes(rng, n, w, live=2):
    """Packed rows whose first ``live`` bytes alone are set: distances take
    few values, so equal distances are everywhere, at the k-th place too."""
    rows = np.zeros((n, w), np.uint8)
    rows[:, :live] = rng.integers(0, 256, (n, live))
    return rows


def tied_table(rng, n, w, tile, dead=0.1):
    """`few_bytes` rows with equal rows planted at both sides of every tile
    edge, ``dead`` of the rows deleted, and `few_bytes` queries."""
    t = few_bytes(rng, n, w)
    for edge in range(tile, n, tile):
        t[edge - 2 : edge + 2] = t[edge - 2]
    return few_bytes(rng, NQ, w), t, rng.random(n) >= dead


def planted_table(rng, n, w, tile, k):
    """Dense random rows and queries, and for each query rows at small
    distinct distances inside each tile (its bits cleared one by one), equal
    across tiles: every tile's k + 1 nearest rows of a query are its own
    planted rows at distinct distances, and the global k-th place is a tie
    between two tiles (query 0's across the first tile edge)."""
    q = rng.integers(0, 256, (NQ, w)).astype(np.uint8)
    t = rng.integers(0, 256, (n, w)).astype(np.uint8)
    qbits = np.unpackbits(q, axis=1)
    ones = [np.flatnonzero(b) for b in qbits]
    flips = [np.arange(1, 2 * k + 4, 2), np.arange(1, 2 * k + 4, 4)]  # tile 0's distances, the next tiles'
    free = [list(range(1, tile - 1)) for _ in range(n // tile)]
    for i in range(NQ):
        for j in range(n // tile):
            for m in flips[min(j, 1)]:
                bits = qbits[i].copy()
                bits[ones[i][:m]] = 0
                if i == 0 and m == flips[1][(k - 1) // 3 if k > 1 else 0] and j < 2:
                    r = tile - 1 if j == 0 else tile  # the tie across the first tile edge
                else:
                    r = j * tile + free[j].pop(int(rng.integers(0, len(free[j]))))
                t[r] = np.packbits(bits)
    return q, t, np.ones(n, bool)


def jax_scan(metric, q, t, valid, k, tile, approx):
    js = jexact.row_stats(jnp.asarray(t), JKind.B1)
    d, i = jexact._search_kernel_xla(JMetric(metric), JKind.B1, jnp.asarray(q), jnp.asarray(t), js,
                                     jnp.asarray(valid), 8 * t.shape[1], k, tile, None, approx)
    return np.asarray(d), np.asarray(i)


def port_route(metric, q, t, valid, k, tile, approx):
    tt = torch.from_numpy(t)
    d, i = search_kernel(MetricKind(metric), ScalarKind.B1, torch.from_numpy(q), tt, row_stats(tt, ScalarKind.B1),
                         torch.from_numpy(valid), 8 * t.shape[1], k, tile, approx)
    return d.numpy(), i.numpy()


def assert_bits(got, want):
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd.view(np.uint32), wd.view(np.uint32))


@functools.lru_cache(maxsize=None)
def tied_case(metric, k, w, kind=""):
    """`tied_table`'s rows in three tiles of 512 (``kind``: "few_live", five
    live rows; "one_tile", the whole table one tile, the JAX package's
    `masked_topk`) and the JAX scan's answer in exact mode; kept for the
    tests that share it (one compile of the JAX scan a shape)."""
    rng = np.random.default_rng(k + w)
    tile = 512
    q, t, valid = tied_table(rng, 3 * tile, w, tile)
    if kind == "few_live":
        valid[:] = False
        valid[rng.choice(len(valid), 5, replace=False)] = True
    if kind == "one_tile":
        tile = len(valid)
    return q, t, valid, tile, jax_scan(metric, q, t, valid, k, tile, approx=False)


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_scan_ties_match_jax(metric, k):
    """The plain tiled scan (`ops/topk.scan_topk`, still the route of what
    the bit scan's gate leaves out) on b1 rows full of ties, with equal rows
    across tile edges: ids strictly equal to the JAX scan's. Before it chose
    on (distance, row) its tile top-k was ``torch.topk``'s, which keeps an
    unspecified one of equal values at the k-th place."""
    q, t, valid, tile, want = tied_case(metric, k, 128)
    tt, tq = torch.from_numpy(t), torch.from_numpy(q)
    got = topk.scan_topk(MetricKind(metric), ScalarKind.B1, tq, row_stats(tq, ScalarKind.B1), tt,
                         row_stats(tt, ScalarKind.B1), torch.from_numpy(valid), k, tile, 8 * t.shape[1])
    assert_bits(tuple(x.numpy() for x in got), want)


@pytest.mark.parametrize("case", [(1, 128), (10, 128), (128, 128), (10, 256), (10, 128, "few_live"),
                                  (10, 128, "one_tile")])
@pytest.mark.parametrize("metric", METRICS)
def test_bit_scan_route_matches_jax_exact(metric, case):
    """`search_kernel`'s b1 route (`bit_scan`, its plain version here)
    against `_search_kernel_xla` in exact mode: planted ties, 10% of the
    rows deleted, fewer live rows than k, a table of one tile (the JAX
    package's `masked_topk`), widths of 128 and 256 bytes."""
    k, w, *kind = case
    q, t, valid, tile, want = tied_case(metric, k, w, *kind)
    got = port_route(metric, q, t, valid, k, tile, approx=False)
    assert_bits(got, want)
    if kind == ["few_live"]:
        assert (got[1] >= 0).sum(axis=1).max() == 5 and got[0][0, -1] == np.float32(MASKED)


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("metric", METRICS)
def test_bit_scan_route_matches_jax_rounded(metric, k):
    """The approximate mode, ranked in bf16 on both sides (tiles of at least
    4 k 128 rows, more rows than a tile): `planted_table`'s equal distances
    across the tile edge and at the k-th place, ids strictly equal and
    distances bit for bit (bf16 values)."""
    tile = max(512, 1 << (4 * k * 128 - 1).bit_length())
    assert bitscan.rounds(True, 2 * tile, k, tile)
    q, t, valid = planted_table(np.random.default_rng(k), 2 * tile, 128, tile, k)
    got = port_route(metric, q, t, valid, k, tile, approx=True)
    want = jax_scan(metric, q, t, valid, k, tile, approx=True)
    assert_bits(got, want)
    assert got[1][0, k - 1] == tile - 1 and np.all(got[0] == got[0].astype(jnp.bfloat16).astype(np.float32))


# ----------------------------------------------------------------------
# A numpy model of the kernel
# ----------------------------------------------------------------------


def f32(x):
    return np.float32(x)


def bf16_round(d: np.ndarray) -> np.ndarray:
    """f32 to bf16, to nearest even, as f32."""
    b = np.asarray(d, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def model_distance(metric, a, pq, pt, rnd):
    """`bit_distance` of csrc/bitscan.cu in numpy f32 operations."""
    af = a.astype(np.float32)
    s = f32(pq) + pt.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        if metric == "hamming":
            d = s - f32(2) * af
        elif metric == "tanimoto":
            u = s - af
            d = np.where(u == 0, f32(0), f32(1) - af / np.where(u == 0, f32(1), u))
        else:
            d = np.where(s == 0, f32(0), f32(1) - (f32(2) * af) / np.where(s == 0, f32(1), s))
    d = d.astype(np.float32)
    return bf16_round(d) if rnd else d


def pass_bound(thr, rnd):
    if not rnd:
        return f32(thr)
    up = (int(np.float32(thr).view(np.uint32)) + 0xFFFF) & 0xFFFF0000
    return np.uint32(up + 0x10000).view(np.float32)


#: csrc/bitscan.cu's line constants: the bias (1.5 2^23), the clamps of
#: beta and of hamming's limit, a dead row's popcount, the rows of a tile
LINE_BIAS, LINE_CLAMP, LIMIT_CLAMP, DEAD_POP, TILE = 12582912, 2**21, 2**22, 1572864, 64


def f32_rd(x: Fraction) -> np.float32:
    """The largest f32 at or below ``x`` (a directed rounding)."""
    f = np.float32(float(x))
    while Fraction(float(f)) > x:
        f = np.nextafter(f, np.float32(-np.inf))
    while Fraction(float(np.nextafter(f, np.float32(np.inf)))) <= x:
        f = np.nextafter(f, np.float32(np.inf))
    return f


def f32_ru(x: Fraction) -> np.float32:
    return -f32_rd(-x)


def rd32(x):
    """The largest f32 at or below each f64 of ``x`` (exact f64 values)."""
    f = np.asarray(x, np.float64).astype(np.float32)
    return np.where(f.astype(np.float64) > x, np.nextafter(f, np.float32(-np.inf)), f)


def pass_line(metric, thr, pq, rnd):
    """`pass_line` of csrc/bitscan.cu for a list's last entry ``thr`` and
    the queries' popcounts ``pq`` (an array): alpha (one f32; none for
    hamming, whose line is 2a >= pt + base) and each query's unbiased base,
    an integer (the f32s between 2^23 and 2^24 are the integers, so the
    biased sum rounded down is a floor), the kernel's directed roundings
    taken exactly (Fractions; alpha pq is exact in f64)."""
    b = float(pass_bound(thr, rnd))
    pq = np.asarray(pq, np.int64)
    if metric == "hamming":
        return None, np.minimum(pq - int(np.floor(min(b, LIMIT_CLAMP))), LIMIT_CLAMP // 2 + 1)
    c = f32_rd(1 - Fraction(float(f32_ru(Fraction(b) + Fraction(1, 2**20)))))
    if not c > 0:
        return f32(0), np.full(pq.shape, -LINE_CLAMP, np.int64)
    cf = Fraction(float(c))
    if metric == "tanimoto":
        alpha = f32_rd(cf * Fraction(float(f32_rd(1 / Fraction(float(f32_ru(1 + cf)))))))
    else:
        alpha = f32_rd(cf / 2)
    beta = rd32(np.float64(alpha) * pq).astype(np.float64)
    return alpha, np.floor(np.minimum(beta, LINE_CLAMP)).astype(np.int64)


def line_gap(a, pt, alpha, base):
    """`line_gap` plus kLineBits, >= 0 on the line's good side: hamming
    (alpha None) 2a - pt - base, exact; otherwise a minus fma(alpha, pt,
    base + bias) rounded to nearest (ties to even) less the bias, in exact
    integer arithmetic: alpha = m 2^-s with m below 2^24, so alpha pt =
    m pt 2^-s."""
    a, pt = np.asarray(a, np.int64), np.asarray(pt, np.int64)
    if alpha is None:
        return 2 * a - pt - base
    if alpha == 0:
        return a - base
    mant, exp = np.frexp(np.float64(alpha))
    m, s = int(mant * 2**24), 24 - int(exp)
    prod = m * pt
    q, rem = prod >> s, prod & ((1 << s) - 1)
    x = base + LINE_BIAS + q
    half = 1 << (s - 1)
    x = x + ((rem > half) | ((rem == half) & (x % 2 == 1)))
    return a - (x - LINE_BIAS)


def may_pass(metric, a, pt, pq, thr, rnd):
    """The kernel's prefilter of pairs against their queries' lists' last
    distance ``thr``: each pair lies on its line's good side."""
    return line_gap(a, pt, *pass_line(metric, thr, pq, rnd)) >= 0


def before(v, r, d, s):
    return v < d or (v == d and r < s)


def model_insert(ld, li, v, r):
    j = len(ld) - 1
    while j > 0 and not before(ld[j - 1], li[j - 1], v, r):
        ld[j], li[j] = ld[j - 1], li[j - 1]
        j -= 1
    ld[j], li[j] = v, r


def strictly_below(thr, rnd):
    """`strictly_below`: the largest list value under ``thr`` (f32, or bf16
    when ranking rounded), -1 under 0; ``thr`` itself while the list is not
    full."""
    if thr >= MASKED:
        return f32(thr)
    if thr <= 0:
        return f32(-1)
    step = 0x10000 if rnd else 1
    return np.uint32(int(np.float32(thr).view(np.uint32)) - step).view(np.float32)


def model_tile(metric, a, pq, pop, k, rnd, row0, r1, lst, shared):
    """One 64-row tile of a split's list ``lst`` ([values, rows]): the four
    threads test their 16 rows (8 j + 2 c + e) against the line of the
    lower of the value just under the list's last entry (every later row
    lies past the entry's row) and the splits' shared bound, a dead row's
    popcount DEAD_POP and dead rows never candidates; then they take their
    candidates in turn, thread 0 first, each in row order."""
    ld, li = lst
    rows = row0 + np.arange(TILE)
    inside = rows < r1
    pt = np.where(inside, pop[np.minimum(rows, len(pop) - 1)], -1)
    acc = np.where(inside, a[np.minimum(rows, len(a) - 1)], 0)
    bound = min(strictly_below(ld[-1], rnd), shared)
    cand = may_pass(metric, acc, np.where(pt >= 0, pt, DEAD_POP), pq, bound, rnd) & (pt >= 0)
    for c in range(4):
        for col in [8 * (r // 2) + 2 * c + r % 2 for r in range(16)]:
            if cand[col]:
                v = model_distance(metric, acc[col : col + 1], pq, pt[col : col + 1], rnd)[0]
                if before(v, row0 + col, ld[-1], li[-1]):
                    model_insert(ld, li, v, row0 + col)


def model_scan(metric, q, t, valid, k, rnd, split_rows):
    """The kernel's answer: the splits' lists, scanned a tile each in turn,
    each full list's last value lowering the splits' shared bound at once
    (the kernel reads it later, which only passes more); then the merge (the
    first split's list, the others' entries inserted until one does not
    come before the last entry), ids -1 at or above MASKED / 2."""
    qbits, tbits = np.unpackbits(q, axis=1).astype(np.int64), np.unpackbits(t, axis=1).astype(np.int64)
    dots = qbits @ tbits.T
    pq_all, pop = qbits.sum(1), np.where(valid, tbits.sum(1), -1)
    out_d = np.zeros((q.shape[0], k), np.float32)
    out_i = np.zeros((q.shape[0], k), np.int32)
    n = t.shape[0]
    starts = list(range(0, n, split_rows))
    for i in range(q.shape[0]):
        lists = [([f32(MASKED)] * k, [2**31 - 1] * k) for _ in starts]
        shared = f32(np.inf)
        for off in range(0, split_rows, TILE):
            for r0, lst in zip(starts, lists):
                if r0 + off < min(n, r0 + split_rows):
                    model_tile(metric, dots[i], int(pq_all[i]), pop, k, rnd, r0 + off, min(n, r0 + split_rows), lst,
                               shared)
                    if lst[0][-1] < MASKED:
                        shared = min(shared, lst[0][-1])
        ld, li = list(lists[0][0]), list(lists[0][1])
        for sd, si in lists[1:]:
            for v, r in zip(sd, si):
                if not before(v, r, ld[-1], li[-1]):
                    break
                model_insert(ld, li, v, r)
        out_d[i] = ld
        out_i[i] = [-1 if d >= MASKED / 2 else r for d, r in zip(ld, li)]
    return out_d, out_i


def plain(metric, q, t, valid, k, rnd):
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    d, i = bitscan.bit_scan_plain(MetricKind(metric), tq, tt, row_stats(tq, ScalarKind.B1)[:, 0],
                                  row_stats(tt, ScalarKind.B1)[:, 0], torch.from_numpy(valid), k, rnd)
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("case", [(1, False, 1024), (10, True, 512), (20, False, 384), (128, True, 2048),
                                  (10, False, 512, "few_live")])
@pytest.mark.parametrize("metric", METRICS)
def test_kernel_model_matches_plain(metric, case):
    """The model of the kernel's splits and their shared bound, 64-row
    tiles, threads, line prefilter (strict on the list's own last entry),
    turns and merge gives `bit_scan_plain`'s answer bit for bit: ties across
    tile, thread and split edges, dead rows, a ragged last tile, lists
    shorter (k <= 16) and longer than the kernel's shared-memory ones."""
    k, rnd, split_rows, *kind = case
    rng = np.random.default_rng(k + split_rows)
    n = 1000
    q, t, valid = tied_table(rng, n, 128, 128)
    q = q[:8]
    if kind:
        valid[:] = False
        valid[[3, 500, 999]] = True
    assert_bits(model_scan(metric, q, t, valid, k, rnd, split_rows), plain(metric, q, t, valid, k, rnd))


def triples(bits, rng=None, n=0):
    """(pq, pt, a) of rows of ``bits`` bits: every one, or ``n`` drawn at
    random (the and-count between its bounds)."""
    if rng is None:
        pq, pt = (x.ravel() for x in np.meshgrid(np.arange(bits + 1), np.arange(bits + 1), indexing="ij"))
    else:
        pq, pt = rng.integers(0, bits + 1, n), rng.integers(0, bits + 1, n)
    lo, hi = np.maximum(0, pq + pt - bits), np.minimum(pq, pt)
    if rng is not None:
        return pq, pt, lo + (rng.random(n) * (hi - lo + 1)).astype(np.int64)
    count = hi - lo + 1
    pick = np.repeat(np.arange(pq.size), count)
    a = lo[pick] + np.arange(pick.size) - np.repeat(np.cumsum(count) - count, count)
    return pq[pick], pt[pick], a


def next_up(thr):
    """The f32 just above ``thr`` (>= 0) and the bf16 value above it."""
    bits = int(np.float32(thr).view(np.uint32))
    up = (bits + 0xFFFF) & 0xFFFF0000
    return np.nextafter(f32(thr), f32(np.inf)), np.uint32(up + 0x10000 if up == bits else up).view(np.float32)


@pytest.mark.parametrize("rows", ["every triple to 64 bits", "1,024 bits", "2^20 bits"])
@pytest.mark.parametrize("rnd", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_prefilter_never_drops_an_entry(metric, rnd, rows):
    """Every pair whose (rounded) distance reaches the list's last entry
    lies on the good side of the kernel's line (`pass_line`, `line_gap`,
    taken exactly): each (pq, pt, a) against the entry equal to its own
    distance (a lower row would enter), the f32 just above it and the next
    bf16 value; and against entries drawn from the distances, every pair
    at or below one. Every triple of rows up to 64 bits wide, and random
    ones of 1,024-bit and 2^20-bit rows (popcounts to 2^20, the kernel's
    widest row); hamming's line is exact, passing no pair past the bound."""
    rng = np.random.default_rng(7)
    if rows.startswith("every"):
        pq, pt, a = triples(64)
    else:
        pq, pt, a = triples(1024 if rows.startswith("1,024") else 1 << 20, rng, 1500)
    d = model_distance(metric, a, pq, pt, rnd)
    for thr in np.unique(d):
        on = d == thr
        for t in (thr, *next_up(thr)):
            assert np.all(may_pass(metric, a[on], pt[on], pq[on], t, rnd)), (thr, t)
    for thr in [f32(MASKED), *rng.choice(d, 12)]:
        assert np.all(may_pass(metric, a[d <= thr], pt[d <= thr], pq[d <= thr], thr, rnd)), thr
    if metric == "hamming":  # an exact line: nothing past the bound passes
        thr = np.sort(d)[d.size // 20]
        far = d > pass_bound(thr, rnd)
        assert not np.any(may_pass(metric, a[far], pt[far], pq[far], thr, rnd))


def test_dead_rows_and_queries_never_pass():
    """A dead row's popcount (DEAD_POP) keeps it off every tight line, and
    a query past the batch (alpha 0, base past the clamp: `closed_line`)
    passes nothing."""
    pq, pt, a = triples(64)
    for metric in METRICS:
        assert not np.any(may_pass(metric, a, np.full_like(pt, DEAD_POP), pq, f32(0.1), False))
    assert not np.any(line_gap(np.arange(2**20 + 1), 0, f32(0), LINE_CLAMP + 2) >= 0)


@pytest.mark.parametrize("bad", ["dtype", "width", "wide", "k0", "k129", "pop", "valid"])
def test_wrapper_refuses(bad):
    q = torch.zeros((4, 128), dtype=torch.uint8)
    t = torch.zeros((256, 128), dtype=torch.uint8)
    qp, tp, valid, k = torch.zeros(4), torch.zeros(256), torch.ones(256, dtype=torch.bool), 10
    if bad == "dtype":
        q, t = q.to(torch.int8), t.to(torch.int8)
    elif bad == "width":
        q, t = q[:, :64].contiguous(), t[:, :64].contiguous()
    elif bad == "wide":
        q, t = torch.zeros((4, 2 * bitscan.MAX_WIDTH), dtype=torch.uint8), torch.zeros((8, 2 * bitscan.MAX_WIDTH),
                                                                                         dtype=torch.uint8)
        tp, valid = torch.zeros(8), torch.ones(8, dtype=torch.bool)
    elif bad in ("k0", "k129"):
        k = 0 if bad == "k0" else 129
    elif bad == "pop":
        tp = tp.to(torch.int32)
    else:
        valid = valid.to(torch.uint8)
    with pytest.raises((TypeError, ValueError)):
        bitscan.bit_scan(MetricKind.Hamming, q, t, qp, tp, valid, k)


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------


def corpus(rng, n, nbits=1024, templates=8, flip=0.02):
    base = rng.integers(0, 2, (templates, nbits), dtype=np.uint8)
    bits = base[rng.integers(0, templates, n)] ^ (rng.random((n, nbits)) < flip)
    return np.packbits(bits, axis=1)


@pytest.mark.parametrize("metric", METRICS)
def test_index_and_exact_search_match_jax(metric):
    """A b1 `Index` (exact and approximate searches, keys removed) and
    `exact_search` over uint8 rows: keys and distances equal to the JAX
    package's, ids strictly (both rank on (distance, row))."""
    rng = np.random.default_rng(3)
    x = corpus(rng, 1500)
    keys = np.arange(1500, dtype=np.uint64) + 5
    ref = usearch_tpu.Index(ndim=1024, metric=metric, dtype="b1")
    port = usearch_torch.Index(ndim=1024, metric=metric, dtype="b1", device="cpu")
    ref.add(keys, x)
    port.add(keys, x)
    gone = keys[rng.choice(1500, 100, replace=False)]
    ref.remove(gone)
    port.remove(gone)
    q = x[::37]
    for exact in (True, False):
        got, want = port.search(q, 10, exact=exact), ref.search(q, 10, exact=exact)
        np.testing.assert_array_equal(got.keys, want.keys)
        np.testing.assert_array_equal(got.distances.view(np.uint32), np.asarray(want.distances).view(np.uint32))
    got = usearch_torch.exact_search(x, q, 16, metric=metric, device="cpu")
    want = usearch_tpu.exact_search(x, q, 16, metric=metric)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.distances.view(np.uint32), np.asarray(want.distances).view(np.uint32))


@pytest.mark.parametrize("exact", [True, False])
def test_b1_flat_search_captured(monkeypatch, exact):
    """The b1 flat search takes a key ("bitscan", approx, tile_rows): its
    replays through a stand-in graph cache, with every host read refused
    inside the body (`HostReadGuard`; the wrapper's plain version stands in
    for one launch), equal the eager search bit for bit, and the JAX
    package's search id for id."""
    guard = HostReadGuard(monkeypatch)
    monkeypatch.setattr(bitscan, "bit_scan", guard._unguarded(bitscan.bit_scan))
    monkeypatch.setattr(index_mod, "APPROX_MIN_ROWS", 1000)
    rng = np.random.default_rng(5)
    x = corpus(rng, 2000)
    keys = np.arange(2000, dtype=np.uint64)
    ref = usearch_tpu.Index(ndim=1024, metric="tanimoto", dtype="b1")
    port = usearch_torch.Index(ndim=1024, metric="tanimoto", dtype="b1", device="cpu")
    ref.add(keys, x)
    port.add(keys, x)
    cache = port._graphs = GraphCache("cpu", backend=StandIn(guard))
    batches = [x[rng.choice(2000, 6, replace=False)] for _ in range(3)]
    got = replays_equal_eager(port, batches, 10, exact=exact)
    assert cache.captures == 1 and cache.replays == 2 and cache.keys()[0][:2] == ("bitscan", not exact)
    for b, g in zip(batches, got):
        want = ref.search(b, 10, exact=exact)
        np.testing.assert_array_equal(g.keys, want.keys)
        np.testing.assert_array_equal(g.distances.view(np.uint32), np.asarray(want.distances).view(np.uint32))
