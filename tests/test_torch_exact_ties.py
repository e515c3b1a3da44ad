"""The exact route's choice among equal distances (`ops/scan.exact_steps`)
against the JAX package's `pallas_search_exact(interpret=True)` on tied i8
tables, on the CPU.

The JAX route selects the ``k + 4`` bins with the smallest minima by
`_select_bins_exact` (usearch_tpu/ops/pallas_scan.py:664): on surfaces of at
least 1,024 bins (a multiple of 128, ``b <= 512``) four survivors a lane
(bin % 128) by repeated first-argmin, the best ``b`` of them by (value,
position in (round, lane) order) and, where a lane's fourth survivor does
not lie past the ``b``-th for every query of the batch, the full top-b by
(value, bin); below that always the full top-b. It then takes the ``k``
rows by (distance, position) over the gathered bins in that order
(``lax.top_k``). The port must give every query the same (distance, id)
pairs:

- tables of 64 distinct rows, 5% of the rows deleted, W = 128, at 4,096 rows
  (256 bins: the full top-b) and at 131,072 rows (1,024 bins: the staged
  extraction, whose exactness check fails on such ties, so the full top-b
  is chosen on the device flag);
- a planted table of 131,072 rows on which each query's copies lie in more
  bins than ``b``, one a lane, at sub-indices out of lane order: the staged
  order is not the bins' order, and the check holds;
- an `Index` of i8 rows with removals against the JAX `Index` on its kernel
  backend (`set_kernel_backend("pallas")`).

Distances and ids are held strictly equal, each query's pairs sorted by
(distance, id).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import usearch_tpu  # noqa: E402
from usearch_tpu import exact as jexact  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.ops import pallas_scan as jscan  # noqa: E402
from usearch_tpu.ops.distances import row_stats as j_row_stats  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch.enums import MetricKind  # noqa: E402
from usearch_torch.ops import scan  # noqa: E402

W, NQ = 128, 8


def tied(rng, n, distinct=64, dead=0.05):
    """Rows drawn from ``distinct`` random i8 rows, ``dead`` of them
    deleted, and queries drawn from the same rows."""
    base = rng.integers(-127, 128, (distinct, W)).astype(np.int8)
    return base[rng.integers(0, distinct, n)], base[rng.integers(0, distinct, NQ)], rng.random(n) >= dead


def planted(rng, n, per_query=48):
    """Random rows; each query copied into ``per_query`` bins, one a lane,
    the lane's sub-index (bin // 128) drawn at random, at a row of the bin
    drawn at random: more tied bins than any ``k + 4`` here, in an order
    that is not the lanes', and never four in a lane."""
    t = rng.integers(-127, 128, (n, W)).astype(np.int8)
    q = rng.integers(-127, 128, (NQ, W)).astype(np.int8)
    subs = n // 128 // 128
    used = set()
    for j in range(NQ):
        for lane in rng.choice(128, per_query, replace=False):
            while True:
                b = int(rng.integers(0, subs)) * 128 + int(lane)
                r = b * 128 + int(rng.integers(0, 128))
                if r not in used:
                    break
            used.add(r)
            t[r] = q[j]
    return t, q, np.ones(n, bool)


TABLES = {"full": (tied, 4096, 2048), "staged": (tied, 1 << 17, 8192), "planted": (planted, 1 << 17, 8192)}


@functools.lru_cache(maxsize=None)
def table(name):
    make, n, t_tile = TABLES[name]
    t, q, valid = make(np.random.default_rng(n + len(name)), n)
    return t, q, valid, t_tile, np.array(j_row_stats(jnp.asarray(t), usearch_tpu.ScalarKind.I8))


def sorted_pairs(d, i):
    d, i = np.asarray(d), np.asarray(i).astype(np.int64)
    order = np.lexsort((i, d), axis=1)
    return np.take_along_axis(d, order, 1), np.take_along_axis(i, order, 1)


@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("metric", ["ip", "l2sq"])
@pytest.mark.parametrize("name", list(TABLES))
def test_exact_ties_match_pallas(name, metric, k):
    t, q, valid, t_tile, stats = table(name)
    want = jscan.pallas_search_exact(JMetric(metric), jnp.asarray(q), jnp.asarray(t), jnp.asarray(stats),
                                     jnp.asarray(valid), k, q_tile=NQ, t_tile=t_tile, interpret=True)
    got = scan.search_exact(MetricKind(metric), torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(stats),
                            torch.from_numpy(valid), k)
    (gd, gi), (wd, wi) = sorted_pairs(*got), sorted_pairs(*want)
    np.testing.assert_array_equal(gd.view(np.uint32), wd.view(np.uint32))
    np.testing.assert_array_equal(gi, wi)
    assert np.all(gi >= 0) and valid[gi].all()


def test_planted_order_is_staged_and_exact():
    """On the planted table the staged selection's check holds and its
    order differs from the bins' order: the case tests the staged path."""
    t, q, valid, _, stats = table("planted")
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    aux = scan.scan_aux(MetricKind.L2sq, tq, torch.from_numpy(stats), torch.from_numpy(valid))
    vals = scan.binned_minima(MetricKind.L2sq, tq, tt, *aux)
    staged, ok = scan.staged_bins(vals, 14)
    full = scan.full_bins(vals, 14)
    assert bool(ok) and not torch.equal(staged, full)
    assert torch.equal(scan.select_bins_exact(vals, 14), staged)


@pytest.fixture
def pallas_backend():
    jexact.set_kernel_backend("pallas")
    try:
        yield
    finally:
        jexact.set_kernel_backend("auto")


@pytest.mark.parametrize("k", [1, 10])
def test_index_exact_ties_match_jax(pallas_backend, k):
    """An i8/ip `Index` of 3,000 tied rows with 150 keys removed: the exact
    search's keys and distances equal to the JAX `Index`'s on its Pallas
    route (interpret mode on the CPU)."""
    rng = np.random.default_rng(11)
    base = rng.standard_normal((48, 64)).astype(np.float32)
    x = base[rng.integers(0, 48, 3000)]
    keys = np.arange(3000, dtype=np.uint64) + 7
    ref = usearch_tpu.Index(ndim=64, metric="ip", dtype="i8")
    port = usearch_torch.Index(ndim=64, metric="ip", dtype="i8", device="cpu")
    ref.add(keys, x)
    port.add(keys, x)
    gone = keys[rng.choice(3000, 150, replace=False)]
    ref.remove(gone)
    port.remove(gone)
    queries = base[rng.integers(0, 48, 16)]
    got, want = port.search(queries, k, exact=True), ref.search(queries, k, exact=True)
    (gd, gi), (wd, wi) = sorted_pairs(got.distances, got.keys), sorted_pairs(want.distances, want.keys)
    np.testing.assert_array_equal(gd.view(np.uint32), wd.view(np.uint32))
    np.testing.assert_array_equal(gi, wi)
    assert not np.isin(gone, gi).any()
