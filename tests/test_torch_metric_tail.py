"""The metric tail (ROADMAP A.7b) on the CPU against the JAX package:
haversine, Jensen-Shannon divergence, jaccard over integer sets and
user-defined metrics (a torch callable here, a JAX one there);
tests/test_torch_pairings.py has f64 storage and the other pairings.

Distances are held within FLOAT_RTOL/FLOAT_ATOL (1e-5, 1e-4) and keys
equal apart from ties within them; jaccard and the set sketch bit for
bit. Probed searches carry the JAX build
across (`convert.install_ivf`); the recall bars of tests/test_metric_tail.py
hold on the port's own build, at 2,000 rows (the proportions of partitions
and probes kept)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import usearch_tpu  # noqa: E402
from usearch_tpu import ivf as jivf  # noqa: E402
from usearch_tpu.enums import CompiledMetric as JCompiledMetric  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.enums import ScalarKind as JKind  # noqa: E402
from usearch_tpu.ops import distances as jdist  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import ivf  # noqa: E402
from usearch_torch.convert import index_from_arrays, install_ivf  # noqa: E402
from usearch_torch.enums import CompiledMetric, MetricKind, ScalarKind  # noqa: E402
from usearch_torch.ops import distances  # noqa: E402

FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-4
TAIL = ("haversine", "divergence", "jaccard", "udf")
W = np.linspace(0.5, 2.0, 128).astype(np.float32)


def Index(**kwargs):
    return usearch_torch.Index(device="cpu", **kwargs)


def udf_pair():
    """The same weighted L1 as a torch and as a JAX metric."""
    wt, wj = torch.from_numpy(W), jnp.asarray(W)
    return CompiledMetric(lambda a, b: (wt * (a - b).abs()).sum()), JCompiledMetric(
        lambda a, b: jnp.sum(wj * jnp.abs(a - b)))


def points(rng, n):
    return np.stack([rng.uniform(-60, 60, n), rng.uniform(-170, 170, n)], 1).astype(np.float32)


def probabilities(rng, n, d=64, anchors=32, sparse=False):
    a = rng.dirichlet(np.full(d, 0.3), anchors)
    rows = a[rng.integers(0, anchors, n)] * rng.uniform(0.7, 1.3, (n, d))
    if sparse:  # exact zeros: the formula's log guards
        rows[rng.random((n, d)) < 0.3] = 0.0
    return (rows / rows.sum(1, keepdims=True)).astype(np.float32)


def set_rows(rng, n, universe=2000, bases=32, width=None):
    base = [rng.choice(universe, 40, replace=False) for _ in range(bases)]
    sets = []
    for _ in range(n):
        b = base[rng.integers(0, bases)]
        sets.append(np.unique(np.concatenate([b[rng.random(len(b)) < 0.75], rng.choice(universe, 5, replace=False)])))
    width = width or max(len(s) for s in sets)
    out = np.full((n, width), -1, np.int32)
    for i, s in enumerate(sets):
        out[i, : len(s)] = s[:width]
    return out


def clustered(rng, n, d=128):
    anchors = (rng.standard_normal((32, d)) * 3).astype(np.float32)
    return (anchors[rng.integers(0, 32, n)] + rng.standard_normal((n, d))).astype(np.float32)


def data(metric, rng, n):
    """(ndim, rows) of a metric of the tail."""
    if metric == "haversine":
        return 2, points(rng, n)
    if metric == "divergence":
        return 64, probabilities(rng, n, sparse=True)
    if metric == "jaccard":
        x = set_rows(rng, n, width=48)
        return x.shape[1], x
    return 128, clustered(rng, n)


def indexes(metric, ndim):
    """(port index, JAX index) of a metric of the tail."""
    if metric == "udf":
        tm, jm = udf_pair()
        return Index(ndim=ndim, metric=tm, dtype="f32"), usearch_tpu.Index(ndim=ndim, metric=jm, dtype="f32")
    dtype = None if metric == "jaccard" else "f32"
    return Index(ndim=ndim, metric=metric, dtype=dtype), usearch_tpu.Index(ndim=ndim, metric=metric, dtype=dtype)


def assert_same(got, want, exact=False):
    """Distances within the float tolerance (or equal), keys equal apart
    from ties within it."""
    np.testing.assert_array_equal(got.counts, want.counts)
    if exact:
        np.testing.assert_array_equal(got.distances, want.distances)
    else:
        np.testing.assert_allclose(got.distances, want.distances, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    tol = 0.0 if exact else FLOAT_ATOL
    for row, col in zip(*np.nonzero(got.keys != want.keys)):
        near = np.abs(want.distances[row] - got.distances[row, col]) <= FLOAT_RTOL * abs(got.distances[row, col]) + tol
        assert got.keys[row, col] in want.keys[row][near] or near[-1], (row, col)


# ----------------------------------------------------------------------
# Distances
# ----------------------------------------------------------------------


@pytest.mark.parametrize("metric", TAIL)
def test_tile_pair_and_gathered_dists_match_reference(metric):
    rng = np.random.default_rng(7)
    ndim, x = data(metric, rng, 96)
    if metric != "jaccard":  # the stored width: UDFs see the padded rows
        x = np.pad(x, ((0, 0), (0, 128 - ndim)))
    q, t = x[:12], x[12:]
    tm, jm = udf_pair() if metric == "udf" else (None, None)
    mk = MetricKind.Unknown if metric == "udf" else MetricKind(metric)
    jk = JMetric.Unknown if metric == "udf" else JMetric(metric)
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    qs, ts = distances.row_stats(tq, ScalarKind.F32), distances.row_stats(tt, ScalarKind.F32)
    rows = t[: 12 * 7].reshape(12, 7, -1)
    jfn = jm and jm.fn

    @jax.jit
    def reference(jq, jt, jrows):  # one compile for the three functions
        jqs, jts = jdist.row_stats(jq, JKind.F32), jdist.row_stats(jt, JKind.F32)
        pair = None if metric == "udf" else jdist.pair_dists(jk, JKind.F32, jq, jt[:12], ndim)
        return (jdist.tile_dists(jk, JKind.F32, jq, jqs, jt, jts, ndim, jfn),
                jdist.gathered_dists(jk, JKind.F32, jq, jrows, ndim, jfn), pair)

    want, want_g, want_p = reference(jnp.asarray(q), jnp.asarray(t), jnp.asarray(rows))
    got = distances.tile_dists(mk, ScalarKind.F32, tq, qs, tt, ts, ndim, tm and tm.fn).numpy()
    got_g = distances.gathered_dists(mk, ScalarKind.F32, tq, torch.from_numpy(rows), ndim, tm and tm.fn).numpy()
    if metric == "jaccard":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_g, want_g)
    else:
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
        np.testing.assert_allclose(got_g, want_g, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    if metric != "udf":
        got_p = distances.pair_dists(mk, ScalarKind.F32, tq, tt[:12], ndim).numpy()
        np.testing.assert_allclose(got_p, want_p, rtol=0 if metric == "jaccard" else FLOAT_RTOL,
                                   atol=0 if metric == "jaccard" else FLOAT_ATOL)


def test_jaccard_counts_repeats_and_empty_sets_as_the_reference():
    """Entries repeated in a query count once each, empty sets score 0, and
    a row may hold int32's largest value."""
    big = np.iinfo(np.int32).max
    q = np.array([[3, 3, 7, -1], [-1, -1, -1, -1], [big, 5, -1, -1]], np.int32)
    t = np.array([[3, 9, -1, -1], [-1, -1, -1, -1], [5, big, 1, -1], [7, 3, 2, 8]], np.int32)
    got = distances.jaccard_set_dists(torch.from_numpy(q), torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdist.jaccard_set_dists(jnp.asarray(q), jnp.asarray(t))))
    rows = np.broadcast_to(t, (3, 4, 4)).copy()
    got_g = distances.gathered_dists(MetricKind.Jaccard, ScalarKind.F32, torch.from_numpy(q), torch.from_numpy(rows), 4)
    np.testing.assert_array_equal(got_g.numpy(), got)


def test_set_sketch_bit_for_bit():
    rng = np.random.default_rng(3)
    x = rng.integers(-1, np.iinfo(np.int32).max, (64, 40), dtype=np.int64).astype(np.int32)
    x[:, 30:] = -1
    np.testing.assert_array_equal(ivf._set_sketch(torch.from_numpy(x)).numpy(), np.asarray(jivf._set_sketch(jnp.asarray(x))))
    np.testing.assert_array_equal(ivf._query_f32(ScalarKind.F32, torch.from_numpy(x)).numpy(),
                                  np.asarray(jivf._query_f32(JKind.F32, jnp.asarray(x))))


# ----------------------------------------------------------------------
# Index searches
# ----------------------------------------------------------------------


@pytest.mark.parametrize("metric", TAIL)
def test_exact_search_matches_reference(metric):
    rng = np.random.default_rng(13)
    ndim, x = data(metric, rng, 600)
    port, ref = indexes(metric, ndim)
    port.add(None, x)
    ref.add(None, x)
    q = x[::50].copy()
    assert_same(port.search(q, 6, exact=True), ref.search(q, 6, exact=True), exact=metric == "jaccard")


def jax_state(ix, metric) -> dict:
    state = dict(
        table=np.asarray(ix._table), stats=np.asarray(ix._stats), valid=np.asarray(ix._valid),
        slot_keys=np.asarray(ix._slot_keys), count=ix._count, next_slot=ix._next_slot,
        free_slots=list(ix._free_slots), ndim=ix.ndim, metric=ix.metric.value, dtype=ix.dtype.value, multi=ix.multi)
    if metric is not None:
        state["metric"] = metric
    return state


def jax_ivf_state(ix) -> dict:
    v = ix._ivf
    return dict(
        centroids=np.asarray(v.centroids), avg_rows=v.avg_rows_per_part, built_count=v.built_count,
        spilled=v.spilled, fresh=v.fresh_np, starts=np.asarray(v.starts), lens=np.asarray(v.lens), p_win=v.p_win,
        shadow_pos=v.shadow_np_pos, shadow_src=v.shadow_np_src, part_slots=None)


@pytest.mark.parametrize("metric", TAIL)
def test_carried_probed_search_matches_reference(metric):
    """The JAX build carried across: probed searches equal the JAX
    package's, deletions and fresh rows included."""
    rng = np.random.default_rng(17)
    ndim, x = data(metric, rng, 1200)
    _, ref = indexes(metric, ndim)
    ref.add(None, x[:1100])
    ref.remove(np.arange(0, 1100, 37))
    ref.optimize(n_partitions=12, reorder=True)
    ref.add(np.arange(1100, 1200), x[1100:])
    ref.expansion_search = 16
    port = index_from_arrays(jax_state(ref, udf_pair()[0] if metric == "udf" else None), device="cpu")
    install_ivf(port, jax_ivf_state(ref))
    port.expansion_search = ref.expansion_search
    assert port._ivf_serveable()
    q = np.concatenate([x[5:400:40], x[1100:1200:25]])
    assert_same(port.search(q, 8), ref.search(q, 8), exact=metric == "jaccard")


def recall(ix, q, k=10):
    gt = ix.search(q, k, exact=True).keys
    got = ix.search(q, k).keys
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(got, gt)]))


@pytest.mark.parametrize("metric,bar,expansion", [("haversine", 0.9, 32), ("divergence", 0.9, 32),
                                                  ("udf", 0.9, 32), ("jaccard", 0.85, 64)])
def test_own_build_meets_recall_bars(metric, bar, expansion):
    """The port's own k-means build (its quantizer spaces: the Hellinger
    embedding, the set sketch, the raw rows) at tests/test_metric_tail.py's
    bars, probing a fraction of the rows."""
    rng = np.random.default_rng({"haversine": 0, "divergence": 1, "udf": 2, "jaccard": 3}[metric])
    n = 2000
    if metric == "divergence":
        ndim, x = 64, probabilities(rng, n)
    elif metric == "jaccard":
        x = set_rows(rng, n, universe=5000)
        ndim = x.shape[1]
    else:
        ndim, x = data(metric, rng, n)
    ix, _ = indexes(metric, ndim)
    ix.add(None, x)
    ix.optimize(n_partitions=32)
    ix.expansion_search = expansion
    assert ix._ivf_serveable()
    if metric == "haversine":
        q = x[:32] + rng.normal(0, 0.1, (32, 2)).astype(np.float32)
    elif metric == "udf":
        q = x[:32] + 0.05 * rng.standard_normal((32, ndim)).astype(np.float32)
    else:
        q = x[:32].copy()
    assert recall(ix, q) >= bar
    # sub-linear at a serving budget (jaccard's over-probes for the bar)
    assert ix._ivf.scanned_rows(expansion // 4 if metric == "jaccard" else expansion) < n


def test_udf_probed_distances_are_the_metric():
    """Probed UDF results carry the true metric's values (2e-3 relative),
    and `pairwise_distance` applies the UDF."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1500, 128)).astype(np.float32)
    ix = Index(ndim=128, metric=CompiledMetric(lambda a, b: (a - b).abs().sum()), dtype="f32")
    ix.add(None, x)
    ix.optimize(n_partitions=16, reorder=True)
    ix.expansion_search = 512
    m = ix.search(x[:8], 3)
    want = np.abs(x[:8, None, :] - x[m.keys.astype(int)]).sum(-1)
    np.testing.assert_allclose(m.distances, want, rtol=2e-3)
    np.testing.assert_allclose(ix.pairwise_distance(np.arange(4), np.arange(4, 8)),
                               np.abs(x[:4] - x[4:8]).sum(-1), rtol=1e-5)
    fork = ix.fork()
    assert fork._metric_fn is ix._metric_fn and len(fork) == 0


def test_metric_setter_and_bare_callable():
    """The setter takes a kind, a CompiledMetric or a bare callable, as the
    JAX package's; a metric changed after a build keeps serving."""
    rng = np.random.default_rng(9)
    x = rng.random((256, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ix = Index(ndim=16, metric="ip", dtype="f32")
    ix.add(None, x)
    ix.optimize(n_partitions=8)
    ix.metric = "pearson"
    assert ix.metric == MetricKind.Pearson
    np.testing.assert_array_equal(ix.search(x[:4], 1).keys[:, 0], np.arange(4))
    ix.metric = lambda a, b: ((a - b) ** 2).sum()
    assert ix.metric == MetricKind.Unknown and ix._metric_fn is not None
    np.testing.assert_array_equal(ix.search(x[:4], 1).keys[:, 0], np.arange(4))
    ix.metric = CompiledMetric(lambda a, b: -(a * b).sum(), MetricKind.IP)
    assert ix.metric == MetricKind.IP
    np.testing.assert_array_equal(ix.search(x[:4], 1, exact=True).keys[:, 0], np.arange(4))
    bare = Index(ndim=16, metric=lambda a, b: (a - b).abs().max(), dtype="f32")
    bare.add(None, x)
    np.testing.assert_array_equal(bare.search(x[:4], 1).keys[:, 0], np.arange(4))
