"""`Index.cluster` and `Index.join` (ROADMAP A.9) on the CPU.

`cluster` keeps the bounds contract of tests/test_cluster.py (the populated
cluster count within ``[min_count, max_count]`` where feasible, skewed and
degenerate data included), b1 indexes cluster over their unpacked bits,
the metric tail under l2sq, and set indexes refuse; `_assign_to_centroids`
gives the JAX package's answer for the same centroids. `join` of the same
two indexes with ``exact=True`` gives the JAX package's mapping, and a
probed join matches the perturbed copies."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import usearch_tpu  # noqa: E402
from usearch_tpu import cluster as jcluster  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import cluster  # noqa: E402
from usearch_torch.enums import MetricKind  # noqa: E402


def Index(**kwargs):
    return usearch_torch.Index(device="cpu", **kwargs)


def blobs(rng, n_per, centers, ndim, spread=0.05):
    return np.concatenate([rng.standard_normal(ndim) * 3 + rng.standard_normal((n_per, ndim)) * spread
                           for _ in range(centers)]).astype(np.float32)


def test_index_cluster(rng):
    index = Index(ndim=8, metric="l2sq", dtype="f32")
    x = blobs(rng, 40, 3, 8)
    index.add(np.arange(len(x), dtype=np.uint64), x)
    clustering = index.cluster(min_count=3, max_count=3)
    centroid_keys, sizes = clustering.centroids_popularity
    assert len(centroid_keys) == 3 and sizes.sum() == len(x)
    members = clustering.members_of(centroid_keys[0])
    assert len(members) > 0
    assert len(clustering.subcluster(centroid_keys[0], min_count=2, max_count=2).queries) == len(members)
    assert index.cluster(vectors=x[:10], min_count=3, max_count=3).matches.keys.shape == (10, 1)
    assert usearch_torch.Clustering is type(clustering)


def test_cluster_bounds_contract_skewed(rng):
    """The populated count within its bounds on data where plain k-means
    leaves clusters empty, on equal points, and an infeasible floor."""
    index = Index(ndim=4, metric="l2sq", dtype="f32")
    x = np.concatenate([np.zeros((97, 4), np.float32) + rng.normal(0, 1e-4, (97, 4)),
                        np.eye(4, dtype=np.float32)[:3] * 100.0]).astype(np.float32)
    index.add(np.arange(len(x), dtype=np.uint64), x)
    for lo, hi in [(6, 8), (5, 5), (8, 12)]:
        _, sizes = index.cluster(min_count=lo, max_count=hi).centroids_popularity
        assert lo <= int((sizes > 0).sum()) <= hi, (lo, hi)
        assert sizes.sum() == len(x)
    same = Index(ndim=4, metric="l2sq", dtype="f32")
    same.add(np.arange(20, dtype=np.uint64), np.ones((20, 4), np.float32))
    _, sizes = same.cluster(min_count=4, max_count=6).centroids_popularity
    assert 4 <= int((sizes > 0).sum()) <= 6
    few = Index(ndim=4, metric="l2sq", dtype="f32")
    few.add(np.arange(3, dtype=np.uint64), rng.normal(size=(3, 4)).astype(np.float32))
    _, sizes = few.cluster(min_count=8, max_count=10).centroids_popularity
    assert int((sizes > 0).sum()) <= 3


@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq", "pearson"])
def test_assign_to_centroids_matches_reference(rng, metric):
    rows = rng.standard_normal((50, 6)).astype(np.float32)
    cents = rng.standard_normal((7, 8)).astype(np.float32)
    a, d = cluster._assign_to_centroids(rows, cents, MetricKind(metric))
    ja, jd = jcluster._assign_to_centroids(rows, cents, usearch_tpu.MetricKind(metric))
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(d, jd)


def test_cluster_other_tables(rng):
    """b1 clusters over its bits, divergence under l2sq, i8 over its stored
    values; a set index refuses; an empty index gives an empty result."""
    bits = np.concatenate([rng.random((60, 64)) < p for p in (0.1, 0.5, 0.9)])
    b1 = Index(ndim=64, metric="hamming", dtype="b1")
    b1.add(None, np.packbits(bits, axis=1))
    c = b1.cluster(min_count=3, max_count=3)
    assert c.centroids_popularity[1].sum() == 180
    assert len(np.unique(c.matches.keys[:60])) == 1  # one template's rows together
    p = rng.dirichlet(np.ones(16), 90).astype(np.float32)
    div = Index(ndim=16, metric="divergence", dtype="f32")
    div.add(None, p)
    assert 2 <= len(div.cluster(min_count=2, max_count=4).centroids_popularity[0]) <= 4
    i8 = Index(ndim=8, metric="ip", dtype="i8")
    i8.add(None, blobs(rng, 30, 3, 8))
    assert len(i8.cluster(min_count=3, max_count=3).centroids_popularity[0]) == 3
    sets = Index(ndim=8, metric="jaccard")
    sets.add(None, np.arange(16, dtype=np.int32).reshape(2, 8))
    with pytest.raises(ValueError):
        sets.cluster()
    assert len(Index(ndim=8, metric="l2sq", dtype="f32").cluster().queries) == 0


@pytest.mark.parametrize("dtype", ["f32", "i8"])
def test_exact_join_matches_reference(rng, dtype):
    """The same two indexes in both packages (the larger one swapped to
    propose as the smaller): equal mappings."""
    x = rng.standard_normal((300, 16)).astype(np.float32)
    y = np.concatenate([x[:240] + 0.05 * rng.standard_normal((240, 16)).astype(np.float32),
                        rng.standard_normal((120, 16)).astype(np.float32)])
    a, b = Index(ndim=16, metric="l2sq", dtype=dtype), Index(ndim=16, metric="l2sq", dtype=dtype)
    ja, jb = (usearch_tpu.Index(ndim=16, metric="l2sq", dtype=dtype) for _ in range(2))
    for ix, rows, base in ((a, x, 0), (b, y, 1000), (ja, x, 0), (jb, y, 1000)):
        ix.add(np.arange(base, base + len(rows)), rows)
    for pa, pb, qa, qb in ((a, b, ja, jb), (b, a, jb, ja)):
        got = pa.join(pb, max_proposals=8, exact=True)
        assert got == qa.join(qb, max_proposals=8, exact=True)
        assert len(set(got.values())) == len(got)  # one to one
    assert sum(1000 + k == v for k, v in a.join(b, exact=True).items()) >= 230


def test_probed_join_finds_the_copies(rng):
    """Against an IVF index the proposals come from its probes; perturbed
    copies find their rows; an empty side joins to nothing."""
    x = blobs(rng, 100, 12, 32, spread=0.5)
    women = Index(ndim=32, metric="l2sq", dtype="f32")
    women.add(None, x)
    women.optimize(n_partitions=12, reorder=True)
    women.expansion_search = 64
    men = Index(ndim=32, metric="l2sq", dtype="f32")
    men.add(np.arange(5000, 5200), x[:1200:6] + 0.01 * rng.standard_normal((200, 32)).astype(np.float32))
    got = men.join(women, max_proposals=8)
    assert sum(got.get(5000 + i) == 6 * i for i in range(200)) >= 195
    assert men.join(Index(ndim=32, metric="l2sq", dtype="f32")) == {}
