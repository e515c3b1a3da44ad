"""The rest of the public surface on the CPU (ROADMAP A.3c), modelled on
tests/test_index.py's cases and held against the JAX package: the row
distances of `pairwise_distance`, the introspection properties, `specs`,
`stats` and the per-level stats, and the package's `search` and `kmeans`."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import usearch_tpu  # noqa: E402

import usearch_torch  # noqa: E402

jkm = importlib.import_module("usearch_tpu.kmeans")
km = importlib.import_module("usearch_torch.kmeans")


def pair(ndim=8, **kwargs):
    return usearch_tpu.Index(ndim=ndim, **kwargs), usearch_torch.Index(ndim=ndim, device="cpu", **kwargs)


def test_pairwise_distance():
    """tests/test_index.py's case on the port."""
    index = usearch_torch.Index(ndim=8, metric="l2sq", dtype="f32", device="cpu")
    vecs = np.random.default_rng(0).random((4, 8)).astype(np.float32)
    index.add(np.arange(4), vecs)
    assert abs(index.pairwise_distance(0, 1) - float(np.sum((vecs[0] - vecs[1]) ** 2))) < 1e-4
    d_many = index.pairwise_distance(np.array([0, 1]), np.array([2, 3]))
    assert d_many.shape == (2,)
    assert index.distance_between(2, 3) == index.pairwise_distance(2, 3)


@pytest.mark.parametrize("dtype,metric", [("f32", "l2sq"), ("f32", "pearson"), ("bf16", "cos"), ("i8", "ip"),
                                          ("i8", "cos"), ("b1", "hamming"), ("b1", "tanimoto"),
                                          ("b1", "sorensen")])
def test_pairwise_distance_matches_reference(dtype, metric):
    """The same stored rows in both packages give the same row distances:
    i8 and b1 bit for bit (integer dots), floats within rtol 1e-5."""
    rng = np.random.default_rng(1)
    ref, port = pair(ndim=40, metric=metric, dtype=dtype)
    if dtype == "b1":
        x = np.packbits(rng.integers(0, 2, (12, 40)).astype(np.uint8), axis=1)
        x[0] = 0  # an empty row: empty unions and sums give 0
    elif dtype == "i8":
        x = rng.integers(-127, 128, (12, 40)).astype(np.int8)
    else:
        x = rng.standard_normal((12, 40)).astype(np.float32)
    x[1] = 0 if dtype != "b1" else x[1]  # a zero row: cos's zero-norm rules
    ref.add(np.arange(12), x)
    port.add(np.arange(12), x)
    left, right = np.arange(12), np.array([1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 0])
    want = np.asarray(ref.pairwise_distance(left, right))
    got = port.pairwise_distance(left, right)
    if dtype in ("i8", "b1") and metric != "cos":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert isinstance(port.pairwise_distance(2, 3), float)


def test_index_properties():
    """tests/test_index.py's case on the port."""
    index = usearch_torch.Index(ndim=16, metric="cos", dtype="f32", expansion_add=99, expansion_search=77,
                                device="cpu")
    assert index.ndim == 16 and index.expansion_add == 99 and index.expansion_search == 77
    index.expansion_search = 55
    assert index.expansion_search == 55
    assert index.specs["Dimensions"] == 16
    assert index.stats.nodes == 0
    assert "usearch_torch.Index" in repr(index)


@pytest.mark.parametrize("dtype,metric", [("f32", "cos"), ("f16", "l2sq"), ("bf16", "ip"), ("i8", "ip"),
                                          ("b1", "hamming")])
def test_introspection_matches_reference(dtype, metric):
    rng = np.random.default_rng(2)
    ref, port = pair(ndim=24, metric=metric, dtype=dtype, multi=True)
    assert port.max_level == ref.max_level == 0 and port.nlevels == ref.nlevels == 1
    if dtype == "bf16":
        assert port.numpy_dtype is None  # numpy has no bf16
    else:
        assert port.numpy_dtype == ref.numpy_dtype
    assert port.jit is False
    assert port.hardware_acceleration == "cpu"
    assert set(port.specs) == set(ref.specs)
    assert port.specs["Class"] == "usearch_torch.Index" and port.specs["Hardware"] == "cpu"
    assert port.vectors.shape == np.asarray(ref.vectors).shape == (0, 24)
    x = (np.packbits(rng.integers(0, 2, (6, 24)).astype(np.uint8), axis=1) if dtype == "b1"
         else rng.standard_normal((6, 24)).astype(np.float32))
    keys = np.array([3, 3, 4, 5, 6, 7])
    ref.add(keys, x)
    port.add(keys, x)
    for name in ("Connectivity", "Dimensions", "Expansion@Add", "Expansion@Search", "Size", "DataType",
                 "MetricKind", "Multi", "Loaded"):
        assert port.specs[name] == ref.specs[name], name
    np.testing.assert_allclose(port.vectors, np.asarray(ref.vectors), rtol=1e-6, atol=1e-7)
    stats = port.stats
    assert isinstance(stats, usearch_torch.IndexStats) and "usearch_torch.IndexStats" in repr(stats)
    assert (stats.nodes, stats.edges, stats.max_edges) == (6, 0, 0) and stats.allocated_bytes == port.memory_usage
    assert [s.nodes for s in port.levels_stats] == [s.nodes for s in ref.levels_stats] == [6]
    assert port.level_stats(0).nodes == 6 and port.level_stats(1).nodes == ref.level_stats(1).nodes == 0
    assert port.stats_object().allocated_bytes == stats.allocated_bytes


def test_package_search_matches_reference():
    rng = np.random.default_rng(3)
    data = rng.standard_normal((300, 16)).astype(np.float32)
    queries = data[[5, 77, 120]]
    for metric in ("cos", "l2sq"):
        want = usearch_tpu.search(data, queries, 4, metric)
        got = usearch_torch.search(data, queries, 4, metric, device="cpu")
        np.testing.assert_array_equal(got.keys, want.keys)
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5, atol=1e-5)
        one = usearch_torch.search(data, queries[0], 4, metric, exact=True, device="cpu")
        np.testing.assert_array_equal(one.keys, want.keys[0])


def test_package_kmeans_matches_reference(monkeypatch):
    """`kmeans` is `kmeans_fit` over f32 rows in both packages, from the
    same start; it hides the fit's module on the package."""
    rng = np.random.default_rng(4)
    x = np.concatenate([c + rng.standard_normal((60, 8)) * 0.3 for c in rng.standard_normal((5, 8)) * 4])
    init = x[rng.choice(len(x), 5, replace=False)].astype(np.float32)
    monkeypatch.setattr(jkm, "_kmeanspp_init", lambda points, key, k: jnp.asarray(init))
    monkeypatch.setattr(km, "_kmeanspp_init", lambda points, gen, k, bucket=None: torch.from_numpy(init.copy()))
    wa, wd, wc = usearch_tpu.kmeans(x, 5, metric="l2sq", max_iterations=20, seed=0)
    ga, gd, gc = usearch_torch.kmeans(x, 5, metric="l2sq", max_iterations=20, seed=0, device="cpu")
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_allclose(gc, wc, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-4)
    assert callable(usearch_torch.kmeans) and usearch_torch.kmeans is km.kmeans
    with pytest.raises(RuntimeError) if not torch.cuda.is_available() else pytest.raises(ValueError):
        usearch_torch.kmeans(x, 0)  # the card by default: none here
