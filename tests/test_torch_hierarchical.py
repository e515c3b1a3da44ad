"""usearch_torch.kmeans.kmeans_hierarchical against usearch_tpu's on the
CPU, and the IVF build's switch to it past `ivf.MAX_PARTITIONS`.

k-means++ draws from different generators, so both packages' seeding is
replaced by the same start: the first k rows of the (padded) points of each
fit. The level-1 sample comes from numpy's ``default_rng(seed)`` in both.
Assignments are held equal and centroids within test_torch_kmeans.py's
tolerance (rtol 1e-4, atol 1e-4)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import ivf  # noqa: E402
from usearch_torch.enums import MetricKind  # noqa: E402

jkm = importlib.import_module("usearch_tpu.kmeans")
km = importlib.import_module("usearch_torch.kmeans")

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def same_start(monkeypatch):
    monkeypatch.setattr(jkm, "_kmeanspp_init", lambda points, key, k: points[:k].astype(jnp.float32))
    monkeypatch.setattr(km, "_kmeanspp_init", lambda points, gen, k, bucket=None: points[:k].float())


def blobs(rng, n_per, centers, ndim, spread):
    parts = [rng.standard_normal(ndim) * 3 + rng.standard_normal((n_per, ndim)) * spread for _ in range(centers)]
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("metric,flat_assign,return_dists,sample", [
    ("l2sq", True, True, 300),
    ("l2sq", False, False, 2000),
    ("ip", True, False, 300),
    ("cos", False, True, 300),
])
def test_hierarchical_matches_reference(same_start, metric, flat_assign, return_dists, sample):
    """582 points in 6 blobs, k = 30 (k1 = 6 coarse clusters, k2 = 5): a
    sample of 300 rows or all of them at level 1; sub-fits padded to
    powers of two."""
    x = blobs(np.random.default_rng(0), 97, 6, 16, 0.7)
    kw = dict(sample=sample, max_iterations=6, seed=3, flat_assign=flat_assign, return_dists=return_dists)
    wa, wd, wc = jkm.kmeans_hierarchical(x, 30, metric=JMetric(metric), **kw)
    ga, gd, gc = km.kmeans_hierarchical(x, 30, metric=MetricKind(metric), **kw)
    assert gc.shape == wc.shape and ga.shape == wa.shape == (len(x),)
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_allclose(gc, wc, **TOL)
    assert gd.shape == wd.shape
    if return_dists:
        np.testing.assert_allclose(gd, wd, **TOL)


@pytest.mark.parametrize("metric", ["l2sq", "cos"])
def test_fused_lloyd_reseeds_like_the_reference(metric):
    """A duplicated start leaves a cluster empty: both reseed it at the
    hashed row ``(c * 1103515245 + it * 40503) % n_valid`` in wrapping
    int32; the padded rows (copies of row 0) leave the sums in both."""
    rng = np.random.default_rng(4)
    n_valid, n_pad = 200, 256
    pts = blobs(rng, 50, 4, 8, 0.3)[:n_valid]
    pts = np.concatenate([pts, np.repeat(pts[:1], n_pad - n_valid, axis=0)])
    init = pts[[0, 60, 120, 120, 180, 180]].copy()
    wa, wd, wc = (np.asarray(a) for a in jkm._lloyd_fused(JMetric(metric), jnp.asarray(pts), jnp.asarray(init), 6,
                                                           256, n_valid))
    ga, gd, gc = km._lloyd_fused(MetricKind(metric), torch.from_numpy(pts), torch.from_numpy(init), 6, 256, n_valid)
    np.testing.assert_array_equal(ga.numpy()[:n_valid], wa[:n_valid])
    np.testing.assert_allclose(gc.numpy(), wc, **TOL)
    np.testing.assert_allclose(gd.numpy()[:n_valid], wd[:n_valid], **TOL)


def test_reseed_hash_wraps_as_int32():
    """The hash overflows int32 from c = 2: the port's int64 emulation
    equals int32 arithmetic."""
    c = np.arange(4096, dtype=np.int32)
    for it in (0, 1, 24):
        with np.errstate(over="ignore"):
            want = np.mod(c * np.int32(1103515245) + np.int32(it * 40503), 1000)
        got = torch.remainder(km._wrap_i32(km._wrap_i32(torch.arange(4096) * 1103515245) + it * 40503), 1000)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,metric,spill", [("f32", "l2sq", 0.0), ("i8", "ip", 0.1)])
def test_build_switches_to_the_two_level_fit(same_start, monkeypatch, dtype, metric, spill):
    """With `ivf.MAX_PARTITIONS` lowered to 8, ``optimize(20)`` fits two
    levels: each row's partition centroid is the JAX fit's centroid of its
    assignment, called with the arguments of usearch_tpu/ivf.py:292-299
    (with spill, the fit skips its flat pass and the top-2 sweep's nearest
    centroid assigns)."""
    monkeypatch.setattr(ivf, "MAX_PARTITIONS", 8)
    x = blobs(np.random.default_rng(5), 100, 6, 16, 0.5)
    n = len(x)
    index = usearch_torch.Index(ndim=16, metric=metric, dtype=dtype, device="cpu")
    index.add(np.arange(n), x)
    rows = index._table[:n].numpy()  # the stored rows, padded to 128 columns, in key order
    index.optimize(n_partitions=20, reorder=True, spill=spill)

    km_metric = JMetric("ip" if metric == "ip" else "l2sq")
    wa, _, wc = jkm.kmeans_hierarchical(jnp.asarray(rows), 20, metric=km_metric, max_iterations=25, seed=0,
                                        return_dists=False, flat_assign=not spill > 0)
    if spill > 0:
        pt = 1 << (n - 1).bit_length()
        padded = np.concatenate([rows, np.repeat(rows[:1], pt - n, axis=0)])
        ct = 1 << (wc.shape[0] - 1).bit_length()
        wa = np.asarray(jkm.assign_flat(km_metric, jnp.asarray(padded), jnp.asarray(wc), pt, ct, True)[0])[:n]

    v = index._ivf
    cents = v.centroids.numpy()
    np.testing.assert_allclose(np.unique(cents, axis=0), np.unique(wc, axis=0), **TOL)
    starts, lens = v.starts.numpy(), v.lens.numpy()
    primary = index._valid.numpy()
    for c in range(len(starts)):
        pos = np.arange(starts[c], starts[c] + lens[c])
        keys = index._slot_keys[pos[primary[pos]]].astype(np.int64)
        np.testing.assert_allclose(np.broadcast_to(cents[c], (len(keys), cents.shape[1])), wc[wa[keys]], **TOL)
    assert v.spilled == (spill > 0)
    m = index.search(x[::50], 1)
    np.testing.assert_array_equal(m.keys[:, 0], np.arange(0, n, 50))
