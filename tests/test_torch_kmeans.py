"""usearch_torch.kmeans against usearch_tpu.kmeans on the CPU.

Assignment scores bf16-rounded operands with f32 sums in both packages, in
other orders, so points almost equidistant from two centroids may flip:
assignments are held to >= 99.9% agreement (>= 99.5% for the second-nearest
of `assign_flat`, whose near ties are denser), distances and centroids
within rtol 1e-4. k-means++ draws from different generators, so the fits
start both packages from the same centroids."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402

from usearch_torch.enums import MetricKind  # noqa: E402

jkm = importlib.import_module("usearch_tpu.kmeans")  # the package exports a `kmeans` function
km = importlib.import_module("usearch_torch.kmeans")  # and so does the port

METRICS = ["l2sq", "cos", "ip"]


def blobs(rng, n_per, centers, ndim, spread):
    parts = [rng.standard_normal(ndim) * 3 + rng.standard_normal((n_per, ndim)) * spread for _ in range(centers)]
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("top2", [False, True])
def test_assign_flat_matches_reference(metric, top2):
    rng = np.random.default_rng(1)
    pts = blobs(rng, 128, 8, 32, 1.0)  # 1024 points
    cents = rng.standard_normal((100, 32)).astype(np.float32)  # padded to 2 tiles of 64
    want = [np.asarray(x) for x in jkm.assign_flat(JMetric(metric), jnp.asarray(pts), jnp.asarray(cents),
                                                   256, 64, top2)]
    got = [x.numpy() for x in km.assign_flat(MetricKind(metric), torch.from_numpy(pts), torch.from_numpy(cents),
                                             256, 64, top2)]
    assert np.mean(got[0] == want[0]) >= 0.999
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)
    if top2:
        assert np.mean(got[2] == want[2]) >= 0.995
        np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-4)
        assert (got[0] != got[2]).all()


@pytest.mark.parametrize("metric", METRICS)
def test_assign_step_and_update_match_reference(metric):
    rng = np.random.default_rng(2)
    pts = blobs(rng, 64, 8, 16, 0.5)
    cents = pts[rng.choice(len(pts), 8, replace=False)]
    ja, jd, js, jc = (np.asarray(x) for x in jkm._assign_step(JMetric(metric), jnp.asarray(pts), jnp.asarray(cents), 128))
    ta, td, ts, tc = km._assign_step(MetricKind(metric), torch.from_numpy(pts), torch.from_numpy(cents), 128)
    assert np.mean(ta.numpy() == ja) >= 0.999
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-4, atol=1e-4)
    if (ta.numpy() == ja).all():
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(tc.numpy(), jc)
    jm, jshift = jkm._update_centroids(JMetric(metric), jnp.asarray(js), jnp.asarray(jc), jnp.asarray(cents))
    tm, tshift = km._update_centroids(MetricKind(metric), torch.from_numpy(js), torch.from_numpy(jc),
                                      torch.from_numpy(cents))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    assert float(tshift) == pytest.approx(float(jshift), rel=1e-5)


def test_update_keeps_empty_clusters():
    sums = torch.tensor([[2.0, 4.0], [0.0, 0.0]])
    counts = torch.tensor([2.0, 0.0])
    old = torch.tensor([[9.0, 9.0], [5.0, 6.0]])
    means, _ = km._update_centroids(MetricKind.L2sq, sums, counts, old)
    np.testing.assert_array_equal(means.numpy(), [[1.0, 2.0], [5.0, 6.0]])


@pytest.mark.parametrize("metric", METRICS)
def test_kmeans_fit_matches_reference_from_same_start(monkeypatch, metric):
    """Both packages' k-means++ replaced by the same initial centroids: one
    of them duplicated, so a cluster starts empty and is reseeded at the
    farthest point in both."""
    rng = np.random.default_rng(3)
    pts = blobs(rng, 150, 6, 16, 0.6)[:897]  # not a power of two: padded rows
    init = pts[rng.choice(len(pts), 6, replace=False)].copy()
    init[5] = init[4]
    monkeypatch.setattr(jkm, "_kmeanspp_init", lambda points, key, k: jnp.asarray(init))
    monkeypatch.setattr(km, "_kmeanspp_init", lambda points, gen, k: torch.from_numpy(init.copy()))
    wa, wd, wc = jkm.kmeans_fit(pts, 6, metric=JMetric(metric), max_iterations=25, seed=0)
    ga, gd, gc = km.kmeans_fit(pts, 6, metric=MetricKind(metric), max_iterations=25, seed=0)
    assert ga.shape == wa.shape == (897,) and gc.shape == wc.shape == (6, 16)
    assert np.mean(ga == wa) >= 0.999
    np.testing.assert_allclose(gc, wc, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-4)


def test_kmeanspp_recovers_blobs():
    """The port's own seeding: points of one blob share a cluster and blobs
    get distinct clusters (tests/test_cluster.py's case)."""
    rng = np.random.default_rng(42)
    x = blobs(rng, 50, 4, 8, 0.05)
    assigns, dists, cents = km.kmeans_fit(x, 4, seed=0)
    assert cents.shape == (4, 8) and assigns.shape == (200,) and dists.shape == (200,)
    for b in range(4):
        assert len(np.unique(assigns[b * 50 : (b + 1) * 50])) == 1
    assert len(np.unique(assigns[::50])) == 4
    d0 = np.sum((x[0] - cents[assigns[0]]) ** 2)
    assert abs(d0 - dists[0]) / max(1.0, float(np.sum(x[0] ** 2))) < 0.02


def test_kmeans_fit_edges():
    x = np.random.default_rng(5).standard_normal((5, 4)).astype(np.float32)
    assigns, _, cents = km.kmeans_fit(x, 10, seed=0)  # k clipped to n
    assert cents.shape == (5, 4) and sorted(assigns.tolist()) == list(range(5))
    with pytest.raises(ValueError):
        km.kmeans_fit(np.zeros((0, 4), np.float32), 2)
    with pytest.raises(ValueError):
        km.kmeans_fit(x, 0)


def test_kmeans_fit_on_a_tensor_keeps_its_device_and_dtype():
    """A table in storage dtype (i8) is fit where it lies, cast per tile."""
    rng = np.random.default_rng(6)
    rows = torch.from_numpy(np.clip(blobs(rng, 40, 3, 16, 0.2) * 30, -127, 127).astype(np.int8))
    assigns, _, cents = km.kmeans_fit(rows, 3, metric=MetricKind.L2sq, seed=1)
    assert cents.dtype == np.float32 and len(np.unique(assigns)) == 3
    for b in range(3):
        assert len(np.unique(assigns[b * 40 : (b + 1) * 40])) == 1
