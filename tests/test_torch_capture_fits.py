"""The k-means fits' captured steps (usearch_torch/kmeans.py through
graphs.py `GraphCache.repeat`) on the CPU.

On the card a fit's k-means++ step, fused Lloyd step and early-exit Lloyd
step are each captured once a size bucket and replayed. Here
test_torch_capture.py's recording stand-in (`StandIn`) takes the capture's
place in the fit's cache (`kmeans._fit_cache`), with its guard
(`HostReadGuard`) refusing every host read inside a step. Each captured fit
equals the eager one (no cache, the steps called directly) bit for bit,
its exit iteration included, and the JAX package's fit at
test_torch_hierarchical.py's tolerance (rtol 1e-4, atol 1e-4, assignments
equal) from the same start.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_capture import HostReadGuard, StandIn  # noqa: E402
from test_torch_hierarchical import TOL, blobs  # noqa: E402

from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402

from usearch_torch.enums import MetricKind  # noqa: E402
from usearch_torch.graphs import GraphCache  # noqa: E402

jkm = importlib.import_module("usearch_tpu.kmeans")
km = importlib.import_module("usearch_torch.kmeans")


@pytest.fixture
def guard(monkeypatch):
    return HostReadGuard(monkeypatch)


@pytest.fixture
def caches(monkeypatch, guard):
    """The stand-in caches the fits make (one a top-level fit), in order."""
    made = []

    def fit_cache(device):
        made.append(GraphCache("cpu", backend=StandIn(guard)))
        return made[-1]

    monkeypatch.setattr(km, "_fit_cache", fit_cache)
    return made


def eager(fn, *args, **kwargs):
    """``fn`` with no graph cache: every step called directly."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(km, "_fit_cache", lambda device: None)
        return fn(*args, **kwargs)


def assert_bits(got, want):
    for g, w in zip(got, want):
        g, w = (np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in (g, w))
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def counted_steps(monkeypatch):
    """The step counts `_lloyd_loop` returns, call by call."""
    steps, loop = [], km._lloyd_loop
    monkeypatch.setattr(km, "_lloyd_loop", lambda *a, **kw: (lambda r: (steps.append(r[-1]), r)[1])(loop(*a, **kw)))
    return steps


@pytest.mark.parametrize("metric,dtype,fused", [("l2sq", "f32", True), ("cos", "i8", True), ("l2sq", "i8", False),
                                               ("ip", "f32", False)])
def test_captured_fit_equals_eager(caches, monkeypatch, metric, dtype, fused):
    """300 points (padded to 512) in 16 dimensions, k = 9: the seeding's
    eight steps, then the fused steps or the early-exit loop, each step
    captured once under the guard and replayed; the result and the exit
    iteration equal the eager fit's bit for bit."""
    x = blobs(np.random.default_rng(1), 60, 5, 16, 0.8)
    pts = torch.from_numpy(x if dtype == "f32" else np.clip(np.round(x * 30), -127, 127).astype(np.int8))
    steps = counted_steps(monkeypatch)
    kw = dict(metric=MetricKind(metric), max_iterations=12, seed=4, fused=fused)
    got = km.kmeans_fit(pts, 9, **kw)
    want = eager(km.kmeans_fit, pts, 9, **kw)
    assert_bits(got, want)
    (cache,) = caches
    names = sorted(key[0] for key in cache.keys())
    assert names == (["lloyd", "seed"] if fused else ["loop 300", "seed"]) and cache.captures == 2
    # 8 seeding steps and the Lloyd steps with one more for the final
    # assignment, the first of each key its warm run
    if fused:
        assert cache.replays == 7 + 12
    else:
        assert len(steps) == 2 and steps[0] == steps[1] and 1 < steps[0] < 12
        assert cache.replays == 7 + steps[0]


@pytest.mark.parametrize("unit", ["seed", "lloyd", "loop 100"])
def test_each_step_reads_nothing_to_the_host(caches, guard, unit):
    """Each step's capture and replays run under the guard: a host read
    raises, so the fit's passing and the guard's empty log show none."""
    x = blobs(np.random.default_rng(2), 25, 4, 8, 0.5)
    km.kmeans_fit(torch.from_numpy(x), 5, max_iterations=6, seed=1, fused=unit == "lloyd")
    (cache,) = caches
    assert unit in [key[0] for key in cache.keys()] and not guard.caught
    assert cache.replays > 0


def test_a_host_read_in_a_step_raises(caches, monkeypatch):
    """A step that reads to the host fails its capture: the fit raises, and
    no step falls back to eager."""
    update = km._update_centroids
    monkeypatch.setattr(km, "_update_centroids", lambda m, s, c, old: (float(c.sum()), update(m, s, c, old))[1])
    with pytest.raises(AssertionError, match="host read"):
        km.kmeans_fit(blobs(np.random.default_rng(3), 20, 3, 8, 0.5), 4, max_iterations=3, seed=0, fused=True)


def test_one_bucket_serves_fits_of_two_sizes(caches):
    """One bucket of 256 padded rows takes a fit of 200 and one of 150
    valid rows (the rest copies of row 0), with a duplicated start so the
    hashed reseed runs: one Lloyd graph, replayed by both, and each fit
    equal to its own eager fit and to the JAX package's `_lloyd_fused`."""
    rng = np.random.default_rng(4)
    x = blobs(rng, 50, 4, 8, 0.3)
    units = km._Units(torch.device("cpu"))
    bucket = km._Bucket(units, MetricKind.L2sq, torch.empty((256, 8)), 6, 256)
    for n_valid in (200, 150):
        pts = np.concatenate([x[:n_valid], np.repeat(x[:1], 256 - n_valid, axis=0)])
        init = pts[[0, 60, 120, 120, 140, 140]].copy()
        bucket.pts.copy_(torch.from_numpy(pts))
        got = km._lloyd_fused(MetricKind.L2sq, bucket.pts, torch.from_numpy(init), 6, 256, n_valid, bucket)
        got = [t.clone() for t in got]
        want = eager(km._lloyd_fused, MetricKind.L2sq, torch.from_numpy(pts), torch.from_numpy(init), 6, 256, n_valid)
        assert_bits(got, want)
        wa, wd, wc = (np.asarray(a) for a in jkm._lloyd_fused(JMetric.L2sq, jnp.asarray(pts), jnp.asarray(init), 6,
                                                               256, n_valid))
        np.testing.assert_array_equal(got[0].numpy()[:n_valid], wa[:n_valid])
        np.testing.assert_allclose(got[2].numpy(), wc, **TOL)
    (cache,) = caches[:1]
    assert [key[0] for key in cache.keys()] == ["lloyd"] and cache.captures == 1 and cache.replays == 2 * 7 - 1


@pytest.fixture
def same_start(monkeypatch):
    monkeypatch.setattr(jkm, "_kmeanspp_init", lambda points, key, k: points[:k].astype(jnp.float32))
    monkeypatch.setattr(km, "_kmeanspp_init", lambda points, gen, k, bucket=None: points[:k].float())


@pytest.mark.parametrize("metric", ["l2sq", "cos"])
def test_hierarchical_replays(caches, metric):
    """582 points in 6 blobs, k = 30 (k1 = 6, k2 = 5): the coarse fit and
    the sub-fits, each sub-fit gathered into its size bucket, k-means++
    included; equal to the eager two-level fit bit for bit, with a graph a
    bucket and unit, each sub-fit after a bucket's first all replays."""
    x = blobs(np.random.default_rng(0), 97, 6, 16, 0.7)
    kw = dict(metric=MetricKind(metric), sample=300, max_iterations=6, seed=3)
    got = km.kmeans_hierarchical(x, 30, **kw)
    want = eager(km.kmeans_hierarchical, x, 30, **kw)
    assert_bits(got, want)
    (cache,) = caches
    buckets = {key[1:] for key in cache.keys()}
    assert cache.captures == 2 * len(buckets) == len(cache) and len(buckets) >= 2  # the coarse fit's and level 2's
    # steps: the coarse fit's 5 seeding and 6 + 1 Lloyd, each sub-fit's 4
    # and 6 + 1; the first of each graph its warm run
    runs = cache.replays + cache.captures
    assert (runs - 12) % 11 == 0 and (runs - 12) // 11 > len(buckets) - 1


@pytest.mark.parametrize("metric,flat_assign", [("l2sq", True), ("ip", False)])
def test_hierarchical_matches_reference(same_start, caches, metric, flat_assign):
    """The captured two-level fit against the JAX package's from the same
    start (the first k rows of each fit), as test_torch_hierarchical.py
    holds the eager one."""
    x = blobs(np.random.default_rng(0), 97, 6, 16, 0.7)
    kw = dict(sample=300, max_iterations=6, seed=3, flat_assign=flat_assign)
    wa, wd, wc = jkm.kmeans_hierarchical(x, 30, metric=JMetric(metric), **kw)
    ga, gd, gc = km.kmeans_hierarchical(x, 30, metric=MetricKind(metric), **kw)
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_allclose(gc, wc, **TOL)
    np.testing.assert_allclose(gd, wd, **TOL)
    assert caches[0].replays > 0
