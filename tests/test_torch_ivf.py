"""The IVF slice at Index level on the CPU: a built IVF carried across from
usearch_tpu (`convert.install_ivf`) answers as the JAX Index does, and the
port's own `optimize` keeps the behaviours of tests/test_cluster.py.

The JAX index runs its Pallas kernels (B3 in interpret mode) through
``set_kernel_backend("pallas")``. Keys are held equal: i8 exactly with
distances bit for bit (ip, l2sq) or within 4 ulps of 1 (cos: the
reference's approximate rsqrt on the CPU); floats apart from near ties,
distances within rtol 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import usearch_tpu  # noqa: E402
from usearch_tpu import exact as jexact  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import ivf  # noqa: E402
from usearch_torch.convert import index_from_arrays, install_ivf  # noqa: E402
from usearch_torch.ops import probe  # noqa: E402

RTOL = 1e-5
#: 4 f32 ulps of 1: the reference's cos on the CPU rounds 1/sqrt twice
#: approximately and fuses `1 + acc * scale` into one FMA
COS_ATOL = 4.8e-7


@pytest.fixture
def pallas_backend():
    jexact.set_kernel_backend("pallas")
    try:
        yield
    finally:
        jexact.set_kernel_backend("auto")


def make_index(**kwargs):
    return usearch_torch.Index(device="cpu", **kwargs)


def blobs(rng, n_per, centers, ndim, spread):
    parts = [rng.standard_normal(ndim) * 3 + rng.standard_normal((n_per, ndim)) * spread for _ in range(centers)]
    return np.concatenate(parts).astype(np.float32)


def unit_blobs(rng, n_per, centers, ndim, spread=0.05):
    x = blobs(rng, n_per, centers, ndim, spread)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def jax_state(ix) -> dict:
    return dict(
        table=np.asarray(ix._table), stats=np.asarray(ix._stats), valid=np.asarray(ix._valid),
        slot_keys=np.asarray(ix._slot_keys), count=ix._count, next_slot=ix._next_slot,
        free_slots=list(ix._free_slots), ndim=ix.ndim, metric=ix.metric.value,
        dtype=ix.dtype.value, multi=ix.multi,
    )


def jax_ivf_state(ix) -> dict:
    v = ix._ivf
    dense = v.starts is not None
    return dict(
        centroids=np.asarray(v.centroids), avg_rows=v.avg_rows_per_part, built_count=v.built_count,
        spilled=v.spilled, fresh=v.fresh_np, starts=np.asarray(v.starts) if dense else None,
        lens=np.asarray(v.lens) if dense else None, p_win=v.p_win, shadow_pos=v.shadow_np_pos,
        shadow_src=v.shadow_np_src, part_slots=None if dense else np.asarray(v.part_slots),
    )


def carried(ref):
    port = index_from_arrays(jax_state(ref), device="cpu")
    install_ivf(port, jax_ivf_state(ref))
    port.expansion_search = ref.expansion_search
    return port


def assert_same(got, want, dtype, metric):
    np.testing.assert_array_equal(got.counts, want.counts)
    if dtype == "i8":
        np.testing.assert_array_equal(got.keys, want.keys)
        if metric == "cos":
            np.testing.assert_allclose(got.distances, want.distances, rtol=0, atol=COS_ATOL)
        else:
            np.testing.assert_array_equal(got.distances, want.distances)
        return
    np.testing.assert_allclose(got.distances, want.distances, rtol=RTOL, atol=1e-5)
    for row, col in zip(*np.nonzero(got.keys != want.keys)):
        near = np.abs(want.distances[row] - got.distances[row, col]) <= RTOL * abs(got.distances[row, col]) + 1e-5
        assert got.keys[row, col] in want.keys[row][near], (row, col)


def data(dtype, rng, n_per=120, centers=10, ndim=64):
    x = unit_blobs(rng, n_per, centers, ndim, 0.3)
    if dtype == "i8":  # stored verbatim by both: no quantizer in the way
        return np.clip(np.round(x * 100), -127, 127).astype(np.int8)
    return x


PARITY = [("i8", "ip"), ("i8", "l2sq"), ("i8", "cos"), ("bf16", "cos"), ("f32", "l2sq")]


@pytest.mark.parametrize("reorder,spill", [(True, 0.0), (True, 0.1), (False, 0.0), (False, 0.1)])
@pytest.mark.parametrize("dtype,metric", PARITY)
def test_carried_ivf_matches_reference(pallas_backend, dtype, metric, reorder, spill):
    """Built by the JAX Index (with deletions before the build, deletions
    and fresh adds after it), carried across, searched by both."""
    rng = np.random.default_rng(11)
    x = data(dtype, rng)
    n = len(x)
    ref = usearch_tpu.Index(ndim=x.shape[1], metric=metric, dtype=dtype, expansion_search=24)
    keys = np.arange(n, dtype=np.uint64) + 100
    ref.add(keys, x)
    ref.remove(keys[rng.choice(n, 30, replace=False)])
    ref.optimize(n_partitions=12, reorder=reorder, spill=spill)
    ref.remove(keys[rng.choice(n, 30, replace=False)])
    extra = data(dtype, np.random.default_rng(12), n_per=4, centers=5)
    ref.add(np.arange(20, dtype=np.uint64) + 5000, extra)
    assert not ref._ivf_dirty and ref._ivf.fresh_np.size == 20
    port = carried(ref)
    q = np.concatenate([x[rng.choice(n, 30, replace=False)], extra[:6]])
    before = probe.grouped_probe.launches
    for k in (1, 10):
        assert_same(port.search(q, k), ref.search(q, k), dtype, metric)
    assert probe.grouped_probe.launches == before  # the CPU runs the plain version


def test_carried_index_searches_exactly_as_reference(pallas_backend):
    """After the reorder, exact search of the carried table equals the
    reference's, and `get` returns the same rows under the same keys."""
    rng = np.random.default_rng(13)
    x = data("i8", rng)
    ref = usearch_tpu.Index(ndim=x.shape[1], metric="l2sq", dtype="i8")
    ref.add(np.arange(len(x), dtype=np.uint64), x)
    ref.optimize(n_partitions=8, reorder=True, spill=0.1)
    port = carried(ref)
    assert port._ivf.shadow_np_pos.size == ref._ivf.shadow_np_pos.size > 0
    got, want = port.search(x[:20], 5, exact=True), ref.search(x[:20], 5, exact=True)
    np.testing.assert_array_equal(got.distances, want.distances)
    for row in range(20):  # only keys tied with the k-th distance may differ
        missing = set(want.keys[row].tolist()) - set(got.keys[row].tolist())
        kth = want.distances[row, -1]
        assert all(want.distances[row][want.keys[row] == m][0] == kth for m in missing)
    np.testing.assert_array_equal(port.get(np.arange(10)), np.asarray(ref.get(np.arange(10))))


@pytest.mark.parametrize("metric", ["l2sq", "cos", "ip"])
def test_full_probe_equals_exact(metric):
    """Dense layout probing every partition reproduces the exact scan
    (window masks, bin edges, uneven partitions), and deletions apply
    without a rebuild."""
    rng = np.random.default_rng(14)
    parts = [rng.standard_normal(16) * 3 + rng.standard_normal((n_per, 16)) * 0.3
             for n_per in [400, 90, 25, 250, 7, 130]]
    x = np.concatenate(parts).astype(np.float32)
    index = make_index(ndim=16, metric=metric, dtype="f32", expansion_search=4096)
    index.add(np.arange(len(x)), x)
    index.optimize(n_partitions=6, reorder=True)
    assert index._ivf.nprobe_for(index.expansion_search) == index._ivf._shape()[0]
    q = x[rng.choice(len(x), 40, replace=False)]
    exact = index.search(q, 7, exact=True)
    got = index.search(q, 7)
    np.testing.assert_array_equal(got.keys, exact.keys)
    np.testing.assert_allclose(got.distances, exact.distances, atol=1e-4)
    victim = int(exact.keys[0, 0])
    index.remove(victim)
    assert not index._ivf_dirty and victim not in index.search(q[:1], 7).keys


@pytest.mark.parametrize("reorder", [True, False])
def test_ivf_recall_on_blobs(reorder):
    """The port's own build: self-queries find themselves, and the IVF's
    recall@5 against exact search is high on separated blobs."""
    rng = np.random.default_rng(15)
    x = blobs(rng, 200, 8, 16, 0.3)
    index = make_index(ndim=16, metric="l2sq", dtype="f32")
    index.add(np.arange(len(x)), x)
    index.optimize(n_partitions=16, reorder=reorder, spill=0.05)
    q = x[::100]
    exact = index.search(q, 5, exact=True)
    got = index.search(q, 5)
    assert np.mean(got.keys[:, 0] == exact.keys[:, 0]) == 1.0
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got.keys, exact.keys))
    assert hits / got.keys.size > 0.9
    assert got.visited_members == index._ivf.scanned_rows(index.expansion_search) * len(q)


def test_i8_serving_shape_on_cpu():
    """`Index(device="cpu").optimize(reorder=True, spill=0.05)` on unit i8
    rows, searched by member queries, as the card's main path runs it."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal((4096, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    index = make_index(ndim=64, metric="ip", dtype="i8", expansion_search=64)
    keys = index.add(None, x)
    index.optimize(n_partitions=64, reorder=True, spill=0.05)
    assert index._ivf.shadow_np_pos.size > 0 and len(index) == 4096
    member = rng.choice(4096, 256, replace=False)
    m = index.search(x[member], 10)
    assert m.keys.shape == (256, 10) and np.all(np.isfinite(m.distances))
    assert np.mean(m.keys[:, 0] == keys[member]) >= 0.99
    for row in m.keys:
        assert len(set(row.tolist())) == 10  # shadows never surface twice


def test_removals_propagate_to_shadows_and_filters():
    rng = np.random.default_rng(17)
    x = blobs(rng, 60, 24, 16, 0.9)
    n = len(x)
    index = make_index(ndim=16, metric="l2sq", dtype="f32", expansion_search=8)
    index.add(None, x)
    index.optimize(n_partitions=32, reorder=True, spill=0.3)
    assert index._ivf.shadow_np_pos.size > 0 and len(index) == n
    for row in index.search(x[:8], 5, exact=True).keys:
        assert len(set(row.tolist())) == len(row)
    victim = int(index.search(x[3], 1).keys[0])
    index.remove(victim)
    assert victim not in index.search(x[3], 10).keys.tolist()
    for row in index.search(x[:6], 10, filter=lambda k: k % 2 == 0).keys:
        assert all(k % 2 == 0 for k in row.tolist())
    # recycling the slot kills the shadows of the row it held
    before = index._ivf.shadow_np_pos.size
    newv = x[victim] + 0.01 * rng.standard_normal(16).astype(np.float32)
    index.add(victim, newv)
    assert victim in index.search(newv, 5).keys.tolist()
    assert index._ivf.shadow_np_pos.size <= before


@pytest.mark.parametrize("reorder", [True, False])
def test_fresh_adds_stay_served(reorder):
    rng = np.random.default_rng(18)
    pts = unit_blobs(rng, 64, 16, 16)
    n = len(pts)
    index = make_index(ndim=16, metric="ip", dtype="f32")
    index.add(np.arange(n), pts)
    index.optimize(n_partitions=16, reorder=reorder)
    extra = unit_blobs(np.random.default_rng(19), 4, 8, 16, 1.0)
    index.add(np.arange(n, n + 32), extra)
    assert not index._ivf_dirty and index._ivf.fresh_np.size == 32
    np.testing.assert_array_equal(index.search(extra, 1).keys[:, 0], np.arange(n, n + 32))
    np.testing.assert_array_equal(index.search(pts[:64], 1).keys[:, 0], np.arange(64))
    m = index.search(extra[:8], 10)
    for row, cnt in zip(m.keys, m.counts):
        assert len(set(row[: int(cnt)].tolist())) == int(cnt)
    index.remove(np.arange(n, n + 4))
    assert index._ivf.fresh_np.size == 28
    assert not np.isin(np.arange(n, n + 4), index.search(extra[:4], 5).keys).any()


def test_recycled_slot_not_served_stale():
    rng = np.random.default_rng(20)
    pts = unit_blobs(rng, 64, 8, 16)
    index = make_index(ndim=16, metric="ip", dtype="f32")
    index.add(np.arange(len(pts)), pts)
    index.optimize(n_partitions=8)
    victim = pts[7].copy()
    index.remove(7)
    new_vec = unit_blobs(np.random.default_rng(21), 1, 1, 16)[0]
    assert index.add(999, new_vec) == 999 and not index._ivf_dirty
    assert 7 not in index.search(victim, 5).keys.tolist()
    m = index.search(new_vec, 5)
    assert m.keys[0] == 999 and m.keys.tolist().count(999) == 1


def test_fresh_threshold_and_mutations_make_the_ivf_dirty():
    rng = np.random.default_rng(22)
    pts = unit_blobs(rng, 16, 8, 16)
    n = len(pts)
    index = make_index(ndim=16, metric="ip", dtype="f32")
    index.add(np.arange(n), pts)
    index.optimize(n_partitions=8)
    index.add(np.arange(n, 2 * n), unit_blobs(rng, n, 1, 16, 1.0))  # 100% > 25%
    assert index._ivf_dirty
    m = index.search(pts[:4], 1)  # the flat scan serves a dirty IVF
    np.testing.assert_array_equal(m.keys[:, 0], np.arange(4))
    index.optimize(n_partitions=8)
    assert not index._ivf_dirty
    index.compact()
    assert index._ivf_dirty
    index.clear()
    assert index._ivf is None and index._ivf_dirty


def test_fresh_survives_reserve_growth():
    rng = np.random.default_rng(23)
    pts = unit_blobs(rng, 64, 8, 16)
    n = len(pts)
    index = make_index(ndim=16, metric="ip", dtype="f32")
    index.add(np.arange(n), pts)
    index.optimize(n_partitions=8, reorder=True)
    extra = unit_blobs(np.random.default_rng(24), 8, 1, 16, 1.0)
    index.add(np.arange(n, n + 8), extra)
    np.testing.assert_array_equal(index.search(extra, 1).keys[:, 0], np.arange(n, n + 8))
    index.reserve(4 * index.capacity)
    np.testing.assert_array_equal(index.search(extra, 1).keys[:, 0], np.arange(n, n + 8))


def test_plain_dense_probe_serves_what_the_kernel_does_not():
    """f16 storage, pearson and k > 128 take the block-gather probe."""
    rng = np.random.default_rng(25)
    x = blobs(rng, 100, 6, 16, 0.3)
    for dtype, metric, k in (("f16", "l2sq", 5), ("f32", "pearson", 5), ("f32", "l2sq", 129)):
        index = make_index(ndim=16, metric=metric, dtype=dtype, expansion_search=4096)
        index.add(np.arange(len(x)), x)
        index.optimize(n_partitions=6, reorder=True)
        before = probe.grouped_probe.launches
        got, exact = index.search(x[::50], k), index.search(x[::50], k, exact=True)
        np.testing.assert_array_equal(got.keys[:, 0], exact.keys[:, 0])
        np.testing.assert_allclose(got.distances, exact.distances, rtol=1e-3, atol=1e-3)
        assert probe.grouped_probe.launches == before


def test_fully_live_ip_table_probes_without_the_penalty_row(monkeypatch):
    """The all-live gate reads host-side counts: 1,024 rows fill the dense
    capacity, so the ip probe gets no penalty row; after a removal or a
    fresh add it does. Either way the search finds every member."""
    rng = np.random.default_rng(28)
    x = unit_blobs(rng, 128, 8, 16, 0.3)
    index = make_index(ndim=16, metric="ip", dtype="f32", expansion_search=64)
    index.add(np.arange(len(x)), x)
    index.optimize(n_partitions=8, reorder=True)
    assert index.capacity == len(x) == 1024
    penalties = []

    def recorder(*args):
        penalties.append(args[5])
        return probe.grouped_probe(*args)

    monkeypatch.setattr(ivf, "grouped_probe", recorder)
    np.testing.assert_array_equal(index.search(x[::40], 1).keys[:, 0], np.arange(0, len(x), 40))
    index.remove([1])
    np.testing.assert_array_equal(index.search(x[::40], 1).keys[:, 0], np.arange(0, len(x), 40))
    index.add([1], x[1:2])
    np.testing.assert_array_equal(index.search(x[1:2], 1).keys[:, 0], [1])
    assert [p is None for p in penalties] == [True, False, False]


def test_unported_paths_name_their_roadmap_items():
    """`cluster` and `join` (A.9) are ported: on an index with a built IVF
    the cluster count holds its bounds and a self-join matches every key
    to itself through the probes."""
    index = make_index(ndim=4, metric="l2sq", dtype="f32")
    index.add(None, np.random.default_rng(26).standard_normal((420, 4)).astype(np.float32))
    index.optimize(n_partitions=8, reorder=True)
    index.expansion_search = 1024
    _, sizes = index.cluster(min_count=5, max_count=9).centroids_popularity
    assert 5 <= len(sizes) <= 9 and sizes.sum() == 420
    assert index.join(index, max_proposals=4) == {k: k for k in range(420)}


def test_probe_query_chunks_concatenate_exactly(monkeypatch):
    """Batches over PROBE_QCHUNK run as several probes; each query's result
    depends on its own windows only, so the results are the same."""
    rng = np.random.default_rng(27)
    x = unit_blobs(rng, 100, 8, 32, 0.3)
    index = make_index(ndim=32, metric="cos", dtype="bf16", expansion_search=32)
    index.add(None, x)
    index.optimize(n_partitions=8, reorder=True, spill=0.1)
    whole = index.search(x[:64], 10)
    monkeypatch.setattr(ivf, "PROBE_QCHUNK", 16)
    split = index.search(x[:64], 10)
    np.testing.assert_array_equal(split.keys, whole.keys)
    np.testing.assert_array_equal(split.distances, whole.distances)
