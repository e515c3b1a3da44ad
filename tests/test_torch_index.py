"""usearch_torch.Index behaviours on the CPU: the cases of tests/test_index.py
that the flat index covers, run against the port."""

import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from usearch_torch import BatchMatches, Index, MetricKind, ScalarKind, exact_search  # noqa: E402
from usearch_torch.ops import scan  # noqa: E402


def make_index(**kwargs):
    return Index(device="cpu", **kwargs)


def unit_vectors(rng, n, ndim):
    x = rng.standard_normal((n, ndim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_minimal_three_vectors():
    index = make_index(ndim=4, metric="cos", dtype="f32")
    v1 = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    v2 = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    v3 = np.array([0.1, 0.1, 0.1, 0.1], np.float32)
    index.add(42, v1)
    index.add(43, v2)
    index.add(44, v3)
    assert len(index) == 3
    assert 42 in index and index.contains(43) and not index.contains(999)
    matches = index.search(v1, 3)
    assert matches.keys[0] == 42 and matches.distances[0] < 1e-5 and len(matches) == 3
    np.testing.assert_allclose(index.get(42), v1, atol=1e-6)
    assert index.get(999) is None


@pytest.mark.parametrize("ndim", [3, 97, 256])
@pytest.mark.parametrize("metric", [MetricKind.Cos, MetricKind.L2sq])
@pytest.mark.parametrize("quantization", [ScalarKind.F32, ScalarKind.F16, ScalarKind.BF16, ScalarKind.I8])
@pytest.mark.parametrize("batch_size", [1, 7, 1024])
def test_index_retrieval(ndim, metric, quantization, batch_size):
    """Stored vectors come back within the quantization's tolerance."""
    rng = np.random.default_rng(batch_size * 1000 + ndim)
    index = make_index(ndim=ndim, metric=metric, dtype=quantization)
    keys = np.arange(batch_size)
    vectors = unit_vectors(rng, batch_size, ndim)
    index.add(keys, vectors)
    np.testing.assert_allclose(np.vstack(index.get(keys)), vectors, atol=0.1)
    assert np.all(np.sort(np.array(index.keys)) == keys)


@pytest.mark.parametrize("batch_size", [1, 7, 1024])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8"])
def test_self_recall(batch_size, dtype):
    rng = np.random.default_rng(batch_size)
    index = make_index(ndim=32, metric="cos", dtype=dtype)
    vectors = unit_vectors(rng, batch_size, 32)
    index.add(np.arange(batch_size), vectors)
    m = index.search(index.get(np.arange(batch_size)), 1, exact=True)
    assert m.mean_recall(np.arange(batch_size)) == 1.0


def test_duplicate_keys_rejected():
    index = make_index(ndim=8, multi=False)
    index.add(1, np.ones(8, np.float32))
    with pytest.raises(KeyError):
        index.add(1, np.ones(8, np.float32))
    with pytest.raises(KeyError):
        make_index(ndim=8).add(np.array([5, 5]), np.random.rand(2, 8).astype(np.float32))


def test_multi_key():
    index = make_index(ndim=8, multi=True)
    v = np.random.default_rng(0).random((3, 8)).astype(np.float32)
    index.add(np.array([7, 7, 8]), v)
    assert len(index) == 3 and index.count(7) == 2 and index.count(8) == 1
    assert index.get(7).shape == (2, 8)
    assert 7 in index.search(v[0], 3).keys
    np.testing.assert_array_equal(index.count(np.array([7, 8, 9])), [2, 1, 0])


def test_remove_and_reinsert():
    index = make_index(ndim=8, dtype="f32")
    vecs = np.random.default_rng(1).random((10, 8)).astype(np.float32)
    index.add(np.arange(10), vecs)
    assert index.remove(3) == 1 and len(index) == 9 and not index.contains(3)
    assert 3 not in index.search(vecs[3], 10).keys
    cap_before = index.capacity
    index.add(100, vecs[3])  # reuses the freed slot
    assert index.capacity == cap_before and len(index) == 10
    assert index.search(vecs[3], 1).keys[0] == 100
    np.testing.assert_array_equal(index.remove(np.array([100, 5])), [1, 1])


def test_rename():
    index = make_index(ndim=8)
    index.add(1, np.ones(8, np.float32))
    assert index.rename(1, 2)
    assert not index.contains(1) and index.contains(2)
    assert index.search(np.ones(8, np.float32), 1).keys[0] == 2
    index.add(3, np.zeros(8, np.float32))
    assert not index.rename(2, 3)  # onto an existing key needs multi
    assert index.contains(2)


def test_clear_and_reset():
    rng = np.random.default_rng(2)
    index = make_index(ndim=8)
    index.add(np.arange(5), rng.random((5, 8)).astype(np.float32))
    index.clear()
    assert len(index) == 0 and index.capacity > 0
    index.add(np.arange(5), rng.random((5, 8)).astype(np.float32))
    assert len(index) == 5
    index.reset()
    assert len(index) == 0 and index.capacity == 0


def test_copy():
    index = make_index(ndim=8)
    vecs = np.random.default_rng(3).random((5, 8)).astype(np.float32)
    index.add(np.arange(5), vecs)
    clone = index.copy()
    index.remove(0)
    assert len(clone) == 5 and clone.contains(0)
    assert clone.search(vecs[0], 1).keys[0] == 0
    clone.add(9, vecs[1])
    assert not index.contains(9)


def test_compact():
    index = make_index(ndim=8, dtype="f32")
    vecs = np.random.default_rng(4).random((50, 8)).astype(np.float32)
    index.add(np.arange(50), vecs)
    index.remove(np.arange(0, 50, 2))
    before = index.search(vecs[1], 5)
    assert index.compact() == 25
    after = index.search(vecs[1], 5)
    np.testing.assert_array_equal(before.keys, after.keys)
    np.testing.assert_allclose(before.distances, after.distances, atol=1e-6)
    index.add(1000, vecs[0])
    assert index.search(vecs[0], 1).keys[0] == 1000
    index.remove(np.arange(1, 20, 2), compact=True)
    assert len(index._free_slots) == 0 and len(index) == 16


def test_filtered_search():
    index = make_index(ndim=8, dtype="f32")
    vecs = np.random.default_rng(5).random((30, 8)).astype(np.float32)
    index.add(np.arange(30), vecs)
    m = index.search(vecs[0], 5, filter=lambda key: key % 2 == 0)
    assert all(k % 2 == 0 for k in m.keys) and m.keys[0] == 0
    m = index.search(vecs[1], 5, filter=np.array([1, 3, 5]))
    assert set(m.keys).issubset({1, 3, 5}) and m.keys[0] == 1


def test_filtered_search_vectorized_and_cached():
    index = make_index(ndim=8, dtype="f32")
    vecs = np.random.default_rng(6).random((64, 8)).astype(np.float32)
    index.add(np.arange(64), vecs)
    calls = []

    def vec_pred(keys):
        calls.append(np.asarray(keys).shape)
        return np.asarray(keys) % 3 == 0

    m = index.search(vecs[0], 5, filter=vec_pred)
    assert all(k % 3 == 0 for k in m.keys)
    assert calls == [(64,)]  # one call over the whole key array
    index.search(vecs[1], 5, filter=vec_pred)
    assert len(calls) == 1  # cached
    index.remove(0)  # a mutation rebuilds the mask, deletions composed in
    m = index.search(vecs[0], 5, filter=vec_pred)
    assert len(calls) == 2 and 0 not in m.keys and all(k % 3 == 0 for k in m.keys)

    def scalar_pred(key):
        if not np.isscalar(key) and getattr(key, "ndim", 0):
            raise TypeError("scalar only")
        return key % 2 == 0

    assert all(k % 2 == 0 for k in index.search(vecs[2], 5, filter=scalar_pred).keys)


def test_search_radius():
    index = make_index(ndim=4, metric="l2sq", dtype="f32")
    index.add(np.arange(3), np.eye(3, 4, dtype=np.float32) * np.array([[1], [2], [3]]))
    assert len(index.search(np.zeros(4, np.float32), 3, radius=2.0)) == 1
    assert len(index.search(np.zeros(4, np.float32), 3, radius=math.inf)) == 3


def test_auto_keys():
    rng = np.random.default_rng(7)
    index = make_index(ndim=4)
    np.testing.assert_array_equal(index.add(None, rng.random((3, 4)).astype(np.float32)), [0, 1, 2])
    np.testing.assert_array_equal(index.add(None, rng.random((2, 4)).astype(np.float32)), [3, 4])


def test_capacity_growth():
    """1,024-row quanta, doubling on growth, powers of two above 64k."""
    index = make_index(ndim=8, dtype="i8")
    index.add(None, np.ones((1000, 8), np.float32))
    assert index.capacity == 1024
    index.add(None, np.ones((100, 8), np.float32))
    assert index.capacity == 2048
    index.reserve(70_000)
    assert index.capacity == 131072


@pytest.mark.parametrize("dtype", ["i8", "bf16", "f32", "f16"])
def test_tensor_add_matches_host(dtype):
    """Rows handed over as tensors are cast where they lie and stored as the
    host path stores numpy rows; an i8 tensor into an i8 index is kept
    verbatim."""
    rng = np.random.default_rng(8)
    vecs = rng.standard_normal((37, 24)).astype(np.float32)
    host, dev = make_index(ndim=24, metric="cos", dtype=dtype), make_index(ndim=24, metric="cos", dtype=dtype)
    host.add(np.arange(37), vecs)
    dev.add(np.arange(37), torch.from_numpy(vecs))
    assert torch.equal(host._table, dev._table) and torch.equal(host._stats, dev._stats)
    mh, md = host.search(vecs[:5], 3), dev.search(torch.from_numpy(vecs[:5]), 3)
    np.testing.assert_array_equal(mh.keys, md.keys)
    raw = rng.integers(-127, 128, (9, 16)).astype(np.int8)
    ix = make_index(ndim=16, metric="ip", dtype="i8")
    ix.add(np.arange(9), torch.from_numpy(raw))
    np.testing.assert_array_equal(ix._table[:9, :16].numpy(), raw)
    assert ix.add(100, torch.from_numpy(vecs[0, :16])) == 100
    with pytest.raises(ValueError):
        ix.add(np.arange(2), torch.zeros(2, 8))


def test_chunked_host_add(monkeypatch):
    """Big host batches go in chunks and store what one batch stores."""
    import usearch_torch.index as index_module

    vecs = np.random.default_rng(9).standard_normal((1500, 16)).astype(np.float32)
    a, b = make_index(ndim=16, dtype="i8"), make_index(ndim=16, dtype="i8")
    a.add(np.arange(1500), vecs)
    monkeypatch.setattr(index_module, "INGEST_CHUNK", 256)
    seen = []
    b.add(np.arange(1500), vecs, progress=lambda done, total: seen.append(done))
    assert torch.equal(a._table, b._table) and seen[-1] == 1500 and len(seen) == 6


def test_query_padding_and_approximate_gate():
    """Query batches pad to powers of two with copies of the first query;
    from 131,072 rows on a non-exact search takes kernel B1, below or with
    exact=True kernel B2."""
    rng = np.random.default_rng(10)
    index = make_index(ndim=32, metric="ip", dtype="i8")
    vecs = unit_vectors(rng, 131072, 32)
    index.add(None, vecs)
    calls = []
    real = scan.binned_scan_plain
    scan.binned_scan_plain = lambda *a, **k: (calls.append(a[1].shape), real(*a, **k))[1]
    try:
        m = index.search(vecs[:5], 3)
    finally:
        scan.binned_scan_plain = real
    assert calls == [(8, 128)]  # 5 queries padded to 8
    np.testing.assert_array_equal(m.keys[:, 0], np.arange(5))
    index.remove(np.arange(100))  # drops below the gate
    assert np.all(index.search(vecs[:5], 3).keys >= 100)


def test_exact_search_entry_point():
    rng = np.random.default_rng(11)
    data = rng.standard_normal((500, 20)).astype(np.float32)
    m = exact_search(data, data[:7], 4, metric="l2sq", device="cpu")
    assert isinstance(m, BatchMatches)
    np.testing.assert_array_equal(m.keys[:, 0], np.arange(7))
    assert m.computed_distances == 500 * 7


def test_unported_surface_raises():
    """Nothing is left unported: `ShardedIndex` is the multi-device index of
    `usearch_torch.parallel` (A.11), and `join`, `cluster`, a b1 index of a
    dot metric and a haversine index work since A.7b and A.9."""
    import usearch_torch
    from usearch_torch.parallel import sharded

    assert usearch_torch.ShardedIndex is sharded.ShardedIndex
    index = make_index(ndim=8, dtype="f32")
    index.add(None, np.eye(8, dtype=np.float32))
    assert index.join(index) == {k: k for k in range(8)}
    assert index.cluster(min_count=2, max_count=2).centroids_popularity[1].sum() == 8
    assert make_index(ndim=8, dtype="b1").dtype == ScalarKind.B1
    assert make_index(metric="haversine").ndim == 2


def test_concurrent_search_and_upserts():
    """Threads searching while others remove and re-add keys: the lock
    keeps every search consistent."""
    from concurrent.futures import ThreadPoolExecutor

    index = make_index(ndim=8, dtype="f32")
    base = np.random.default_rng(12).random((64, 8)).astype(np.float32)
    index.add(np.arange(64), base)

    def work(i):
        key = i % 16
        for _ in range(5):
            try:
                index.remove(key)
                index.add(key, base[key])
            except KeyError:
                pass  # another thread re-added it first
            assert len(index.search(base[key], 3)) >= 1
        return True

    with ThreadPoolExecutor(max_workers=8) as pool:
        assert all(pool.map(work, range(32)))
    assert len(index) <= 64 and len(index) == len(np.array(index.keys))


def test_rwlock_writer_waits_for_readers():
    from usearch_torch.index import _RWLock

    lock, order = _RWLock(), []
    assert lock.acquire_read()
    writer = threading.Thread(target=lambda: (lock.acquire_write(), order.append("w"), lock.release_write()))
    writer.start()
    writer.join(timeout=0.2)
    assert writer.is_alive() and order == []
    lock.release_read()
    writer.join(timeout=5)
    assert not writer.is_alive() and order == ["w"]
