"""usearch_torch's `ShardedIndex` on the CPU against the JAX package's, the
cases of tests/test_sharded.py on both packages: the port on
``make_mesh(8, device="cpu")`` (8 shards on the CPU), the JAX package on
the conftest's 8 virtual CPU devices, the same data from numpy seeds.

Exact searches give equal keys and distances within 1e-5 (and 1e-5
relative: f32 sums in another order, as tests/test_torch_persist.py holds
them); the same adds
and removals put the same keys in the same slots. For the IVF, the JAX
layout carried across (`convert.sharded_from_arrays`) searched through the
plain core (``ivf.PROBE_MODE = "xla"``) gives JAX's keys, distances within
1e-3; through B3's plain version (the default) full probes equal the exact
search and bounded ones recall no more than 0.01 below JAX's; the port's
own `optimize` probes fully as it scans; directories cross both ways.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import usearch_tpu  # noqa: E402
from usearch_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from usearch_tpu.parallel.sharded import ShardedIndex as JaxSharded  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import ivf  # noqa: E402
from usearch_torch.convert import sharded_from_arrays  # noqa: E402
from usearch_torch.parallel.mesh import make_mesh  # noqa: E402
from usearch_torch.parallel.sharded import ShardedIndex  # noqa: E402

ATOL = 1e-5
RTOL = 1e-5
IVF_ATOL = 1e-3


def mesh():
    return make_mesh(8, device="cpu")


def jax_state(j) -> dict:
    """A JAX `ShardedIndex`'s state as numpy, its IVF included."""
    state = dict(table=np.asarray(j._table), stats=np.asarray(j._stats), valid=np.asarray(j._valid),
                 keys=np.asarray(j._keys), metric=j.metric.value, kind=j.kind.value, ndim=j.ndim)
    if j._ivf is not None:
        state["ivf"] = {name: np.asarray(v) if hasattr(v, "shape") else v for name, v in j._ivf.items()}
    return state


def slots_of(index) -> tuple:
    """(keys, live mask) of every slot: the port's host copies, or the JAX
    index's keys and mask."""
    if isinstance(index, ShardedIndex):
        return index._keys, index._live
    return np.asarray(index._keys), np.asarray(index._valid)


def assert_same(got, want, atol=ATOL):
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_allclose(got.distances, want.distances, rtol=RTOL, atol=atol)


def recall(got, want, k: int) -> float:
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(got.keys.tolist(), want.keys.tolist())]))


def blobs(seed: int, n_centers: int, per: int, ndim: int):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, ndim)).astype(np.float32) * 3
    data = np.concatenate([c + rng.standard_normal((per, ndim)).astype(np.float32) * 0.3 for c in centers])
    return data, rng


def test_mesh_shape_and_devices():
    m = mesh()
    assert m.shape == {"shard": 8} and list(m.shard_ids) == list(range(8))
    assert all(d.type == "cpu" for d in m.devices) and m.group is None


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_exact_matches_jax(metric):
    rng = np.random.default_rng(42)
    data = rng.standard_normal((1000, 32)).astype(np.float32)
    queries = rng.standard_normal((17, 32)).astype(np.float32)
    port = ShardedIndex.build(data, metric=metric, mesh=mesh())
    want = JaxSharded.build(data, metric=metric, mesh=jax_mesh())
    assert len(port) == len(want) == 1000
    got = port.search(queries, 10)
    assert_same(got, want.search(queries, 10))
    exact = usearch_torch.exact_search(data, queries, 10, metric=metric, device="cpu")
    np.testing.assert_array_equal(got.keys, exact.keys)


def test_from_index_matches_jax():
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    keys = np.arange(200, dtype=np.uint64) + 1000
    port_index = usearch_torch.Index(ndim=16, metric="l2sq", dtype="f32", device="cpu")
    jax_index = usearch_tpu.Index(ndim=16, metric="l2sq", dtype="f32")
    for index in (port_index, jax_index):
        index.add(keys, vecs)
        index.remove(1005)
    port = ShardedIndex.from_index(port_index, mesh())
    want = JaxSharded.from_index(jax_index, jax_mesh())
    assert len(port) == 199
    got = port.search(vecs[:5], 3)
    assert_same(got, want.search(vecs[:5], 3))
    np.testing.assert_array_equal(got.keys[:, 0], keys[:5])
    assert 1005 not in port.search(vecs[5], 5).keys
    np.testing.assert_array_equal(slots_of(port)[0], slots_of(want)[0])


def test_mount_matches_jax(tmp_path):
    """Index files of both packages mounted as one pool by each."""
    rng = np.random.default_rng(2)
    paths, all_vecs = [], []
    for s in range(3):
        vecs = rng.standard_normal((50, 8)).astype(np.float32)
        cls = usearch_tpu.Index if s % 2 else usearch_torch.Index
        index = cls(ndim=8, metric="cos", dtype="f32", **({} if s % 2 else {"device": "cpu"}))
        index.add(np.arange(50, dtype=np.uint64) + s * 1000, vecs)
        paths.append(str(tmp_path / f"shard{s}.usearch"))
        index.save(paths[-1])
        all_vecs.append(vecs)
    port = ShardedIndex.mount(paths, mesh=mesh())
    want = JaxSharded.mount(paths, mesh=jax_mesh())
    assert len(port) == 150
    got = port.search(all_vecs[2][:4], 1)
    np.testing.assert_array_equal(got.keys[:, 0], np.arange(4, dtype=np.uint64) + 2000)
    assert_same(port.search(all_vecs[1], 5), want.search(all_vecs[1], 5))


def test_binary_hamming_matches_jax():
    rng = np.random.default_rng(3)
    packed = np.packbits((rng.random((120, 128)) > 0.5).astype(np.uint8), axis=1)
    port = ShardedIndex.build(packed, metric="hamming", mesh=mesh())
    want = JaxSharded.build(packed, metric="hamming", mesh=jax_mesh())
    got = port.search(packed[:5], 1)
    np.testing.assert_array_equal(got.keys[:, 0], np.arange(5))
    assert np.all(got.distances[:, 0] == 0)
    m, w = port.search(packed[:9], 4), want.search(packed[:9], 4)
    np.testing.assert_array_equal(m.distances, w.distances)
    np.testing.assert_array_equal(m.counts, w.counts)


def test_empty_and_tiny():
    rng = np.random.default_rng(4)
    empty = ShardedIndex.build(np.zeros((0, 8), np.float32), mesh=mesh())
    assert len(empty) == 0
    assert all(c == 0 for c in empty.search(rng.standard_normal((2, 8)).astype(np.float32), 3).counts)
    tiny_rows = rng.standard_normal((3, 8)).astype(np.float32)
    q = rng.standard_normal((1, 8)).astype(np.float32)
    tiny = ShardedIndex.build(tiny_rows, mesh=mesh())
    assert int(tiny.search(q, 5).counts[0]) == 3
    assert_same(tiny.search(q, 5), JaxSharded.build(tiny_rows, mesh=jax_mesh()).search(q, 5))


def test_add_remove_sequence_matches_jax():
    """The same adds and removals on both packages: the same keys in the
    same slots, the same searches, a grown pool included."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((512, 32)).astype(np.float32)
    port = ShardedIndex.build(base, metric="ip", mesh=mesh())
    want = JaxSharded.build(base, metric="ip", mesh=jax_mesh())
    extra = rng.standard_normal((64, 32)).astype(np.float32)
    extra_keys = np.arange(64, dtype=np.uint64) + 1000
    more = rng.standard_normal((700, 32)).astype(np.float32)
    for index in (port, want):
        index.add(extra_keys, extra)
        assert index.remove(extra_keys[:16]) == 16
        assert index.remove([999999]) == 0
        index.add(None, more[:40])
        index.add(None, more[40:])  # past the free slots: every shard grows
    assert len(port) == len(want) == 512 + 48 + 700
    for a, b in zip(slots_of(port), slots_of(want)):
        np.testing.assert_array_equal(a, b)
    assert port.contains(1020) and not port.contains(1000)
    got = port.search(extra[:32], 1)
    assert not set(got.keys[:, 0].tolist()) & set(extra_keys[:16].tolist())
    assert_same(got, want.search(extra[:32], 1))


def test_reserve_keeps_ivf():
    rng = np.random.default_rng(6)
    base = rng.standard_normal((1024, 32)).astype(np.float32)
    want = JaxSharded.build(base, metric="ip", mesh=jax_mesh())
    want.optimize(n_partitions=8)
    port = sharded_from_arrays(jax_state(want), mesh())
    for index in (port, want):
        index.reserve(4096)
        assert index._ivf is not None
    for a, b in zip(slots_of(port), slots_of(want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.search(base[:8], 1).keys[:, 0], np.arange(8))
    own = ShardedIndex.build(base, metric="ip", mesh=mesh())
    own.optimize(n_partitions=8)
    own.reserve(4096)
    assert own._ivf is not None
    np.testing.assert_array_equal(own.search(base[:8], 1).keys[:, 0], np.arange(8))


def test_add_after_optimize_scans_exactly():
    rng = np.random.default_rng(7)
    base = rng.standard_normal((1024, 32)).astype(np.float32)
    pool = ShardedIndex.build(base, metric="ip", mesh=mesh())
    pool.optimize(n_partitions=8)
    extra = rng.standard_normal((8, 32)).astype(np.float32)
    keys = np.arange(8, dtype=np.uint64) + 5000
    pool.add(keys, extra)
    assert pool._ivf is None
    np.testing.assert_array_equal(pool.search(extra, 1).keys[:, 0], keys)
    pool.optimize(n_partitions=8)
    np.testing.assert_array_equal(pool.search(extra, 1).keys[:, 0], keys)


# -- the IVF -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ivf():
    """Per metric: the JAX pool of 8 blobs after `optimize(4)` per shard,
    its queries (23 members) and its answers at full and bounded probes."""
    out = {}
    for metric in ("cos", "ip", "l2sq"):
        data, rng = blobs(8, 8, 150, 32)
        keys = np.arange(data.shape[0], dtype=np.uint64) * 7 + 3
        queries = data[rng.choice(data.shape[0], 23, replace=False)]
        pool = JaxSharded.build(data, keys, metric=metric, mesh=jax_mesh())
        pool.optimize(n_partitions=4)
        out[metric] = dict(pool=pool, data=data, keys=keys, queries=queries, exact=pool.search(queries, 9, exact=True),
                           full=pool.search(queries, 9, expansion_search=100000),
                           bounded=pool.search(queries, 9, expansion_search=4))
    return out


@pytest.fixture
def xla_mode(monkeypatch):
    monkeypatch.setattr(ivf, "PROBE_MODE", "xla")


@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq"])
def test_carried_ivf_xla_matches_jax(jax_ivf, xla_mode, metric):
    run = jax_ivf[metric]
    port = sharded_from_arrays(jax_state(run["pool"]), mesh())
    assert port.nprobe_for(4) == run["pool"].nprobe_for(4)
    assert_same(port.search(run["queries"], 9, expansion_search=100000), run["full"], IVF_ATOL)
    assert_same(port.search(run["queries"], 9, expansion_search=4), run["bounded"], IVF_ATOL)
    assert_same(port.search(run["queries"], 9, exact=True), run["exact"], IVF_ATOL)


@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq"])
def test_carried_ivf_grouped(jax_ivf, metric, monkeypatch):
    """B3's plain version: full probes equal the exact search, bounded ones
    recall@10 within 0.01 of JAX's on the same layout."""
    run = jax_ivf[metric]
    port = sharded_from_arrays(jax_state(run["pool"]), mesh())
    calls = []
    plain = ivf.grouped_probe

    def counted(*args):
        calls.append(args[0])
        return plain(*args)

    monkeypatch.setattr(ivf, "grouped_probe", counted)
    full = port.search(run["queries"], 9, expansion_search=100000)
    bounded = port.search(run["queries"], 10, expansion_search=4)
    monkeypatch.undo()
    assert len(calls) == 16  # one probe per shard and search
    assert_same(full, port.search(run["queries"], 9, exact=True), IVF_ATOL)
    exact10 = port.search(run["queries"], 10, exact=True)
    want10 = run["pool"].search(run["queries"], 10, expansion_search=4)
    assert recall(bounded, exact10, 10) >= recall(want10, exact10, 10) - 0.01


@pytest.mark.parametrize("metric", ["cos", "ip", "l2sq"])
def test_own_optimize_full_probe_equals_exact(metric):
    data, rng = blobs(9, 8, 150, 32)
    keys = np.arange(data.shape[0], dtype=np.uint64) * 7 + 3
    queries = data[rng.choice(data.shape[0], 23, replace=False)]
    pool = ShardedIndex.build(data, keys, metric=metric, mesh=mesh())
    pool.optimize(n_partitions=4)
    assert pool._ivf is not None and len(pool) == data.shape[0]
    want = pool.search(queries, 9, exact=True)
    assert_same(pool.search(queries, 9, expansion_search=100000), want, IVF_ATOL)
    np.testing.assert_array_equal(pool.search(queries, 1, expansion_search=64).keys[:, 0], want.keys[:, 0])


def test_directories_cross_both_ways(jax_ivf, tmp_path):
    """A directory saved by either package loads in the other, with its
    IVF, and searches as the saved index does."""
    run = jax_ivf["l2sq"]
    q = run["queries"]
    run["pool"].save(str(tmp_path / "jax"))
    from_jax = ShardedIndex.load(str(tmp_path / "jax"), mesh=mesh())
    assert from_jax._ivf is not None
    carried = sharded_from_arrays(jax_state(run["pool"]), mesh())
    # the carried index keeps the JAX package's row stats, the loaded one computes its own
    assert_same(from_jax.search(q, 5, expansion_search=100000), carried.search(q, 5, expansion_search=100000),
                IVF_ATOL)

    port = ShardedIndex.build(run["data"], run["keys"], metric="l2sq", mesh=mesh())
    port.optimize(n_partitions=3)
    port.remove(run["keys"][:10])  # removed after the build: the windows are compacted on save
    port.save(str(tmp_path / "port"))
    with open(tmp_path / "port" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["format"] == "usearch_tpu.sharded" and manifest["count"] == len(port)
    assert set(manifest["ivf"]) == {"p_win", "block", "c_max", "avg_rows"}
    assert len(usearch_tpu.Index.restore(os.path.join(tmp_path / "port", manifest["shards"][0]))) > 0
    want = port.search(q, 5, expansion_search=100000)
    reloaded = ShardedIndex.load(str(tmp_path / "port"), mesh=mesh())
    assert_same(reloaded.search(q, 5, expansion_search=100000), want, IVF_ATOL)
    in_jax = JaxSharded.load(str(tmp_path / "port"), mesh=jax_mesh())
    assert in_jax._ivf is not None
    assert_same(in_jax.search(q, 5, expansion_search=100000), want, IVF_ATOL)
    narrow = ShardedIndex.load(str(tmp_path / "port"), mesh=make_mesh(3, device="cpu"))
    assert narrow._ivf is None and narrow._per == 400
    assert_same(narrow.search(q, 5), port.search(q, 5, exact=True))


def test_interleave_takes_a_step_of_each_in_turn():
    from usearch_torch.parallel.sharded import _interleave

    seen = []

    def steps(name, n):
        for i in range(n):
            seen.append((name, i))
            yield
        return name

    assert _interleave([steps("a", 3), steps("b", 1), steps("c", 2)]) == ["a", "b", "c"]
    assert seen == [("a", 0), ("b", 0), ("c", 0), ("a", 1), ("c", 1), ("a", 2)]


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_exact_b2_shards_match_jax(metric, monkeypatch):
    """Shards of 1,536 rows take B2 and the rescore (their plain versions
    here), their steps interleaved: keys equal to the JAX pool's, distances within an
    atol of 1e-6 x the largest q_sq + t_sq (B2's l2sq is q_sq + t_sq - 2
    dot, which cancels near a query's own row, as tests/test_torch_fused_edges.py
    holds it), and the same bits whatever the rescore's chunk."""
    from usearch_torch.ops import scan

    rng = np.random.default_rng(12)
    data = rng.standard_normal((8 * 1536, 32)).astype(np.float32)
    queries = data[rng.choice(data.shape[0], 16, replace=False)] + 0.01
    port = ShardedIndex.build(data, metric=metric, mesh=mesh())
    whole = port.search(queries, 10, exact=True)
    plain = scan.binned_minima_plain
    calls = []
    monkeypatch.setattr(scan, "_RESCORE_BUDGET", 8 * 8 * 128 * (32 * 4 + 8))  # 8 queries a chunk: 2 chunks
    monkeypatch.setattr(scan, "binned_minima_plain", lambda *a: (calls.append(a[2].shape[0]), plain(*a))[1])
    got = port.search(queries, 10, exact=True)
    assert calls == [1536] * 8
    np.testing.assert_array_equal(got.keys, whole.keys)
    np.testing.assert_array_equal(got.distances, whole.distances)
    sq = np.square(np.concatenate([data, queries])).sum(axis=1)
    assert_same(got, JaxSharded.build(data, metric=metric, mesh=jax_mesh()).search(queries, 10), 2e-6 * sq.max())


def test_make_mesh_takes_the_group_of_its_backend(monkeypatch):
    """Inside a gloo group a CPU mesh merges over it; where the default
    group's backend does not serve the mesh's device (NCCL and the CPU), the
    mesh stays within the process."""
    import socket

    import torch.distributed as dist

    from usearch_torch.parallel.mesh import distributed_initialize

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed_initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=1, process_id=0, device="cpu")
    try:
        assert make_mesh(2, device="cpu").group is dist.group.WORLD
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        local = make_mesh(2, device="cpu")
        assert local.group is None and local.world_size == 1 and local.shape == {"shard": 2}
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
