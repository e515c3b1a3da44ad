"""usearch_torch persistence on the CPU: the cases of tests/test_persist.py
that do not stream, on the port, and files crossing between the packages
both ways.

A file written by either package is loaded by both; the two loaded indexes
answer the same queries with the same keys, distances within the IVF parity
tolerances of tests/test_torch_ivf.py (i8 ip/l2sq bit for bit), and, unless
the writer was spilled, as the writer does. Spill shadows are not live, so
neither package saves them: a spilled index loads without its shadows, in
both. The JAX index searches through its Pallas kernels (interpret mode).
"""

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import usearch_tpu  # noqa: E402
from usearch_tpu import exact as jexact  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import persist  # noqa: E402

RTOL = 1e-5


@pytest.fixture
def pallas_backend():
    jexact.set_kernel_backend("pallas")
    try:
        yield
    finally:
        jexact.set_kernel_backend("auto")


def Index(**kwargs):
    return usearch_torch.Index(device="cpu", **kwargs)


def restore(source, **kwargs):
    return usearch_torch.Index.restore(source, device="cpu", **kwargs)


def assert_same(got, want, dtype, metric):
    """Distances bit for bit for i8 ip/l2sq and b1, else within the parity
    tolerance; keys equal, apart from ties (b1's integer distances) and
    near ties (floats)."""
    np.testing.assert_array_equal(got.counts, want.counts)
    if dtype == "i8" and metric != "cos":
        np.testing.assert_array_equal(got.keys, want.keys)
        np.testing.assert_array_equal(got.distances, want.distances)
        return
    atol = 0.0 if dtype == "b1" else 1e-5
    np.testing.assert_allclose(got.distances, want.distances, rtol=0.0 if dtype == "b1" else RTOL, atol=atol)
    for row, col in zip(*np.nonzero(got.keys != want.keys)):
        near = np.abs(want.distances[row] - got.distances[row, col]) <= RTOL * abs(got.distances[row, col]) + atol
        assert got.keys[row, col] in want.keys[row][near] or near[-1], (row, col)


# ---------------------------------------------------------------------------
# tests/test_persist.py's cases, on the port
# ---------------------------------------------------------------------------


def test_metadata_on_garbage(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"definitely not an index file" * 10)
    assert usearch_torch.Index.metadata(str(p)) is None
    assert restore(str(p)) is None


def test_metadata_on_truncated(tmp_path):
    index = Index(ndim=8, dtype="f32")
    index.add(np.arange(5), np.random.default_rng(0).random((5, 8)).astype(np.float32))
    p = tmp_path / "trunc.usearch"
    index.save(str(p))
    p.write_bytes(p.read_bytes()[:10])  # cut inside the magic and header
    assert usearch_torch.Index.metadata(str(p)) is None


def test_save_empty_index_roundtrip(tmp_path):
    index = Index(ndim=8, metric="l2sq", dtype="f32")
    p = str(tmp_path / "empty.usearch")
    index.save(p)
    loaded = restore(p)
    assert len(loaded) == 0 and loaded.ndim == 8
    loaded.add(1, np.ones(8, np.float32))
    assert loaded.search(np.ones(8, np.float32), 1).keys[0] == 1
    viewed = restore(p, view=True)
    assert len(viewed) == 0


def test_multi_flag_round_trip(tmp_path):
    index = Index(ndim=4, multi=True)
    index.add(np.array([9, 9, 10]), np.random.default_rng(1).random((3, 4)).astype(np.float32))
    p = str(tmp_path / "multi.usearch")
    index.save(p)
    loaded = restore(p)
    assert loaded.multi and loaded.count(9) == 2 and loaded.count(10) == 1


def test_save_after_remove_compacts_file(tmp_path):
    """Saved files hold only live rows."""
    index = Index(ndim=8, dtype="f32")
    vecs = np.random.default_rng(2).random((10, 8)).astype(np.float32)
    index.add(np.arange(10), vecs)
    p_full, p_half = tmp_path / "full.usearch", tmp_path / "half.usearch"
    index.save(str(p_full))
    index.remove(np.arange(5))
    index.save(str(p_half))
    assert p_half.stat().st_size < p_full.stat().st_size
    loaded = restore(str(p_half))
    assert len(loaded) == 5 and not loaded.contains(0) and loaded.contains(7)
    np.testing.assert_array_equal(loaded.get(np.arange(5, 10)), vecs[5:])


def clustered(rng, n_per=120, centers=6, ndim=16, spread=0.2):
    return np.concatenate([c + rng.standard_normal((n_per, ndim)).astype(np.float32) * spread
                           for c in rng.standard_normal((centers, ndim)).astype(np.float32) * 3])


def test_ivf_structure_survives_save_load_view(tmp_path):
    """`optimize(reorder=True)` and save: the dense IVF rides the file, so
    load, view and a buffer serve it with no new k-means fit."""
    x = clustered(np.random.default_rng(3))
    index = Index(ndim=16, metric="l2sq", dtype="f32")
    index.add(np.arange(len(x), dtype=np.uint64), x)
    index.optimize(n_partitions=8, reorder=True)
    want = index.search(x[::100], 5)
    buf = index.save()  # no path yet: the bytes
    path = str(tmp_path / "ivf.usearch")
    index.save(path)
    assert index.specs["Loaded"] == path

    for loaded in (restore(path), restore(path, view=True), restore(buf)):
        assert loaded._ivf is not None and not loaded._ivf_dirty
        assert loaded._ivf.inplace_shape == index._ivf.inplace_shape
        got = loaded.search(x[::100], 5)
        np.testing.assert_array_equal(got.keys, want.keys)
        np.testing.assert_array_equal(got.distances, want.distances)

    # an add after the load joins the fresh list; the structure keeps serving
    loaded = restore(path)
    loaded.add(99999, x[0] + 10)
    assert not loaded._ivf_dirty and loaded._ivf.fresh_np.size == 1
    assert loaded.search(x[0] + 10, 1).keys[0] == 99999

    # the copied layout is not saved
    plain = Index(ndim=16, metric="l2sq", dtype="f32")
    plain.add(np.arange(50, dtype=np.uint64), x[:50])
    plain.optimize(n_partitions=4)
    again = restore(plain.save())
    assert again._ivf is None
    np.testing.assert_array_equal(again.search(x[:2], 3).keys[:, 0], [0, 1])


def test_serialized_length_exact():
    rng = np.random.default_rng(4)
    ix = Index(ndim=16, metric="l2sq", dtype="f32")
    assert ix.serialized_length == len(ix.save())
    ix.add(None, rng.standard_normal((300, 16)).astype(np.float32))
    assert ix.serialized_length == len(persist.save_index_to_buffer(ix))
    ix.optimize(n_partitions=8, reorder=True)
    ix.add(None, rng.standard_normal((20, 16)).astype(np.float32))  # fresh slots ride the payload
    assert ix._ivf.fresh_np.size == 20
    assert ix.serialized_length == len(persist.save_index_to_buffer(ix))


def test_inplace_ivf_persists_through_removals():
    """Saving compacts the holes of `remove`; the IVF's starts and lens are
    remapped into the compacted positions."""
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((4096, 32)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ix = Index(ndim=32, metric="ip", dtype="f32")
    ix.add(np.arange(4096, dtype=np.uint64), vecs)
    ix.optimize(n_partitions=64, reorder=True)
    ix.remove(np.arange(100, 200, dtype=np.uint64))
    assert ix._ivf is not None and not ix._ivf_dirty
    assert ix.serialized_length == len(persist.save_index_to_buffer(ix))
    before = ix.search(vecs[:32], 10)
    restored = restore(persist.save_index_to_buffer(ix))
    assert restored._ivf is not None and not restored._ivf_dirty
    after = restored.search(vecs[:32], 10)
    np.testing.assert_array_equal(before.keys, after.keys)
    np.testing.assert_allclose(before.distances, after.distances, atol=1e-5)


def test_viewed_index_refuses_changes_and_streaming(tmp_path):
    """A view is immutable, streamed or not; a streamed view keeps its rows
    in the file's map and serves them."""
    index = Index(ndim=8, metric="l2sq", dtype="f32")
    index.add(np.arange(10), np.random.default_rng(6).random((10, 8)).astype(np.float32))
    p = str(tmp_path / "v.usearch")
    index.save(p)
    viewed = usearch_torch.Index(ndim=8, metric="l2sq", dtype="f32", path=p, view=True, device="cpu")
    assert len(viewed) == 10 and viewed._viewed
    for change in (lambda: viewed.add(11, np.ones(8, np.float32)), lambda: viewed.remove(1),
                   lambda: viewed.rename(1, 12), viewed.compact):
        with pytest.raises(RuntimeError, match="immutable viewed index"):
            change()
    other = Index(ndim=8, metric="l2sq", dtype="f32")
    other.view(p, stream=True)
    assert len(other) == 10 and other._viewed and other._streamed and other._table is None
    streamed = restore(p, view=True, stream=True)
    assert streamed._streamed and streamed._table is None
    q = np.asarray(index.get(np.arange(3)))
    np.testing.assert_array_equal(streamed.search(q, 1).keys[:, 0], np.arange(3))
    for change in (lambda: streamed.add(11, np.ones(8, np.float32)), lambda: streamed.remove(1),
                   lambda: streamed.rename(1, 12), streamed.compact):
        with pytest.raises(RuntimeError, match="immutable viewed index"):
            change()
    assert len(usearch_torch.Index(ndim=8, metric="l2sq", dtype="f32", path=p, device="cpu")) == 10


# ---------------------------------------------------------------------------
# The upstream format
# ---------------------------------------------------------------------------


def write_reference_file(path, keys, rows, metric_ch, scalar_code, ndim, deleted=(), connectivity=16,
                         connectivity_base=32, dims64=False):
    """An upstream `.usearch` file by its documented layout
    (index_dense.hpp:995-1062, index.hpp:3277-3317), as tests/test_persist.py
    writes it."""
    rows = np.ascontiguousarray(rows)
    n, cols = rows.shape[0], rows.shape[1] * rows.itemsize
    buf = bytearray(struct.pack("<QQ" if dims64 else "<II", n, cols))
    buf += rows.tobytes()
    head = bytearray(64)
    head[:7] = b"usearch"
    struct.pack_into("<HHH", head, 7, 2, 21, 0)
    head[13], head[14], head[15], head[16] = ord(metric_ch), scalar_code, 14, 15
    struct.pack_into("<QQQ", head, 17, n - len(deleted), len(deleted), ndim)
    buf += head
    buf += struct.pack("<QQQQQ", n, connectivity, connectivity_base, 1, 0)
    levels = np.zeros(n, np.int16)
    levels[0] = 1  # one node with an upper level: the tape strides
    buf += levels.tobytes()
    base_b, upper_b = connectivity_base * 4 + 4, connectivity * 4 + 4
    for i in range(n):
        buf += struct.pack("<Qh", (1 << 64) - 1 if i in deleted else int(keys[i]), int(levels[i]))
        buf += b"\0" * (base_b + int(levels[i]) * upper_b)
    with open(path, "wb") as f:
        f.write(bytes(buf))


@pytest.mark.parametrize("dims64", [False, True])
def test_reference_format_import(tmp_path, dims64):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 32)).astype(np.float32)
    p = str(tmp_path / "ref.usearch")
    write_reference_file(p, np.arange(100, 300, dtype=np.uint64), x, "e", 11, 32, deleted={5, 7}, dims64=dims64)
    meta = usearch_torch.Index.metadata(p)
    assert meta["format"] == "reference" and meta["dtype"] == "f32" and meta["metric"] == "l2sq"
    assert meta["dimensions"] == 32 and meta["count_deleted"] == 2
    ix = restore(p)
    assert len(ix) == 198 and 105 not in ix and 107 not in ix and 109 in ix
    assert int(ix.search(x[20], 3, exact=True).keys[0]) == 120
    np.testing.assert_allclose(ix.get(np.uint64(150)), x[50], rtol=1e-5, atol=1e-5)


def test_reference_format_import_i8(tmp_path):
    rng = np.random.default_rng(1)
    xi8 = rng.integers(-127, 128, (64, 16)).astype(np.int8)
    p = str(tmp_path / "ref8.usearch")
    write_reference_file(p, np.arange(64, dtype=np.uint64), xi8, "c", 23, 16)
    ix = restore(p)
    assert len(ix) == 64
    stored = ix._table[ix._keymap.slots_of(3)[0], :16].numpy()
    np.testing.assert_array_equal(stored, xi8[3])  # imported untouched, no re-quantizing


def test_reference_format_export_roundtrip(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((150, 24)).astype(np.float32)
    ix = Index(ndim=24, metric="l2sq", dtype="f32")
    ix.add(np.arange(1000, 1150, dtype=np.uint64), x)
    ix.remove(np.uint64(1003))
    p = str(tmp_path / "export.usearch")
    ix.save(p, format="reference")
    meta = usearch_torch.Index.metadata(p)
    assert meta["format"] == "reference" and meta["count_present"] == 149 and meta["dimensions"] == 24
    back = restore(p)
    assert len(back) == 149 and 1003 not in back and 1004 in back
    np.testing.assert_allclose(back.get(np.uint64(1010)), x[10], rtol=1e-5, atol=1e-5)
    assert ix.save(format="reference") == open(p, "rb").read()
    # the JAX package reads the port's export
    jback = usearch_tpu.Index.restore(p)
    assert len(jback) == 149
    np.testing.assert_array_equal(np.asarray(jback.get(np.uint64(1010))), back.get(np.uint64(1010)))


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def flat_rows(dtype, rng, n=600, ndim=40):
    if dtype == "b1":
        return np.packbits(rng.integers(0, 2, (n, ndim)).astype(np.uint8), axis=1)
    if dtype == "i8":  # stored verbatim by both: no quantizer in the way
        return rng.integers(-100, 101, (n, ndim)).astype(np.int8)
    x = clustered(rng, n_per=n // 6, ndim=ndim, spread=0.5)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def loaded_by_both(path):
    return restore(path), usearch_tpu.Index.restore(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype,metric", [("f32", "l2sq"), ("bf16", "cos"), ("i8", "ip"), ("b1", "hamming")])
def test_flat_files_cross_packages(pallas_backend, tmp_path, writer, dtype, metric):
    rng = np.random.default_rng(8)
    x = flat_rows(dtype, rng)
    ndim = 40
    keys = np.arange(len(x), dtype=np.uint64) * 3 + 7
    make = usearch_tpu.Index if writer == "jax" else Index
    w = make(ndim=ndim, metric=metric, dtype=dtype)
    w.add(keys, x)
    w.remove(keys[::9])
    p = str(tmp_path / f"{writer}.usearch")
    w.save(p)
    port, ref = loaded_by_both(p)
    assert len(port) == len(ref) == len(w)
    q = x[rng.choice(len(x), 24, replace=False)]
    want = w.search(q, 5, exact=True)
    for loaded in (port, ref):
        assert_same(loaded.search(q, 5, exact=True), want, dtype, metric)
    live = keys[1:9]
    got = port.get(live, "b1") if dtype == "b1" else port.get(live)
    np.testing.assert_array_equal(got, np.asarray(ref.get(live, "b1") if dtype == "b1" else ref.get(live)))


def ivf_writer(make, dtype, metric, spill, rng):
    """An index built by ``make`` with a reordered IVF, then 20 removals
    and 12 fresh rows; returns it with its queries."""
    x = flat_rows(dtype, rng, n=600, ndim=64)
    n = len(x)
    w = make(ndim=64, metric=metric, dtype=dtype, expansion_search=24)
    keys = np.arange(n, dtype=np.uint64) + 100
    w.add(keys, x)
    w.optimize(n_partitions=8, reorder=True, spill=spill)
    w.remove(keys[rng.choice(n, 20, replace=False)])
    extra = flat_rows(dtype, np.random.default_rng(9), n=12, ndim=64)
    w.add(np.arange(12, dtype=np.uint64) + 5000, extra)
    assert not w._ivf_dirty and w._ivf.fresh_np.size == 12
    return w, np.concatenate([x[rng.choice(n, 18, replace=False)], extra[:6]])


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype,metric,spill", [("i8", "ip", 0.0), ("f32", "l2sq", 0.0), ("i8", "l2sq", 0.1)])
def test_ivf_files_cross_packages(pallas_backend, tmp_path, writer, dtype, metric, spill):
    rng = np.random.default_rng(10)
    w, q = ivf_writer(usearch_tpu.Index if writer == "jax" else Index, dtype, metric, spill, rng)
    assert bool(w._ivf.shadow_np_pos.size) == (spill > 0)
    p = str(tmp_path / f"{writer}.usearch")
    w.save(p)
    port, ref = loaded_by_both(p)
    for loaded in (port, ref):
        assert loaded._ivf is not None and not loaded._ivf_dirty and loaded._ivf.fresh_np.size == 12
        assert loaded._ivf.shadow_np_pos.size == 0 and not loaded._ivf.spilled  # the shadows stay behind
        np.testing.assert_array_equal(loaded._ivf.fresh_np, port._ivf.fresh_np)
    np.testing.assert_array_equal(np.asarray(ref._ivf.starts), port._ivf.starts.numpy())
    np.testing.assert_array_equal(np.asarray(ref._ivf.lens), port._ivf.lens.numpy())
    got = port.search(q, 10)
    assert_same(got, ref.search(q, 10), dtype, metric)
    if not spill:
        assert_same(got, w.search(q, 10), dtype, metric)
    # each package's own save: its library_version tells them apart
    assert w.serialized_length == len(open(p, "rb").read())
    assert port.serialized_length == len(persist.save_index_to_buffer(port))
