"""Streamed views (`view(path, stream=True)`, usearch_torch/stream.py): the
rows stay in the file's map and a search streams them through the device in
double-buffered tiles. Held against the port's own resident
``search(exact=True)`` on the same file, and against the JAX package's
streamed search on the same file, on the CPU."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import usearch_tpu  # noqa: E402
import usearch_tpu.stream as jstream  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import persist  # noqa: E402
from usearch_torch import stream  # noqa: E402
from usearch_torch.ops import scan  # noqa: E402

RTOL = 1e-5


def Index(**kwargs):
    return usearch_torch.Index(device="cpu", **kwargs)


def restore(source, **kwargs):
    return usearch_torch.Index.restore(source, device="cpu", **kwargs)


@pytest.fixture
def tiles(monkeypatch):
    """Set the tile rows of both packages' streamed searches."""

    def set_rows(rows: int):
        monkeypatch.setattr(stream, "DEFAULT_TILE_ROWS", rows)
        monkeypatch.setattr(jstream, "DEFAULT_TILE_ROWS", rows)

    return set_rows


def assert_same(got, want, atol: float = 1e-5):
    """Distances within the float tolerance; keys equal apart from ties
    (b1's integer distances) and near ties."""
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_allclose(got.distances, want.distances, rtol=RTOL, atol=atol)
    for row, col in zip(*np.nonzero(got.keys != want.keys)):
        near = np.abs(want.distances[row] - got.distances[row, col]) <= RTOL * abs(got.distances[row, col]) + atol
        assert got.keys[row, col] in want.keys[row][near] or near[-1], (row, col)


def saved(tmp_path, name, ndim, metric, dtype, rows, keys=None):
    """A file the port wrote of ``rows`` under ``keys`` (default 0..n)."""
    ix = Index(ndim=ndim, metric=metric, dtype=dtype)
    ix.add(np.arange(len(rows), dtype=np.uint64) if keys is None else keys, rows)
    path = str(tmp_path / name)
    ix.save(path)
    return path


def test_streamed_view_serves_like_loaded(rng, tmp_path, tiles):
    """f32 l2sq over several tiles: results, filters, `get` and `contains`
    as the loaded index's; a streamed view is immutable."""
    x = rng.standard_normal((700, 16)).astype(np.float32)
    path = saved(tmp_path, "big.usearch", 16, "l2sq", "f32", x, np.arange(700, dtype=np.uint64) + 10)
    loaded = restore(path)
    viewed = restore(path, view=True, stream=True)
    assert viewed._streamed and viewed._table is None and len(viewed) == 700
    tiles(256)
    q = x[rng.choice(700, 9, replace=False)]
    assert_same(viewed.search(q, 5), loaded.search(q, 5, exact=True))
    even = lambda keys: keys % 2 == 0  # noqa: E731
    assert_same(viewed.search(q, 5, filter=even), loaded.search(q, 5, exact=True, filter=even))
    allow = np.arange(10, 710, 3, dtype=np.uint64)
    fb = viewed.search(q[0], 5, filter=allow)
    np.testing.assert_array_equal(fb.keys, loaded.search(q[0], 5, exact=True, filter=allow).keys)
    assert np.isin(fb.keys, allow).all()
    np.testing.assert_allclose(viewed.get(10), x[0], atol=1e-6)
    np.testing.assert_array_equal(viewed.get(np.array([11, 12])), x[1:3])
    assert viewed.contains(11) and not viewed.contains(9999)
    assert viewed.memory_usage == 700 * 8
    for change in (lambda: viewed.add(np.array([9999]), x[:1]), lambda: viewed.remove(10),
                   lambda: viewed.rename(10, 9999), viewed.compact, viewed.optimize):
        with pytest.raises(RuntimeError):
            change()
    np.testing.assert_allclose(viewed.pairwise_distance(10, 11), loaded.pairwise_distance(10, 11), rtol=RTOL)


@pytest.mark.parametrize("metric, dtype, ndim", [("cos", "i8", 32), ("hamming", "b1", 256), ("ip", "bf16", 24),
                                                  ("l2sq", "f16", 20)])
def test_streamed_kinds_match_resident_and_jax(rng, tmp_path, tiles, metric, dtype, ndim):
    """i8 cos and b1 hamming at 128-row tiles (the JAX package's cases),
    bf16 (its file's int16 bits) and f16: the port's streamed search equals
    the port's resident exact search and the JAX package's streamed search
    on the same file."""
    tiles(128)
    if dtype == "b1":
        x = (rng.random((300, ndim)) > 0.5).astype(np.float32)
        q = np.packbits(x[:3] > 0, axis=1)
    else:
        x = rng.standard_normal((400, ndim)).astype(np.float32)
        q = x[:4]
    path = saved(tmp_path, f"{dtype}.usearch", ndim, metric, dtype, x)
    viewed = restore(path, view=True, stream=True)
    got = viewed.search(q, 3)
    assert_same(got, restore(path).search(q, 3, exact=True))
    jviewed = usearch_tpu.Index.restore(path, view=True, stream=True)
    assert jviewed._streamed
    assert_same(got, jviewed.search(q, 3))
    np.testing.assert_array_equal(viewed.get(np.arange(5)), restore(path).get(np.arange(5)))


def test_jax_saved_file_streams_in_the_port(rng, tmp_path, tiles):
    """A file the JAX package wrote, with removals: viewed streamed by the
    port, it serves the JAX package's own results."""
    x = rng.standard_normal((600, 32)).astype(np.float32)
    jix = usearch_tpu.Index(ndim=32, metric="ip", dtype="i8")
    jix.add(np.arange(600, dtype=np.uint64) * 3, x)
    jix.remove(np.arange(0, 300, 7, dtype=np.uint64) * 3)
    path = str(tmp_path / "jax.usearch")
    jix.save(path)
    tiles(256)
    viewed = restore(path, view=True, stream=True)
    assert len(viewed) == len(jix)
    q = x[1:9]
    got = viewed.search(q, 6)
    want = jix.search(q, 6, exact=True)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.distances, want.distances)
    assert not np.isin(got.keys, np.arange(0, 300, 7) * 3).any()


def test_whole_tiles_take_the_exact_kernel_route(rng, tmp_path, tiles, monkeypatch):
    """Tiles the scan kernels' gate admits (here 16,384 rows: two of its
    8,192-row tiles) go through B2's wrapper once per tile and the exact
    rescore; the last, partial tile's padding never surfaces."""
    x = rng.standard_normal((36000, 32)).astype(np.float32)
    path = saved(tmp_path, "i8.usearch", 32, "l2sq", "i8", x)
    tiles(16384)
    calls = []
    real = scan.binned_minima

    def recorder(*args):
        calls.append(args[2].shape[0])
        return real(*args)

    monkeypatch.setattr(scan, "binned_minima", recorder)
    viewed = restore(path, view=True, stream=True)
    got = viewed.search(x[::3600], 4)
    assert calls == [16384] * 3
    want = restore(path).search(x[::3600], 4, exact=True)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.distances, want.distances)
    assert (got.keys < 36000).all()


def test_stream_share_streams_a_large_view(rng, tmp_path, monkeypatch):
    """``stream=None`` streams rows above `STREAM_SHARE` of the device's
    memory, and loads them whole below it; ``stream=False`` always loads."""
    x = rng.standard_normal((100, 8)).astype(np.float32)
    path = saved(tmp_path, "share.usearch", 8, "cos", "f32", x)
    rows_bytes = 100 * 8 * 4
    monkeypatch.setattr(persist, "_device_memory_budget", lambda index: int(rows_bytes / persist.STREAM_SHARE) - 1)
    assert restore(path, view=True)._streamed
    assert not restore(path, view=True, stream=False)._streamed
    monkeypatch.setattr(persist, "_device_memory_budget", lambda index: int(rows_bytes / persist.STREAM_SHARE) + 8)
    assert not restore(path, view=True)._streamed
    streamed = usearch_torch.Index(ndim=8, metric="cos", dtype="f32", path=path, view=True, device="cpu")
    assert not streamed._streamed and streamed._viewed


def test_streamed_view_saves_copies_and_clears(rng, tmp_path, tiles):
    """A streamed view saves its file's rows byte for byte, copies into a
    resident index that accepts changes, and lets go of its map on
    `clear`."""
    x = rng.standard_normal((300, 16)).astype(np.float32)
    path = saved(tmp_path, "v.usearch", 16, "ip", "f32", x)
    tiles(128)
    viewed = restore(path, view=True, stream=True)
    again = str(tmp_path / "again.usearch")
    viewed.save(again)
    assert open(again, "rb").read() == open(path, "rb").read()
    assert viewed.serialized_length == len(open(path, "rb").read())
    resident = viewed.copy()
    assert not resident._streamed and not resident._viewed
    q = x[:5]
    assert_same(resident.search(q, 3, exact=True), viewed.search(q, 3))
    resident.add(1000, x[0])
    assert 1000 in resident.search(x[0], 2, exact=True).keys
    viewed.clear()
    assert len(viewed) == 0 and viewed._stream_rows is None and len(viewed.search(q, 3).keys[0]) == 0


def test_streamed_view_saves_over_its_own_file(rng, tmp_path, tiles):
    """`save()` with no path writes a streamed view over the file it maps:
    the file comes out whole, and both the view and the file search as
    before."""
    x = rng.standard_normal((300, 16)).astype(np.float32)
    path = saved(tmp_path, "own.usearch", 16, "l2sq", "f32", x)
    before = open(path, "rb").read()
    tiles(128)
    viewed = restore(path, view=True, stream=True)
    q = x[:7]
    want = viewed.search(q, 5)
    viewed.save()
    assert open(path, "rb").read() == before
    assert [p.name for p in tmp_path.iterdir()] == ["own.usearch"]
    assert_same(viewed.search(q, 5), want)
    assert_same(restore(path, view=True, stream=True).search(q, 5), want)


def test_set_and_f64_files_refuse_to_stream(rng, tmp_path, tiles):
    """Ported in A.7b, as the JAX package treats them: an f64 file asked
    to stream serves resident (its rows f32 on the device, f64 on the
    host), and a set file (12 entries padded to 16 with -1) streams, both
    answering as the JAX package's resident index of the same file."""
    x = rng.standard_normal((300, 16))
    jix = usearch_tpu.Index(ndim=16, metric="l2sq", dtype="f64")
    jix.add(np.arange(300), x)
    path = str(tmp_path / "f64.usearch")
    jix.save(path)
    viewed = restore(path, view=True, stream=True)
    assert not viewed._streamed and viewed._viewed
    np.testing.assert_array_equal(viewed.get(np.arange(300), "f64"), x)
    q = x[:9].astype(np.float32)
    assert_same(viewed.search(q, 5), jix.search(q, 5))
    sets = np.full((300, 12), -1, np.int32)
    for i in range(300):
        row = np.unique(rng.choice(200, rng.integers(3, 13), replace=False))
        sets[i, : len(row)] = row
    jsets = usearch_tpu.Index(ndim=12, metric="jaccard")
    jsets.add(np.arange(300), sets)
    path = str(tmp_path / "sets.usearch")
    jsets.save(path)
    tiles(128)
    streamed = restore(path, view=True, stream=True)
    assert streamed._streamed and streamed.dtype == usearch_torch.ScalarKind.I8
    got, want = streamed.search(sets[:9], 5), jsets.search(sets[:9], 5, exact=True)
    np.testing.assert_array_equal(got.distances, want.distances)
    assert_same(got, want)
    np.testing.assert_array_equal(streamed.get(np.arange(5)), sets[:5])


class Recorder(stream.TileStager):
    """The stager's steps in the order a streamed search calls them, each
    with the thread that called it."""

    log = []

    def fill(self, i):
        self.log.append(("fill", i, threading.get_ident()))
        super().fill(i)

    def upload(self, i):
        self.log.append(("upload", i, threading.get_ident()))
        super().upload(i)

    def take(self, i):
        self.log.append(("take", i, threading.get_ident()))
        return super().take(i)

    def release(self, i):
        self.log.append(("release", i, threading.get_ident()))
        super().release(i)


def test_double_buffer_order(rng, tmp_path, tiles, monkeypatch):
    """Each tile is filled, uploaded, taken and released in that order; a
    slot's host buffer is refilled only after its last upload, and its
    device tile overwritten only after the search that read it was
    released; tile i + 1's upload follows tile i's release at once, and
    every fill after the first runs on the worker thread (beside the
    search of the tile before it)."""
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    path = saved(tmp_path, "order.usearch", 16, "l2sq", "f32", x)
    tiles(128)
    monkeypatch.setattr(stream, "TileStager", Recorder)
    Recorder.log = []
    viewed = restore(path, view=True, stream=True)
    got = viewed.search(x[:4], 3)
    np.testing.assert_array_equal(got.keys[:, 0], np.arange(4))
    n_tiles = 8
    log = Recorder.log
    at = {(step, i): pos for pos, (step, i, _) in enumerate(log)}
    assert len(at) == len(log) == 4 * n_tiles
    main = threading.get_ident()
    main_steps = [(step, i) for step, i, who in log if who == main]
    want = [("fill", 0), ("upload", 0)]
    for i in range(n_tiles):
        want += [("take", i), ("release", i)] + ([("upload", i + 1)] if i + 1 < n_tiles else [])
    assert main_steps == want
    assert all(who != main for step, i, who in log if step == "fill" and i > 0)
    for i in range(n_tiles):
        assert at["fill", i] < at["upload", i] < at["take", i] < at["release", i]
    for i in range(2, n_tiles):
        assert at["upload", i - 2] < at["fill", i]
        assert at["release", i - 2] < at["upload", i]
