"""`Indexes`: one search over several shards, held against the JAX
package's `Indexes` over the same shards (carried across as files, one of
them a streamed view), and its `search_async` fan-out against the
shard-by-shard loop."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import usearch_tpu  # noqa: E402
from usearch_tpu import indexes as jindexes  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import Indexes  # noqa: E402
from usearch_torch import stream  # noqa: E402


@pytest.fixture
def shard_files(rng, tmp_path):
    """Three i8 ip shards written by the JAX package (rows ~ keys 0-899),
    and their rows."""
    x = rng.standard_normal((900, 32)).astype(np.float32)
    paths = []
    for s in range(3):
        jix = usearch_tpu.Index(ndim=32, metric="ip", dtype="i8")
        jix.add(np.arange(300 * s, 300 * (s + 1), dtype=np.uint64), x[300 * s : 300 * (s + 1)])
        paths.append(str(tmp_path / f"shard{s}.usearch"))
        jix.save(paths[-1])
    return paths, x


def port_shards(paths):
    """The port's shards: two loaded, the last a streamed view."""
    loaded = [usearch_torch.Index.restore(p, device="cpu") for p in paths[:-1]]
    viewed = usearch_torch.Index.restore(paths[-1], view=True, stream=True, device="cpu")
    assert viewed._streamed
    return loaded + [viewed]


def test_indexes_match_jax(shard_files, monkeypatch):
    """Keys and distances as the JAX `Indexes` over the same files (i8 ip:
    exact integer dots, so bit for bit apart from ties)."""
    paths, x = shard_files
    monkeypatch.setattr(stream, "DEFAULT_TILE_ROWS", 128)
    ours = Indexes(port_shards(paths))
    theirs = jindexes.Indexes([usearch_tpu.Index.restore(p) for p in paths[:-1]]
                              + [usearch_tpu.Index.restore(paths[-1], view=True, stream=True)])
    assert len(ours) == len(theirs) == 900
    q = x[::60]
    got, want = ours.search(q, 5, exact=True), theirs.search(q, 5, exact=True)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.distances, want.distances)
    differ = got.keys != want.keys
    assert all(want.distances[r, c] in np.delete(want.distances[r], c) for r, c in zip(*np.nonzero(differ)))
    np.testing.assert_array_equal(got.keys[:, 0], np.arange(0, 900, 60))
    one = ours.search(x[5], 3, exact=True)
    assert isinstance(one, usearch_torch.Matches) and one.keys[0] == 5


def test_fan_out_equals_the_loop(shard_files):
    """`threads=1` (shard by shard) and the `search_async` fan-out give the
    same results; an empty shard is skipped."""
    paths, x = shard_files
    shards = port_shards(paths) + [usearch_torch.Index(ndim=32, metric="ip", dtype="i8", device="cpu")]
    multi = Indexes(shards)
    q = x[::45]
    fan, loop = multi.search(q, 7), multi.search(q, 7, threads=1)
    np.testing.assert_array_equal(fan.keys, loop.keys)
    np.testing.assert_array_equal(fan.distances, loop.distances)
    np.testing.assert_array_equal(fan.counts, loop.counts)
    for shard in shards:
        assert shard._rwlock._readers == 0


def test_paths_and_views(shard_files):
    """``paths=`` restores each file (``view=True`` maps it), `merge` adds
    a shard, and more results are asked for than one shard holds: invalid
    places stay last."""
    paths, x = shard_files
    viewed = Indexes(paths=paths, view=True, device="cpu")
    assert len(viewed) == 900 and all(s._viewed for s in viewed._shards)
    small = usearch_torch.Index(ndim=32, metric="ip", dtype="i8", device="cpu")
    small.add([5000], x[0])
    only = Indexes([small])
    m = only.search(x[:2], 4)
    assert m.counts.tolist() == [1, 1] and m.keys[0, 0] == 5000 and np.all(np.isinf(m.distances[:, 1:]))
    only.merge(viewed._shards[0])
    m = only.search(x[:2], 4)
    assert m.counts.tolist() == [4, 4] and set(m.keys[0, :2].tolist()) == {0, 5000}
