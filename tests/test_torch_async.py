"""`Index.search_async` and `PendingSearch`: searches in flight give what
`search` gives, hold the read lock until ``result()`` (on any thread), and
give it back when a dispatch or a result fails. Every wait is bounded."""

import gc
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import usearch_tpu  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch.index import PendingSearch  # noqa: E402

WAIT = 10.0


def Index(**kwargs):
    return usearch_torch.Index(device="cpu", **kwargs)


def finishes(fn) -> bool:
    """Run ``fn`` on another thread: True when it returned within WAIT
    seconds (a writer blocked by a leaked read lock does not)."""
    done = threading.Event()

    def run():
        fn()
        done.set()

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(WAIT)
    return done.is_set()


@pytest.fixture
def flat(rng):
    vecs = rng.standard_normal((4096, 32)).astype(np.float32)
    ix = Index(ndim=32, metric="l2sq", dtype="f32")
    ix.add(np.arange(4096, dtype=np.uint64), vecs)
    return ix, vecs


def test_search_async_pipeline(flat):
    """The JAX package's case: handles in flight at once give the
    synchronous results; consumed, they release the lock; the single-query
    form; ``result()`` idempotent; the empty index's fast path."""
    ix, vecs = flat
    qs = [vecs[i * 8 : i * 8 + 4] for i in range(6)]
    sync = [ix.search(q, 5) for q in qs]
    pend = [ix.search_async(q, 5) for q in qs]
    assert all(isinstance(p, PendingSearch) for p in pend)
    for s, p in zip(sync, pend):
        got = p.result()
        np.testing.assert_array_equal(s.keys, got.keys)
        np.testing.assert_array_equal(s.distances, got.distances)
    assert finishes(lambda: ix.add(np.asarray([5000], dtype=np.uint64), vecs[:1]))
    p = ix.search_async(vecs[7], 3)
    m1 = p.result()
    assert int(m1.keys[0]) == 7 and p.result() is m1
    e = Index(ndim=32, metric="l2sq", dtype="f32")
    pe = e.search_async(vecs[:2], 3)
    assert len(np.asarray(pe.result().counts)) == 2
    assert finishes(lambda: e.add(np.arange(4, dtype=np.uint64), vecs[:4]))


def test_search_async_matches_jax(flat):
    """The same i8 rows and queries through both packages' `search_async`:
    exact integer dots, so the distances agree bit for bit, and the keys
    apart from ties."""
    _, vecs = flat
    ix = Index(ndim=32, metric="ip", dtype="i8")
    jix = usearch_tpu.Index(ndim=32, metric="ip", dtype="i8")
    for index in (ix, jix):
        index.add(np.arange(4096, dtype=np.uint64), vecs)
    q = vecs[100:140]
    got = ix.search_async(q, 4, exact=True).result()
    want = jix.search_async(q, 4, exact=True).result()
    np.testing.assert_array_equal(got.distances, want.distances)
    differ = got.keys != want.keys
    assert all(want.distances[r, c] in np.delete(want.distances[r], c) for r, c in zip(*np.nonzero(differ)))


def test_result_on_another_thread(flat):
    """The read lock taken at dispatch goes back when another thread reads
    the result; a writer waits until then."""
    ix, vecs = flat
    p = ix.search_async(vecs[:16], 3, filter=lambda keys: keys % 2 == 1)
    added = threading.Event()
    writer = threading.Thread(target=lambda: (ix.add(np.asarray([9000], dtype=np.uint64), vecs[:1]), added.set()),
                              daemon=True)
    writer.start()
    assert not added.wait(0.2)  # held by the pending search
    out = {}
    reader = threading.Thread(target=lambda: out.setdefault("m", p.result()), daemon=True)
    reader.start()
    reader.join(WAIT)
    assert "m" in out and np.all(out["m"].keys % 2 == 1)
    assert added.wait(WAIT)
    writer.join(WAIT)
    assert not writer.is_alive()


def test_failing_dispatch_releases_its_lock(flat):
    """A dispatch that raises (queries of the wrong width) takes no read
    slot with it."""
    ix, vecs = flat
    with pytest.raises(ValueError):
        ix.search_async(np.zeros((2, 7), np.float32), 3)
    assert ix._rwlock._readers == 0
    assert finishes(lambda: ix.remove(0))


def test_failing_result_releases_its_lock_and_stays_failed(flat, monkeypatch):
    """A result that raises gives the lock back in `finally`, and raises
    the same error again; an abandoned handle gives it back when it goes."""
    ix, vecs = flat
    p = ix.search_async(vecs[:4], 3)

    def broken(*args, **kwargs):
        raise RuntimeError("finish failed")

    monkeypatch.setattr(ix, "_finish_search", broken)
    with pytest.raises(RuntimeError, match="finish failed") as first:
        p.result()
    with pytest.raises(RuntimeError) as again:
        p.result()
    assert again.value is first.value
    assert ix._rwlock._readers == 0
    monkeypatch.undo()
    abandoned = ix.search_async(vecs[:4], 3)
    assert ix._rwlock._readers == 1
    del abandoned
    gc.collect()
    assert ix._rwlock._readers == 0 and finishes(lambda: ix.remove(1))


def test_writer_may_dispatch_while_writing(flat):
    """A thread holding the write lock may search asynchronously (its read
    re-enters); the handle then gives back no read slot."""
    ix, vecs = flat
    ix._rwlock.acquire_write()
    try:
        m = ix.search_async(vecs[3], 1).result()
    finally:
        ix._rwlock.release_write()
    assert int(m.keys[0]) == 3 and ix._rwlock._readers == 0
