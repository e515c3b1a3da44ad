"""The binary IVF slice at Index level on the CPU: b1 indexes with hamming,
tanimoto and sorensen, built by the JAX package and carried across
(`convert.index_from_arrays` + `install_ivf`), answer as the JAX Index does;
the port's own `optimize` keeps the recall, deletion and fresh-add
behaviours of tests/test_probe.py.

The JAX index runs its Pallas kernels in interpret mode through
``set_kernel_backend("pallas")``: B3 over packed rows for hamming, B5 (the
hamming select) plus the popcount re-rank for tanimoto and sorensen. Held:
distances equal (tanimoto/sorensen within 1 ulp: one f32 division each
side), keys equal except where the distance at that place ties.

Recall is tie-aware (the sorted distance rows matched as multisets, the
rule of scripts/tpu_binary_ivf_bench.py): hamming distances are small
integers, and the probe breaks their ties by table position where the exact
scan breaks them by key. Its id recall at 4 candidates per bin is below 0.9
in both packages on this corpus; tests/test_probe.py's 0.9 on ids holds for
the JAX package's XLA probe, which keeps every row of a window."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import usearch_tpu  # noqa: E402
from usearch_tpu import exact as jexact  # noqa: E402
from usearch_tpu import ivf as jivf  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch import ivf  # noqa: E402
from usearch_torch.convert import index_from_arrays, install_ivf  # noqa: E402
from usearch_torch.ops import probe  # noqa: E402

BINARY = ["hamming", "tanimoto", "sorensen"]
ULP1 = 1.2e-7


@pytest.fixture
def pallas_backend():
    jexact.set_kernel_backend("pallas")
    try:
        yield
    finally:
        jexact.set_kernel_backend("auto")


def make_index(**kwargs):
    return usearch_torch.Index(device="cpu", **kwargs)


def bit_corpus(rng, n, nbits, templates=16, flip=0.1):
    """Packed rows of a clustered bit corpus: template rows with a share of
    their bits flipped (the binary blobs of scripts/tpu_binary_ivf_bench.py)."""
    base = rng.integers(0, 2, (templates, nbits), dtype=np.uint8)
    bits = base[rng.integers(0, templates, n)] ^ (rng.random((n, nbits)) < flip)
    return np.packbits(bits, axis=1)


def carried(ref):
    state = dict(table=np.asarray(ref._table), stats=np.asarray(ref._stats), valid=np.asarray(ref._valid),
                 slot_keys=np.asarray(ref._slot_keys), count=ref._count, next_slot=ref._next_slot,
                 free_slots=list(ref._free_slots), ndim=ref.ndim, metric=ref.metric.value,
                 dtype=ref.dtype.value, multi=ref.multi)
    port = index_from_arrays(state, device="cpu")
    v = ref._ivf
    install_ivf(port, dict(
        centroids=np.asarray(v.centroids), avg_rows=v.avg_rows_per_part, built_count=v.built_count,
        spilled=v.spilled, fresh=v.fresh_np, starts=np.asarray(v.starts), lens=np.asarray(v.lens), p_win=v.p_win,
        shadow_pos=v.shadow_np_pos, shadow_src=v.shadow_np_src, part_slots=None))
    port.expansion_search = ref.expansion_search
    return port


def assert_same(got, want, metric):
    np.testing.assert_array_equal(got.counts, want.counts)
    wd = np.asarray(want.distances)
    if metric == "hamming":
        np.testing.assert_array_equal(got.distances, wd)
    else:
        np.testing.assert_allclose(got.distances, wd, rtol=0, atol=ULP1)
    for row, col in zip(*np.nonzero(got.keys != np.asarray(want.keys))):
        d = wd[row]
        assert np.sum(np.abs(d - d[col]) <= ULP1) > 1 or abs(d[col] - d[-1]) <= ULP1, (row, col)


def tie_recall(got_d, want_d) -> float:
    """Share of the exact distances matched by the probe's, as multisets per
    row."""
    hits = 0
    for a, b in zip(np.sort(got_d, axis=1), np.sort(want_d, axis=1)):
        left = {}
        for x in a.tolist():
            left[x] = left.get(x, 0) + 1
        for x in b.tolist():
            if left.get(x, 0):
                left[x] -= 1
                hits += 1
    return hits / got_d.size


def id_recall(got_keys, want_keys) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / len(a) for a, b in zip(got_keys, want_keys)]))


@pytest.mark.parametrize("spill", [0.0, 0.1])
@pytest.mark.parametrize("metric", BINARY)
def test_carried_binary_ivf_matches_reference(pallas_backend, monkeypatch, metric, spill):
    """Built by the JAX Index (deletions before the build, deletions and
    fresh adds after it), carried across, searched by both: hamming through
    B3 on both sides, tanimoto and sorensen through B5 and the re-rank."""
    rng = np.random.default_rng(11)
    x = bit_corpus(rng, 1200, 256, templates=10)
    n = len(x)
    ref = usearch_tpu.Index(ndim=256, metric=metric, dtype="b1", expansion_search=24)
    keys = np.arange(n, dtype=np.uint64) + 100
    ref.add(keys, x)
    ref.remove(keys[rng.choice(n, 30, replace=False)])
    ref.optimize(n_partitions=12, reorder=True, spill=spill)
    ref.remove(keys[rng.choice(n, 30, replace=False)])
    extra = x[:20] ^ np.uint8(1)
    ref.add(np.arange(20, dtype=np.uint64) + 5000, extra)
    assert not ref._ivf_dirty and ref._ivf.fresh_np.size == 20
    assert (ref._ivf.shadow_np_pos.size > 0) == (spill > 0)
    port = carried(ref)
    q = np.concatenate([x[rng.choice(n, 30, replace=False)], extra[:6]])
    ref_calls, b5_calls, b3_calls = [], [], []
    orig = jivf._ivf_probe_search_dense_binary
    monkeypatch.setattr(jivf, "_ivf_probe_search_dense_binary", lambda *a, **kw: (ref_calls.append(1), orig(*a, **kw))[1])
    monkeypatch.setattr(ivf, "grouped_probe_nofold", lambda *a: (b5_calls.append(a[-1]), probe.grouped_probe_nofold(*a))[1])
    monkeypatch.setattr(ivf, "grouped_probe", lambda *a: (b3_calls.append(1), probe.grouped_probe(*a))[1])
    for k in (1, 10):
        assert_same(port.search(q, k), ref.search(q, k), metric)
    binary = metric != "hamming"
    assert bool(ref_calls) == binary and bool(b5_calls) == binary and bool(b3_calls) != binary
    assert set(b5_calls) <= {ivf.BINARY_BIN_M}


@pytest.mark.parametrize("reorder", [True, False])
@pytest.mark.parametrize("metric", BINARY)
def test_binary_ivf_recall(metric, reorder):
    """The port's own build, at the corpus of tests/test_probe.py's binary
    recall test: the coarse fit in unpacked bit space, candidates scored by
    and-counts over popcounts. Recall@10 >= 0.9 against exact search,
    tie-aware (and on ids too for tanimoto and sorensen), first distances
    equal to the exact ones."""
    rng = np.random.default_rng(13)
    packed = bit_corpus(rng, 4096, 256)
    ix = make_index(ndim=256, metric=metric, dtype="b1")
    ix.add(np.arange(len(packed)), packed)
    q = packed[:64]
    gt = ix.search(q, 10, exact=True)
    ix.optimize(n_partitions=32, reorder=reorder)
    ix.expansion_search = 256
    m = ix.search(q, 10)
    assert tie_recall(m.distances, gt.distances) >= 0.9
    if metric != "hamming":
        assert id_recall(m.keys, gt.keys) >= 0.9
    np.testing.assert_allclose(m.distances[:, 0], gt.distances[:, 0], atol=1e-6)
    np.testing.assert_array_equal(m.keys[:, 0], np.arange(64))


@pytest.mark.parametrize("metric", BINARY)
def test_binary_ivf_deletions_and_fresh_adds(metric):
    """After the pattern of tests/test_probe.py's binary deletion test, with
    spill shadows: removed keys never come back, and rows added after the
    build join the fresh list and are found."""
    rng = np.random.default_rng(14)
    packed = np.packbits(rng.integers(0, 2, (2048, 128), dtype=np.uint8), axis=1)
    ix = make_index(ndim=128, metric=metric, dtype="b1", expansion_search=64)
    ix.add(np.arange(2048), packed)
    ix.optimize(n_partitions=16, reorder=True, spill=0.1)
    q = packed[:8]
    np.testing.assert_array_equal(ix.search(q, 1).keys[:, 0], np.arange(8))
    ix.remove(np.arange(8))
    assert not ix._ivf_dirty
    assert not np.isin(np.arange(8), ix.search(q, 5).keys).any()
    new = np.packbits(rng.integers(0, 2, (32, 128), dtype=np.uint8), axis=1)
    ix.add(np.arange(5000, 5032), new)
    assert not ix._ivf_dirty and ix._ivf.fresh_np.size == 32
    m = ix.search(new, 3)
    np.testing.assert_array_equal(m.keys[:, 0], np.arange(5000, 5032))
    for row in m.keys:
        assert len(set(row.tolist())) == 3  # shadows never surface twice


@pytest.mark.parametrize("metric", BINARY)
def test_full_binary_probe_equals_exact(metric):
    """Probing every partition reproduces the exact scan's distances
    through the plain block-gather probe (packed rows, batched and-counts)
    at k = 129, past the grouped probes; at k = 10 through the kernels'
    plain versions for hamming (narrow windows: k candidates per bin).
    tanimoto and sorensen at k = 10 select by hamming first, so there only
    the nearest row and a recall of 0.9 are held."""
    rng = np.random.default_rng(15)
    packed = bit_corpus(rng, 1500, 512, templates=6, flip=0.2)
    ix = make_index(ndim=512, metric=metric, dtype="b1", expansion_search=4096)
    ix.add(np.arange(len(packed)), packed)
    ix.optimize(n_partitions=6, reorder=True)
    assert ix._ivf.nprobe_for(ix.expansion_search) == ix._ivf._shape()[0]
    q = packed[rng.choice(len(packed), 20, replace=False)]
    for k in (10, 129):
        before = probe.grouped_probe.launches, probe.grouped_probe_nofold.launches
        got, exact = ix.search(q, k), ix.search(q, k, exact=True)
        if metric == "hamming" or k == 129:
            np.testing.assert_allclose(got.distances, exact.distances, rtol=0, atol=ULP1)
        else:
            np.testing.assert_array_equal(got.keys[:, 0], exact.keys[:, 0])
            assert tie_recall(got.distances, exact.distances) >= 0.9
        assert (probe.grouped_probe.launches, probe.grouped_probe_nofold.launches) == before
