"""b1 (packed binary) storage and the binary metrics of usearch_torch on the
CPU, against usearch_tpu on the same numpy inputs: bit packing, casts, row
stats, and-counts, the hamming/tanimoto/sorensen epilogues, `exact_search`
and the flat `Index`.

Tolerances: packing, popcounts, and-counts and hamming distances are
integers held in f32 and equal bit for bit; tanimoto and sorensen within
1 ulp (one f32 division each side, which XLA may take as a multiplication
by the reciprocal). Keys are equal wherever the distance at that place is
not shared with another row of the table."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import usearch_tpu  # noqa: E402
from usearch_tpu.enums import MetricKind as JMetric  # noqa: E402
from usearch_tpu.enums import ScalarKind as JKind  # noqa: E402
from usearch_tpu.ops import casts as jcasts  # noqa: E402
from usearch_tpu.ops import distances as jdist  # noqa: E402
from usearch_tpu.ops import packbits as jbits  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch.enums import MetricKind, ScalarKind  # noqa: E402
from usearch_torch.ops import casts, distances, packbits, scan  # noqa: E402

BINARY = ["hamming", "tanimoto", "sorensen"]
ULP1 = 1.2e-7  # one f32 ulp just below 1


def make_index(**kwargs):
    return usearch_torch.Index(device="cpu", **kwargs)


def bit_rows(rng, n, nbits, density=0.5):
    return (rng.random((n, nbits)) < density).astype(np.uint8)


@pytest.mark.parametrize("nbits", [1, 7, 8, 200, 1024])
def test_pack_unpack_round_trip(nbits):
    rng = np.random.default_rng(nbits)
    bits = bit_rows(rng, 33, nbits)
    want = np.packbits(bits, axis=1, bitorder="big")
    signed = bits.astype(np.float32) * rng.uniform(0.1, 2.0, bits.shape).astype(np.float32)
    signed[bits == 0] *= -1.0  # only > 0 is a set bit
    np.testing.assert_array_equal(packbits.pack_bits_np(signed), want)
    np.testing.assert_array_equal(packbits.pack_bits(torch.from_numpy(signed)).numpy(), want)
    np.testing.assert_array_equal(packbits.unpack_bits_np(want, nbits), bits)
    got = packbits.unpack_bits(torch.from_numpy(want)).numpy()
    assert got.dtype == np.int8 and got.shape == (33, want.shape[1] * 8)
    np.testing.assert_array_equal(got[:, :nbits], bits)
    assert not got[:, nbits:].any()


def test_device_bit_ops_match_reference():
    """unpack_bits, popcount_bytes and bit_dot (the and-count) equal the
    JAX package's exactly, at the widths the index stores (128-byte
    multiples) and at an odd one."""
    rng = np.random.default_rng(1)
    for width in (128, 256, 13):
        q = rng.integers(0, 256, (9, width), dtype=np.uint8)
        t = rng.integers(0, 256, (300, width), dtype=np.uint8)
        t[:3] = 0
        t[3] = 255
        tq, tt = torch.from_numpy(q), torch.from_numpy(t)
        np.testing.assert_array_equal(packbits.unpack_bits(tt).numpy(), np.asarray(jbits.unpack_bits(jnp.asarray(t))))
        pop = packbits.popcount_bytes(tt)
        assert pop.dtype == torch.int32
        np.testing.assert_array_equal(pop.numpy(), np.asarray(jbits.popcount_bytes(jnp.asarray(t))))
        got = packbits.bit_dot(tq, tt)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jbits.bit_dot(jnp.asarray(q), jnp.asarray(t))))
        # batched, as the plain probe calls it
        rows = tt[torch.from_numpy(rng.integers(0, 300, (9, 40)))]
        batched = packbits.bit_dot(tq[:, None, :], rows)[:, 0]
        np.testing.assert_array_equal(batched.numpy(), np.einsum("qxw,qw->qx", packbits.unpack_bits(rows).numpy().astype(np.int32), packbits.unpack_bits(tq).numpy().astype(np.int32)))


@pytest.mark.parametrize("src,dst", [("f32", "b1"), ("i8", "b1"), ("b1", "f32"), ("b1", "i8"), ("b1", "b1")])
def test_b1_casts_match_reference(src, dst):
    """Casts into and out of b1 equal the reference's host casts: floats and
    i8 pack by ``> 0``; packed bits unpack to 0/1 and cast on from f32."""
    rng = np.random.default_rng(2)
    ndim = 100
    if src == "b1":
        values = np.packbits(bit_rows(rng, 20, ndim), axis=1)
    elif src == "i8":
        values = rng.integers(-127, 128, (20, ndim)).astype(np.int8)
    else:
        values = rng.standard_normal((20, ndim)).astype(np.float32)
    values[0] = 0
    want = jcasts.cast_vectors(values, JKind(src), JKind(dst), ndim)
    got = casts.cast_vectors(values, ScalarKind(src), ScalarKind(dst), ndim).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_b1_row_stats_match_reference():
    rng = np.random.default_rng(3)
    t = rng.integers(0, 256, (64, 128), dtype=np.uint8)
    t[0] = 0
    want = np.asarray(jdist.row_stats(jnp.asarray(t), JKind.B1))
    got = distances.row_stats(torch.from_numpy(t), ScalarKind.B1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", BINARY)
def test_binary_epilogues_match_reference(metric):
    """`tile_dists` over packed rows (one wide product of the unpacked
    bits) and `dot_metric_dists` from and-counts: hamming bit for bit,
    tanimoto and sorensen within 1 ulp, empty rows (union 0) at 0."""
    rng = np.random.default_rng(4)
    q = np.packbits(bit_rows(rng, 12, 1024, 0.3), axis=1)
    t = np.packbits(bit_rows(rng, 200, 1024, 0.3), axis=1)
    q[0] = 0
    t[:2] = 0  # q[0] against t[0]: both empty
    t[2] = q[1]
    jq, jt = jnp.asarray(q), jnp.asarray(t)
    want = np.asarray(jdist.tile_dists(JMetric(metric), JKind.B1, jq, jdist.row_stats(jq, JKind.B1), jt,
                                       jdist.row_stats(jt, JKind.B1), 1024))
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    qs, ts = distances.row_stats(tq, ScalarKind.B1), distances.row_stats(tt, ScalarKind.B1)
    got = distances.tile_dists(MetricKind(metric), ScalarKind.B1, tq, qs, tt, ts, 1024).numpy()
    if metric == "hamming":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ULP1)
    assert got[0, 0] == 0.0 and got[1, 2] == 0.0
    dots = packbits.bit_dot(tq, tt)
    np.testing.assert_array_equal(distances.dot_metric_dists(MetricKind(metric), dots, qs, ts, 1024).numpy(), got)


def test_tile_dists_refuses_mismatched_pairs():
    """The pairings the port refused before A.7b score as the JAX
    package's: cos over b1 rows (its and-counts and popcounts) and hamming
    over f32 rows (their squared norms as the popcounts)."""
    rng = np.random.default_rng(21)
    q = np.packbits(rng.random((3, 1024)) < 0.3, axis=1)
    tq = torch.from_numpy(q)
    stats = distances.row_stats(tq, ScalarKind.B1)
    jq = jnp.asarray(q)
    want = np.asarray(jdist.tile_dists(JMetric.Cos, JKind.B1, jq, jdist.row_stats(jq, JKind.B1), jq,
                                       jdist.row_stats(jq, JKind.B1), 1024))
    got = distances.tile_dists(MetricKind.Cos, ScalarKind.B1, tq, stats, tq, stats, 1024).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    f = rng.standard_normal((2, 128)).astype(np.float32)
    tf, jf = torch.from_numpy(f), jnp.asarray(f)
    fs, jfs = distances.row_stats(tf, ScalarKind.F32), jdist.row_stats(jf, JKind.F32)
    got = distances.tile_dists(MetricKind.Hamming, ScalarKind.F32, tf, fs, tf, fs, 128).numpy()
    want = np.asarray(jdist.tile_dists(JMetric.Hamming, JKind.F32, jf, jfs, jf, jfs, 128))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_scan_kernels_refuse_binary():
    """The scan kernels (B1/B2) never take hamming or b1: their code tables
    are their own, apart from the probe kernels'."""
    for kind in ScalarKind:
        for metric in MetricKind:
            if metric in (MetricKind.Hamming, MetricKind.Tanimoto, MetricKind.Sorensen) or kind == ScalarKind.B1:
                assert not scan.supports(metric, kind), (metric, kind)
    from usearch_torch.ops import probe

    assert MetricKind.Hamming in probe.METRIC_CODES and MetricKind.Hamming not in scan._METRIC_CODES
    assert torch.uint8 in probe.DTYPE_CODES and torch.uint8 not in scan._DTYPE_CODES


def assert_same_matches(got, want, exact_ulp=False):
    """Distances equal (within 1 ulp for tanimoto/sorensen); keys equal
    except where the distance at that place ties with another of the row
    or with the last one (then the tie may resolve to another row)."""
    np.testing.assert_array_equal(got.counts, want.counts)
    if exact_ulp:
        np.testing.assert_allclose(got.distances, want.distances, rtol=0, atol=ULP1)
    else:
        np.testing.assert_array_equal(got.distances, want.distances)
    for row, col in zip(*np.nonzero(got.keys != want.keys)):
        d = want.distances[row]
        tied = np.sum(np.abs(d - d[col]) <= ULP1) > 1 or abs(d[col] - d[-1]) <= ULP1
        assert tied, (row, col)


@pytest.mark.parametrize("metric", BINARY)
def test_exact_search_b1_matches_reference(metric):
    """Modelled on tests/test_exact.py's binary case: packed datasets, the
    width 8 x the byte count, and self-matches first."""
    rng = np.random.default_rng(5)
    packed = np.packbits(bit_rows(rng, 700, 512), axis=1)
    want = usearch_tpu.exact_search(packed, packed[:20], 7, metric=metric)
    got = usearch_torch.exact_search(packed, packed[:20], 7, metric=metric, device="cpu")
    np.testing.assert_array_equal(got.keys[:, 0], np.arange(20))
    assert np.all(got.distances[:, 0] == 0)
    assert_same_matches(got, want, metric != "hamming")


@pytest.mark.parametrize("metric", BINARY)
@pytest.mark.parametrize("nbits", [256, 1000])
def test_flat_index_b1_matches_reference(metric, nbits):
    """Modelled on tests/test_index.py's binary cases: the default dtype of
    a binary metric is b1, self-queries find themselves at distance 0, and
    the ranking equals the JAX Index's, with deletions."""
    rng = np.random.default_rng(6 + nbits)
    bits = bit_rows(rng, 600, nbits)
    packed = np.packbits(bits, axis=1)
    ref = usearch_tpu.Index(ndim=nbits, metric=metric)
    port = make_index(ndim=nbits, metric=metric)
    assert port.dtype == ScalarKind.B1 and ref.dtype == JKind.B1
    keys = np.arange(600, dtype=np.uint64) + 7
    for ix in (ref, port):
        ix.add(keys, packed)
        ix.remove(keys[10:20])
    q = np.concatenate([packed[:10], packed[25:35]])
    for k in (1, 10):
        got, want = port.search(q, k), ref.search(q, k)
        assert_same_matches(got, want, metric != "hamming")
    m = port.search(q, 5)
    np.testing.assert_array_equal(m.keys[:, 0], np.concatenate([keys[:10], keys[25:35]]))
    np.testing.assert_allclose(m.distances[:, 0], 0.0, atol=1e-6)
    assert not np.isin(keys[10:20], port.search(packed[10:20], 10).keys).any()
    assert_same_matches(port.search(q, 10, exact=True), ref.search(q, 10, exact=True), metric != "hamming")


def test_b1_inputs_get_and_memory():
    """Packed bytes, 0/1 floats and uint8 tensors store the same rows;
    `get` gives the packed bytes for dtype b1 and 0/1 values otherwise, as
    the JAX Index does; memory is counted in bytes."""
    rng = np.random.default_rng(7)
    nbits = 300
    bits = bit_rows(rng, 50, nbits)
    packed = np.packbits(bits, axis=1)
    ref = usearch_tpu.Index(ndim=nbits, metric="tanimoto", dtype="b1")
    ref.add(np.arange(50), packed)
    a, b, c = (make_index(ndim=nbits, metric="tanimoto", dtype="b1") for _ in range(3))
    a.add(np.arange(50), packed)
    b.add(np.arange(50), bits.astype(np.float32) - 0.5)  # > 0 is a set bit
    c.add(np.arange(50), torch.from_numpy(packed))
    assert a._table.shape[1] == 128 and a._table.dtype == torch.uint8
    for other in (b, c):
        assert torch.equal(other._table, a._table) and torch.equal(other._stats, a._stats)
    np.testing.assert_array_equal(a.get(np.arange(50), "b1"), packed)
    np.testing.assert_array_equal(a.get(3, "b1"), np.asarray(ref.get(3, "b1")))
    for dtype in (None, "f32", "f16", "i8"):
        got, want = a.get(np.arange(10), dtype), np.asarray(ref.get(np.arange(10), dtype))
        assert got.dtype == want.dtype and got.shape == (10, nbits)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(a.get(5), bits[5].astype(np.float32))
    assert a.memory_usage == ref.memory_usage
    with pytest.raises(ValueError):
        a.add(np.arange(50, 52), packed[:2, :10])  # neither packed width nor ndim
    with pytest.raises(ValueError):
        make_index(ndim=8, dtype="f32").get(0, "b1")


def test_binary_pairings_not_ported_name_their_item():
    """Ported in A.7b: each pairing builds, adds and finds its own rows as
    the JAX index does, and `exact_search` takes hamming over floats
    (tests/test_torch_pairings.py holds every pairing's distances)."""
    rng = np.random.default_rng(22)
    for kwargs in (dict(metric="cos", dtype="b1"), dict(metric="hamming", dtype="f32"),
                   dict(metric="tanimoto", dtype="i8")):
        x = (np.packbits(rng.random((40, 64)) < 0.5, axis=1) if kwargs["dtype"] == "b1"
             else rng.standard_normal((40, 64)).astype(np.float32))
        port, ref = make_index(ndim=64, **kwargs), usearch_tpu.Index(ndim=64, **kwargs)
        port.add(None, x)
        ref.add(None, x)
        np.testing.assert_array_equal(port.search(x[:5], 1).keys, ref.search(x[:5], 1).keys)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    got = usearch_torch.exact_search(x, x[:1], 2, metric="hamming", device="cpu")
    want = usearch_tpu.exact_search(x, x[:1], 2, metric="hamming")
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5, atol=1e-4)
