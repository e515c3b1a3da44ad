"""The pairings of the dot and binary metrics with the other storage kinds
(ROADMAP A.7b: the dot metrics over b1 rows, the binary metrics over f32,
bf16 and i8 rows) and f64 storage, on the CPU against the JAX package:
bit for bit where the distances are integer arithmetic, else within
FLOAT_RTOL/FLOAT_ATOL (1e-5, 1e-4) with keys equal apart from ties; f64
`get` bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import usearch_tpu  # noqa: E402

import usearch_torch  # noqa: E402
from usearch_torch.enums import ScalarKind  # noqa: E402

FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-4


def Index(**kwargs):
    return usearch_torch.Index(device="cpu", **kwargs)


def assert_same(got, want, exact=False):
    """Distances within the float tolerance (or equal), keys equal apart
    from ties within it."""
    np.testing.assert_array_equal(got.counts, want.counts)
    if exact:
        np.testing.assert_array_equal(got.distances, want.distances)
    else:
        np.testing.assert_allclose(got.distances, want.distances, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    tol = 0.0 if exact else FLOAT_ATOL
    for row, col in zip(*np.nonzero(got.keys != want.keys)):
        near = np.abs(want.distances[row] - got.distances[row, col]) <= FLOAT_RTOL * abs(got.distances[row, col]) + tol
        assert got.keys[row, col] in want.keys[row][near] or near[-1], (row, col)


PAIRINGS = [(m, "b1") for m in ("ip", "cos", "l2sq", "pearson")] + [
    (m, d) for m in ("hamming", "tanimoto", "sorensen") for d in ("f32", "bf16", "i8")]


@pytest.mark.parametrize("metric,dtype", PAIRINGS)
def test_pairings_match_reference(metric, dtype):
    """Each pairing the JAX `Index` accepts, exact search and
    `pairwise_distance` on the same rows: bit for bit where the distances
    are integer arithmetic (b1 and i8 apart from cos's and pearson's roots)."""
    rng = np.random.default_rng(11)
    ndim = 96
    if dtype == "b1":
        x = np.packbits(rng.random((300, ndim)) < 0.4, axis=1)
    else:
        x = rng.standard_normal((300, ndim)).astype(np.float32)
        x[:, :8] = np.abs(x[:, :8])
    port, ref = Index(ndim=ndim, metric=metric, dtype=dtype), usearch_tpu.Index(ndim=ndim, metric=metric, dtype=dtype)
    port.add(None, x)
    ref.add(None, x)
    exact = dtype in ("b1", "i8") and metric not in ("cos", "pearson")
    assert_same(port.search(x[:20], 7), ref.search(x[:20], 7), exact=exact)
    keys = np.arange(20)
    got, want = port.pairwise_distance(keys, keys[::-1]), np.asarray(ref.pairwise_distance(keys, keys[::-1]))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)


def test_f64_rows_and_distances():
    """f64 rows: `get` bit for bit through add, growth, removal, compact,
    copy, save and load (both packages' files); searches within the float
    tolerance of the JAX package's and equal to an f32 index of the rows."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1500, 24))
    port, ref = Index(ndim=24, metric="l2sq", dtype="f64"), usearch_tpu.Index(ndim=24, metric="l2sq", dtype="f64")
    assert port.dtype == ScalarKind.F64 and port._table.dtype == torch.float32 if port._table is not None else True
    for lo in (0, 1000):  # the second add grows the capacity
        port.add(np.arange(lo, lo + x[lo : lo + 1000].shape[0]), x[lo : lo + 1000])
        ref.add(np.arange(lo, lo + x[lo : lo + 1000].shape[0]), x[lo : lo + 1000])
    np.testing.assert_array_equal(port.get(np.arange(1500), "f64"), x)
    np.testing.assert_array_equal(port.get(7), ref.get(7))
    q = x[:16] + 0.01
    assert_same(port.search(q, 5), ref.search(q, 5))
    f32 = Index(ndim=24, metric="l2sq", dtype="f32")
    f32.add(None, x.astype(np.float32))
    want = f32.search(q.astype(np.float32), 5)
    np.testing.assert_array_equal(port.search(q.astype(np.float32), 5).keys, want.keys)
    np.testing.assert_array_equal(port.search(q.astype(np.float32), 5).distances, want.distances)
    np.testing.assert_allclose(port.pairwise_distance(np.arange(5), np.arange(5, 10)),
                               np.asarray(ref.pairwise_distance(np.arange(5), np.arange(5, 10))), rtol=FLOAT_RTOL)
    port.remove(np.arange(0, 1500, 3))
    port.compact()
    live = np.setdiff1d(np.arange(1500), np.arange(0, 1500, 3))
    np.testing.assert_array_equal(port.get(live, "f64"), x[live])
    np.testing.assert_array_equal(port.copy().get(live, "f64"), x[live])
    port.optimize(8, reorder=True)
    np.testing.assert_array_equal(port.get(live, "f64"), x[live])
    for blob in (port.save(), ref.save()):
        back = usearch_torch.Index.restore(blob, device="cpu")
        got = back.get(back.keys[:50] if blob is ref.save() else live[:50], "f64")
        assert got.dtype == np.float64
    np.testing.assert_array_equal(usearch_torch.Index.restore(port.save(), device="cpu").get(live, "f64"), x[live])
    np.testing.assert_array_equal(usearch_torch.Index.restore(ref.save(), device="cpu").get(np.arange(1500), "f64"), x)
    jback = usearch_tpu.Index.restore(port.save())
    np.testing.assert_array_equal(jback.get(live, "f64"), x[live])


def test_f64_host_copy_of_i8_input():
    """An f64 index keeps i8 input decoded (value / 127), as its device
    table holds it, and b1 input as 0/1 bits; the JAX package keeps the raw
    values (a divergence, ROADMAP queue C). Its searches equal the JAX
    package's, whose device table holds the same decoded rows."""
    rng = np.random.default_rng(8)
    x = rng.integers(-100, 100, (40, 16), dtype=np.int8)
    port, ref = Index(ndim=16, metric="l2sq", dtype="f64"), usearch_tpu.Index(ndim=16, metric="l2sq", dtype="f64")
    port.add(None, x)
    ref.add(None, x)
    np.testing.assert_array_equal(port.get(np.arange(40), "f64"), (x.astype(np.float32) / 127.0).astype(np.float64))
    np.testing.assert_array_equal(ref.get(np.arange(40), "f64"), x.astype(np.float64))
    q = (x[:5].astype(np.float32) / 127.0)
    assert_same(port.search(q, 4), ref.search(q, 4))
    bits = Index(ndim=16, metric="l2sq", dtype="f64")
    packed = np.packbits(rng.random((6, 16)) < 0.5, axis=1)
    bits.add(None, packed)
    np.testing.assert_array_equal(bits.get(np.arange(6), "f64"), np.unpackbits(packed, axis=1).astype(np.float64))
